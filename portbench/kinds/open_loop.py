"""An open-loop scanner: buffer k of a pinned host ring of ``volumes``
distinct buffers comes due at k / ``rate_per_s`` after the window opens
and is handed to ``FdOctModel.process_buffer`` then, whatever is still in
flight (``loadgen.open_loop``).  Set-up ends with ``warmup_s`` of the same
schedule.  Reports ``latency_p95_ms``.

Traffic file: ``volumes``, ``rate_per_s``, ``warmup``, ``warmup_s``,
``compare``.  ``drive``'s ``rate`` overrides the file's (the sweep).
"""

from portbench import loadgen, system


def setup(cell, seed, device, changes=None, wrap=None, log=None):
    s = system.fdoct(cell, seed, device, pinned=True, changes=changes, wrap=wrap, log=log)
    system.warm(drive, cell, s, seed)
    return s


def drive(cell, s, seconds, sample, spans, rate=None):
    return loadgen.open_loop(s.model, s.ring, rate or cell.traffic["rate_per_s"], seconds,
                             sample, s.device, spans)
