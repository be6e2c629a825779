"""Replay: a recorded session of ``volumes`` distinct buffers resident on
the card, processed back to back through ``FdOctModel.process_buffer``
with at most ``ahead`` buffers dispatched and not yet finished
(``loadgen.replay``).  Reports ``ascan_rate``.

Traffic file: ``volumes``, ``ahead``, ``warmup``, ``warmup_s``,
``compare``.
"""

from portbench import loadgen, system


def setup(cell, seed, device, changes=None, wrap=None, log=None):
    s = system.fdoct(cell, seed, device, pinned=False, changes=changes, wrap=wrap, log=log)
    system.warm(drive, cell, s, seed)
    return s


def drive(cell, s, seconds, sample, spans):
    return loadgen.replay(s.model, s.ring, seconds, cell.traffic["ahead"], sample, s.device,
                          spans)
