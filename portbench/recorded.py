"""What the port recorded inside its step in a traced window, for the
readers of ``program_span`` and ``program_counter`` metrics.

The port's recorder (``FdOctModel.recorder``) records while the window's
profile does.  A reader reaches it through the model of the run's set-up,
which ``run.steady_ms`` (a bound method of the set-up) carries, and reads
it per buffer: over the window's ``octproz.step`` spans.  Nothing where the
model has no recorder (a port without one) or the record holds no step.
"""

STEP = "octproz.step"


def per_buffer(run):
    """(the recorder's summary, the number of ``octproz.step`` spans), or
    None."""
    setup = getattr(run.steady_ms, "__self__", None)
    recorder = getattr(getattr(setup, "model", None), "recorder", None)
    if recorder is None:
        return None
    summary = recorder.summary()
    steps = summary["host"].get(STEP, {}).get("calls", 0)
    return (summary, steps) if steps else None


def ms_per_buffer(run, table: str, span: str):
    """ms per buffer of ``span`` in the summary's ``table`` (``host``,
    ``self`` or ``device``), or None where it has none."""
    got = per_buffer(run)
    if got is None or span not in got[0][table]:
        return None
    summary, steps = got
    return 1e3 * summary[table][span]["total_s"] / steps
