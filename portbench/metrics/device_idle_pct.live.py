"""The device's idle share of the traced window, in %: 100 minus the union
of its kernel, copy and memset intervals (``devtrace.Summary``)."""


def read(run):
    return None if run.trace is None else 100.0 * run.trace.idle_share
