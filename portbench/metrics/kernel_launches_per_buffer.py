"""Launches of the port's hand-written kernels per buffer: the sum of
its `launches.<family>` counters over the window's `octproz.step` spans.
The CPU runs the plain versions and launches none."""

from portbench import recorded


def read(run):
    got = recorded.per_buffer(run)
    if got is None:
        return None
    summary, steps = got
    return sum(n for name, n in summary["counts"].items()
               if name.startswith("launches.")) / steps
