"""Device time of the host-to-device copies per buffer in the traced
window (``put_buffer`` from the pinned ring), in ms."""


def read(run):
    if run.trace is None or not run.trace.h2d_count:
        return None
    return run.trace.h2d_ns / 1e6 / run.window["buffers"]
