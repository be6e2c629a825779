"""The least time one card could take for a buffer (``roofline``: raw
samples read once, output voxels written once, over the memory bandwidth;
5 N log2 N per line over the tensor cores' peak; the larger bounds it) over
the device time of every kernel a buffer launched in the traced window, in
%.  Nothing where the trace holds no kernel or the card is not in the
table of peaks."""

from portbench import roofline


def read(run):
    least = roofline.least_seconds(run.cell.config["acq"], run.device_kind)
    if run.trace is None or not run.trace.kernel_ns or least is None:
        return None
    per_buffer_s = run.trace.kernel_ns / 1e9 / run.window["buffers"]
    return 100.0 * least[0] / per_buffer_s
