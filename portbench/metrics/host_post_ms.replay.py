"""Host ms per buffer inside the port's `octproz.post` span: the post
stages of `pipeline.postprocess_volume` (B-scan flip, sinusoidal
correction), dispatched ahead."""

from portbench import recorded


def read(run):
    return recorded.ms_per_buffer(run, "host", "octproz.post")
