"""Device ms per buffer between the CUDA events of the port's
`octproz.post` span: the post stages' kernels.  Nothing on the CPU or where
no post stage runs."""

from portbench import recorded


def read(run):
    return recorded.ms_per_buffer(run, "device", "octproz.post")
