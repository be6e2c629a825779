"""Device ms per buffer between the CUDA events of the port's
`octproz.depth` span, recorded on the stage's stream at its start and end:
the depth stage's kernels (on the fused fold path the one fold kernel).
Nothing on the CPU."""

from portbench import recorded


def read(run):
    return recorded.ms_per_buffer(run, "device", "octproz.depth")
