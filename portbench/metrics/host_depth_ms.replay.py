"""Host ms per buffer inside the port's `octproz.depth` span: stages 1-6
of `pipeline.process_buffer` (on the fused fold path the host's prep and
the launch of the fold kernel), dispatched ahead."""

from portbench import recorded


def read(run):
    return recorded.ms_per_buffer(run, "host", "octproz.depth")
