"""Host ms per buffer of `FdOctModel.process_buffer`'s own work: its
`octproz.step` span less what its children (`octproz.depth`,
`octproz.post`) cover -- the upload call, the step's dispatch and the
recording itself."""

from portbench import recorded


def read(run):
    return recorded.ms_per_buffer(run, "self", "octproz.step")
