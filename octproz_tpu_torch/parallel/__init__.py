"""Multi-device and multi-process parallelism: meshes of torch devices, the
sharded per-buffer step, and the host axis on ``torch.distributed``."""

from .sharding import (  # noqa: F401
    AXIS_ASCAN,
    AXIS_BSCAN,
    AXIS_HOST,
    Mesh,
    ShardedBuffer,
    buffer_pspec,
    make_mesh,
    make_sharded_step,
    sharded_process_buffer,
    wire_bscan_pspec,
)
from .multihost import (  # noqa: F401
    feed_from_local,
    feed_wire_from_local,
    fetch,
    initialize,
    local_block,
    local_bscan_range,
    make_multihost_mesh,
    make_simulated_multihost_mesh,
)
