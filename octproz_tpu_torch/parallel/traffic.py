"""Cross-device and cross-process traffic of the sharded step.

Counterpart of ``octproz_tpu/parallel/traffic.py``.  The scaling claim rests
on the steady state moving no bytes between devices: every per-A-scan stage
is local along the B-scan and A-scan axes, and the only cross-shard work is
the fixed-pattern-noise statistics reduction during determination
(cuda_code.cu:523-565) and, on an A-scan-split mesh, the whole-row gather
of the flip and the sinusoidal correction (the acos curve is a global remap
of the A-scan axis, not a small halo).

JAX proves this from the compiled HLO (``collectives_in_hlo``,
``sharded_step_hlo``).  PyTorch compiles no HLO, so those two have no
counterpart here: the sharded step keeps a tally of every transfer it makes
(``parallel.sharding.Tally``), and :func:`measure_collective_traffic` runs
one determination step and returns that tally in the same form.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import curves as curves_mod
from .. import pipeline as _pipeline
from ..params import FPN_SEGMENTS, AcqParams, ProcConfig
from . import sharding as _sharding


def measure_collective_traffic(acq: AcqParams, cfg: ProcConfig, mesh) -> Dict:
    """Run the sharded step on ``mesh`` once, on the FPN-determination
    buffer (zero input), and tally its transfers.

    Returns {"collectives": [{"op", "via", "count", "bytes"}, ...], "by_op": {...},
    "total_bytes": N}: the per-participant payload of the reduction (as
    JAX's HLO tally counts a psum) and the bytes moved between mesh
    positions for A-scan-split rows.  The steady state under FPN once
    moves only the row traffic."""
    dev = mesh.local_devices[0]
    cv = curves_mod.make_curves(
        acq, cfg,
        resample_coeffs=(0.0, float(acq.samples_per_line - 1), 20.0, -10.0),
        dispersion_coeffs=(0.0, 0.0, 10.0, 0.0), device=dev)
    step = _sharding.make_sharded_step(acq, cfg, mesh)
    raw = torch.zeros(acq.buffer_shape, dtype=acq.raw_dtype)
    step(raw, cv, _pipeline.initial_fpn_state(acq, device=dev))
    return step.tally.summary()


# ---------------------------------------------------------------------------
# Analytic model
# ---------------------------------------------------------------------------

def expected_fpn_psum_bytes(acq: AcqParams) -> int:
    """The determination-phase reduction payload: per segment and depth
    bin, three float32 partial sums (re, im, |z|^2) -- 9 x depth x 3 x 4 B
    (cuda_code.cu:523-565 reduced across shards)."""
    return FPN_SEGMENTS * acq.output_ascan_length * 3 * 4


def expected_fast_axis_bytes(acq: AcqParams, cfg: ProcConfig,
                             n_ascan_shards: int) -> Optional[int]:
    """A-scan-split meshes pay real traffic for the geometric post stages:
    the sinusoidal acos curve is a GLOBAL remap of the A-scan axis (max
    |n(k) - k| ~ 0.1-0.2 A for typical lengths, not a small halo), and the
    bidirectional flip reverses the split axis outright.  Zero without
    them or without an A-scan split; None ("measure, don't model")
    otherwise, as in the JAX package."""
    if n_ascan_shards <= 1 or not (cfg.sinusoidal_correction or cfg.bscan_flip):
        return 0
    return None


def efficiency_model(acq: AcqParams, cfg: ProcConfig, *,
                     compute_s_per_buffer: float,
                     link_gbps: float,
                     det_bytes: int,
                     steady_bytes: int = 0,
                     fpn_once: bool = True,
                     buffers: int = 64) -> Dict:
    """Predicted scaling efficiency T_1 / (n * T_n) with communication
    serialised against compute (worst case: zero overlap).

    ``det_bytes`` is the determination-buffer payload (the FPN reduction,
    :func:`measure_collective_traffic`), paid once per stream under
    FpnMode.ONCE or per buffer under CONTINUOUS; ``steady_bytes`` the
    per-buffer steady-state payload; ``link_gbps`` the slowest link the
    transfer rides, in GB/s."""
    comm_det = det_bytes / (link_gbps * 1e9)
    comm_steady = steady_bytes / (link_gbps * 1e9)
    t_steady = compute_s_per_buffer + comm_steady
    t_total = buffers * t_steady + (comm_det if fpn_once else buffers * comm_det)
    eff = (buffers * compute_s_per_buffer) / t_total
    return {"compute_s_per_buffer": compute_s_per_buffer,
            "comm_det_s": round(comm_det, 9),
            "comm_steady_s": round(comm_steady, 9),
            "predicted_efficiency": round(eff, 6)}
