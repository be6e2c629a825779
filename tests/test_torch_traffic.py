"""The port's transfer tally against JAX's collective traffic, on the CPU.

Mirrors tests/test_traffic.py.  JAX counts the collectives of the compiled
HLO; the port's sharded step tallies the transfers it makes.  On a B-scan
mesh both are exactly the FPN statistics reduction, 9 segments x depth x 3
float32 partial sums (cuda_code.cu:523-565), and nothing with FPN off; the
geometric post stages are local there.  On an A-scan-split mesh the port
gathers each row whole for the flip and the sinusoidal correction, and
scatters it back: exactly the rows' other blocks, each way.
"""

import dataclasses

import pytest
import torch

from octproz_tpu import params as jparams
from octproz_tpu.parallel import make_mesh as jmake_mesh
from octproz_tpu.parallel import traffic as jtraffic
from octproz_tpu_torch.params import AcqParams, FpnMode, Interpolation, ProcConfig
from octproz_tpu_torch.parallel import make_mesh, make_simulated_multihost_mesh, traffic
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CPUS = [torch.device("cpu")] * 8
ACQ = AcqParams(samples_per_line=256, ascans_per_bscan=64, bscans_per_buffer=8,
                buffers_per_volume=1, bit_depth=12)
FULL = ProcConfig(bitshift=True, resampling=True, interpolation=Interpolation.CUBIC,
                  windowing=True, dispersion=True, fpn_mode=FpnMode.ONCE, bscans_for_noise=2,
                  log_scaling=True, fft_via_matmul=True, sinusoidal_correction=True,
                  bscan_flip=True)


def _jax(obj):
    if isinstance(obj, AcqParams):
        return jparams.AcqParams(**dataclasses.asdict(obj))
    enums = {"fpn_mode": jparams.FpnMode, "interpolation": jparams.Interpolation}
    return jparams.ProcConfig(**{
        f.name: (enums[f.name](getattr(obj, f.name).value) if f.name in enums
                 else getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def _measure(cfg, *mesh_dims):
    return traffic.measure_collective_traffic(ACQ, cfg, make_mesh(*mesh_dims, devices=CPUS))


@pytest.mark.parametrize("fpn_mode", [FpnMode.ONCE, FpnMode.CONTINUOUS])
def test_bscan_mesh_tally_equals_jax_total(fpn_mode):
    """The port's B-scan-mesh tally == JAX's measured total == the FPN
    reduction alone (13 824 bytes here)."""
    cfg = dataclasses.replace(FULL, fpn_mode=fpn_mode)
    got = _measure(cfg, 8, 1)
    want = jtraffic.measure_collective_traffic(_jax(ACQ), _jax(cfg), jmake_mesh(8, 1))
    assert got["total_bytes"] == want["total_bytes"] == traffic.expected_fpn_psum_bytes(ACQ)
    assert traffic.expected_fpn_psum_bytes(ACQ) == 9 * 128 * 3 * 4 == 13824
    assert got["by_op"] == {"all_reduce": 13824}
    assert [c["via"] for c in got["collectives"]] == ["local"]


def test_bscan_mesh_fpn_off_is_transfer_free():
    cfg = dataclasses.replace(FULL, fpn_mode=FpnMode.OFF)
    got = _measure(cfg, 8, 1)
    want = jtraffic.measure_collective_traffic(_jax(ACQ), _jax(cfg), jmake_mesh(8, 1))
    assert got["total_bytes"] == want["total_bytes"] == 0
    assert got["collectives"] == []


@pytest.mark.parametrize("knob", ["sinusoidal_correction", "bscan_flip",
                                  "post_background_removal"])
def test_geometric_post_stages_are_local_on_bscan_mesh(knob):
    base = dataclasses.replace(FULL, fpn_mode=FpnMode.OFF, sinusoidal_correction=False,
                               bscan_flip=False)
    assert _measure(dataclasses.replace(base, **{knob: True}), 8, 1)["total_bytes"] == 0


@pytest.mark.parametrize("knob", ["sinusoidal_correction", "bscan_flip"])
def test_fast_axis_mesh_row_traffic(knob):
    """On (4, 2) each of the 4 rows moves its second block to the row's
    first device and back: 4 x (2 x 32 x 128 x 4) bytes each way, beside
    the one reduction; the analytic model says "measure"."""
    cfg = dataclasses.replace(FULL, **{"sinusoidal_correction": False, "bscan_flip": False,
                                       knob: True})
    assert traffic.expected_fast_axis_bytes(ACQ, cfg, 2) is None
    assert traffic.expected_fast_axis_bytes(ACQ, cfg, 1) == 0
    r = _measure(cfg, 4, 2)
    block = (ACQ.bscans_per_buffer // 4) * (ACQ.ascans_per_bscan // 2) \
        * ACQ.output_ascan_length * 4
    assert r["by_op"] == {"all_reduce": traffic.expected_fpn_psum_bytes(ACQ),
                          "row_gather": 4 * block, "row_scatter": 4 * block}


@pytest.mark.parametrize("mesh", [(4, 2), (1, 8)])
def test_reduction_spans_every_mesh_axis(mesh):
    """On a 2-D mesh the FPN statistics reduce over both axes: one
    reduction with the same payload as JAX's."""
    cfg = dataclasses.replace(FULL, sinusoidal_correction=False, bscan_flip=False)
    got = _measure(cfg, *mesh)
    want = jtraffic.measure_collective_traffic(_jax(ACQ), _jax(cfg), jmake_mesh(*mesh))
    assert got["by_op"] == {"all_reduce": want["by_op"]["all-reduce"]}


def test_simulated_host_axis_reduction():
    cfg = dataclasses.replace(FULL, sinusoidal_correction=False, bscan_flip=False)
    mesh = make_simulated_multihost_mesh(2, 4, 1, devices=CPUS)
    got = traffic.measure_collective_traffic(ACQ, cfg, mesh)
    assert got["by_op"] == {"all_reduce": traffic.expected_fpn_psum_bytes(ACQ)}


def test_tally_stays_bounded_over_a_stream():
    """A stream under FPN continuous on an A-scan split adds a reduction
    and a gather and a scatter per row per buffer: the tally keeps a count
    and a byte total per (op, via), so it does not grow with the stream."""
    from octproz_tpu_torch import curves as curves_mod
    from octproz_tpu_torch import pipeline as tpipeline
    from octproz_tpu_torch.parallel import make_sharded_step

    cfg = dataclasses.replace(FULL, fpn_mode=FpnMode.CONTINUOUS, sinusoidal_correction=False)
    step = make_sharded_step(ACQ, cfg, make_mesh(4, 2, devices=CPUS))
    cv = curves_mod.make_curves(ACQ, cfg, resample_coeffs=(0.0, 255.0, 20.0, -10.0),
                                dispersion_coeffs=(0.0, 0.0, 10.0, 0.0), device=CPUS[0])
    state = tpipeline.initial_fpn_state(ACQ, device=CPUS[0])
    raw = torch.zeros(ACQ.buffer_shape, dtype=ACQ.raw_dtype)
    block = (ACQ.bscans_per_buffer // 4) * (ACQ.ascans_per_bscan // 2) \
        * ACQ.output_ascan_length * 4
    for n in (1, 2, 3):
        _, state = step(raw, cv, state)
        got = step.tally.summary()
        assert got["collectives"] == [
            {"op": "all_reduce", "via": "local", "count": n,
             "bytes": n * traffic.expected_fpn_psum_bytes(ACQ)},
            {"op": "row_gather", "via": "local", "count": 4 * n, "bytes": 4 * n * block},
            {"op": "row_scatter", "via": "local", "count": 4 * n, "bytes": 4 * n * block}]
    assert got["total_bytes"] == 3 * (traffic.expected_fpn_psum_bytes(ACQ) + 8 * block)


def test_headline_geometry_psum_payload():
    acq = AcqParams(samples_per_line=1024, ascans_per_bscan=512, bscans_per_buffer=256,
                    buffers_per_volume=1, bit_depth=12)
    assert traffic.expected_fpn_psum_bytes(acq) == 9 * 512 * 3 * 4 == 55296
    assert jtraffic.expected_fpn_psum_bytes(_jax(acq)) == 55296


def test_efficiency_model_matches_jax():
    kw = dict(compute_s_per_buffer=1.7e-3, link_gbps=25.0, det_bytes=55296,
              steady_bytes=0, buffers=64)
    for once in (True, False):
        assert traffic.efficiency_model(ACQ, FULL, fpn_once=once, **kw) == \
            jtraffic.efficiency_model(_jax(ACQ), _jax(FULL), fpn_once=once, **kw)
