"""The port's one rule for its outputs, on every configuration on the CPU.

``chip_smoke.config_near_exact`` holds an output against the image of the
float64 products (``chip_smoke.run_config_f64``: the port's own operands and
elementwise stages, every product, the FFT and the FPN mean line in
float64): every shown voxel within ``CONFIG_ATOL`` (1e-4 display units, one
bf16 step more on a bf16 store), but for at most a ``CONFIG_DEEP_SHARE``
share of them, each of which within that plus Higham's float32 bound of its
depth sum.  The card's configurations phase holds its outputs by the same
function at 4096 lines a buffer and at full depth; here every configuration
of ``SLICE_CONFIGS`` and ``chip_smoke.CARD_ONLY_CONFIGS`` runs on 256 lines
(tests/test_torch_card_configs.py's buffers).  On these buffers only the
outputs of ``PAST_ATOL`` have a voxel past 1e-4; every other output meets
1e-4 at every shown voxel, and is held to that.
"""

import pytest
import torch

import test_torch_card_configs as cc
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

chip_smoke = cc.chip_smoke

#: (configuration, output) whose 256-line run has shown voxels past
#: ``CONFIG_ATOL`` from the float64 products, held by the rule's share
#: (ROADMAP Queue 3, F2): the chunk of ``fold-10bit``, one voxel at 1.347e-4,
#: 0.001 of its float32 bound.
PAST_ATOL = {("fold-10bit", 3)}
#: The float32 bound at the median shown voxel, in display units: under a
#: typical voxel moved 5e-3, which the planted-fault test must catch.  Background
#: removal folded into the prep operator sums larger terms.
MEDIAN_BOUND = {"fft-prep-background": 2.2e-3}


@pytest.mark.parametrize("name", list(cc.CONFIGS))
def test_float64_reference_agrees_with_the_port(name):
    """Every output of the configuration's run (buffer 0, two steady
    buffers, a chunk of two) meets the rule against ``run_config_f64`` --
    with no voxel past 1e-4 outside ``PAST_ATOL`` -- and the float32 bound
    is positive at every shown voxel and small at the median one."""
    model, raws, (got, _) = cc._run(name)
    steps = chip_smoke.config_steps(model, raws)
    for k, (g, (image, bound)) in enumerate(zip(got, chip_smoke.run_config_f64(model, raws,
                                                                                steps))):
        err, ok, _ = chip_smoke.config_close(g, image)
        held = chip_smoke.config_near_exact(g, (image, bound))
        if (name, k) in PAST_ATOL:
            assert held[1], held
        else:
            assert ok, err
            assert held[1:] == (True, 0, 0.0)
        shown = torch.isfinite(image) & (image >= 0)
        assert bool((bound[shown] > 0).all())
        assert float(bound[shown].median()) < MEDIAN_BOUND.get(name, 2e-3)


def test_phase_holds_the_f2_outputs_by_the_rule():
    """``_hold_f2`` (phase 14's hold of ``F2_CONFIGS``' outputs) passes a
    configuration's own outputs against their float64 images and fails one
    voxel of typical depth moved 5e-3, past its float32 bound."""
    info = {"device_name": "cpu", "power_limit": "n/a"}
    name = "fold-xla"
    assert name in chip_smoke.F2_CONFIGS
    model, raws, (got, _) = cc._run(name)
    exact = chip_smoke.run_config_f64(model, raws, chip_smoke.config_steps(model, raws))
    chip_smoke._hold_f2(info, name, got, exact)
    moved, _ = cc._moved(got, 1, 5e-3, "median")
    with pytest.raises(AssertionError, match="output 1 misses the rule"):
        chip_smoke._hold_f2(info, name, moved, exact)
