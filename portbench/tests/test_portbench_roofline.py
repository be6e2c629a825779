"""The least work of a buffer, counted from shapes in the benchmark."""

from __future__ import annotations

import math

import pytest

from portbench import cells, roofline

FIGSHARE = {"samples_per_line": 1024, "ascans_per_bscan": 512, "bscans_per_buffer": 256,
            "buffers_per_volume": 1, "bit_depth": 12}


def test_bytes_and_flops_at_1024x512x256():
    assert roofline.buffer_bytes(FIGSHARE) == 536_870_912  # 268 MB of uint16 in, float32 out
    assert roofline.buffer_flops(FIGSHARE) == 5 * 1024 * 10 * 131072
    least, by = roofline.least_seconds(FIGSHARE, "NVIDIA H100 80GB HBM3")
    assert by == "bytes"
    assert least == pytest.approx(536_870_912 / 3.35e12)
    assert least * 1e3 == pytest.approx(0.16026, abs=1e-5)
    assert roofline.buffer_flops(FIGSHARE) / 989e12 < least


def test_unknown_card_reads_nothing():
    assert roofline.least_seconds(FIGSHARE, "cpu") is None


def test_configs_are_counted_from_their_own_files():
    for name in ("figshare.replay", "handheld.replay"):
        acq = cells.load_cell(name).config["acq"]
        assert roofline.buffer_bytes(acq) == 536_870_912
        assert math.isclose(roofline.buffer_flops(acq), 6_710_886_400.0)


def test_roofline_reader():
    read = cells.metric_reader("step_roofline")
    cell = cells.load_cell("figshare.replay")
    least = roofline.least_seconds(cell.config["acq"], "NVIDIA H100 80GB HBM3")[0]
    run = type("Run", (), dict(cell=cell, device_kind="NVIDIA H100 80GB HBM3",
                               window={"buffers": 10},
                               trace=type("T", (), {"kernel_ns": int(10 * least * 1e9 * 4)})))
    assert read(run) == pytest.approx(25.0, rel=1e-6)
    run.trace = None
    assert read(run) is None
