"""The prep kernels at ``compute_dtype="bfloat16"`` on the persistent
one-term kernel (``csrc/prep_bf16.cu`` on ``csrc/fold_bf16.cuh``: B7
``_kernel_phase`` and B8 ``_kernel_real`` with x and the operator rounded
to bf16).

On the CPU: the mirror of the kernel's host arithmetic
(``fused_prep.prep_bf16_schedule`` / ``prep_bf16_tile``: tiles of 128
lines x 256 operator columns with one wgmma chain up to 1024 samples, beyond
it the bulk of the sums moved out of the chain every F = 256 samples into
bf16 hi parts in shared memory; grid, stages, shared memory with the
phasor rows, the walk of the tiles) on odd shapes; a torch emulation of the
kernel's sum order against the JAX package's bf16 ``fused_prep`` in
interpret mode at 2048- and 4096-sample lines; the
bench's ``prep_phase_bf16`` and ``prep_real_bf16`` rows through
``bench._kernel_cases`` with the launches replaced by stand-ins that take
the wrapper's route and run the plain version, beside ``bench.kernel_bound``
for those rows.  The agreement of these families' plain versions with the
JAX package's Pallas kernels is held in
``tests/test_torch_bf16.py::test_bf16_prep_matches_pallas``.

On a CUDA GPU only (marked ``cuda``; this file imports JAX only inside its
CPU comparison): the kernels
against their plain versions over lines {1, 127, 129, 999, 131073} x n_out
{64, 100, 256, 1000, 1024, 1100} (n_in = n_out: the prep operator is
square; 100 and 1100 give row pitches that are not a multiple of 8, the
element-wise producer) and n_out = 1001 (odd: the column-by-column
stores), with and without the phasor, on uint8, 12-bit shifted and
unshifted, and 24-bit float32 lines, background removal folded into every
other operator; 2048, 4096 and 4352 samples on 12-bit and 24-bit float32
lines with the ``make_curves`` operators and a dense random one; phasor
rows that stay in device memory;
every launch counted on ``tensor_core_bf16``; the controls that must fail
(x truncated instead of rounded, and the three-part route in place of
bf16, on unshifted 12-bit samples); a launch with other than one part
refused.  Bound: ``fused_prep.PREP_REL_L2`` (relative L2 <= 1e-6
over re and im, or y).
"""

import numpy as np
import pytest
import torch

from octproz_tpu_torch import bench
from octproz_tpu_torch import curves as tcurves
from octproz_tpu_torch.kernels import fused_prep as tfp
from octproz_tpu_torch.params import AcqParams

LINES = (1, 127, 129, 999, 131073)
N_OUTS = (64, 100, 256, 1000, 1024, 1100)
H100_SMS = 132
SMEM_MAX = 232_448


# ---------------------------------------------------------------------------
# The host arithmetic of prep_bf16.cu on fold_bf16.cuh (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_out", N_OUTS)
@pytest.mark.parametrize("lines", LINES)
def test_schedule_walks_every_tile_once(lines, n_out):
    """Blocks b = 0 .. grid-1 walking tiles b, b + grid, ... cover every
    (line, column) of the spectra exactly once, each tile inside them at
    its first line and column, the grid at most one block per SM."""
    s = tfp.prep_bf16_schedule(lines, n_out, 2, H100_SMS)
    assert s["grid"] == min(s["tiles"], H100_SMS)
    assert s["col_tiles"] == -(-n_out // 256)
    assert s["tiles"] == -(-lines // 128) * s["col_tiles"]
    seen = np.zeros((-(-lines // 128) * 128, s["col_tiles"] * 256), np.int32)
    for block in range(s["grid"]):
        for t in range(block, s["tiles"], s["grid"]):
            m0, n0 = tfp.prep_bf16_tile(t, s["col_tiles"])
            assert m0 < lines and n0 < n_out
            seen[m0:m0 + 128, n0:n0 + 256] += 1
    assert (seen == 1).all()


def test_schedule_reads_the_raw_buffer_four_times():
    """At the main path's shape (131072 lines, 1024 columns) a row tile has
    four column tiles of 256, so each raw line is decoded 4 times (8 on the
    shared pipeline's 128-column blocks); the 132 tiles of one wave span 33
    row tiles.  So it is with one chain (the main path's n_in = 1024) and
    on the "carry" tiles of longer lines."""
    for n_in, tile in ((1024, "chain"), (4096, "carry")):
        s = tfp.prep_bf16_schedule(131072, 1024, 2, H100_SMS, n_in=n_in)
        assert (s["tiles"], s["col_tiles"], s["grid"], s["tile"]) == (4096, 4, 132, tile)
        rows = {tfp.prep_bf16_tile(t, 4)[0] for t in range(s["grid"])}
        assert len(rows) == 33 and max(rows) == 32 * 128


@pytest.mark.parametrize("itemsize,stages", [(1, 4), (2, 3), (4, 2)])
@pytest.mark.parametrize("n_in", [64, 256, 1024, 1088, 2048, 4352])
def test_schedule_tile_switches_at_the_longest_chain(n_in, itemsize, stages):
    """Up to 1024 samples one wgmma chain over n_in; beyond, the bulk of
    every sum moved out of the chain every F = 256 samples into bf16 hi
    parts in shared memory (64 KB) beside four, three and two stages of
    uint8, uint16 and float32 lines -- the phasor rows of 1024 columns
    beside them where they fit (not beside the four stages of uint8
    lines)."""
    s = tfp.prep_bf16_schedule(999, 1024, itemsize, H100_SMS, n_in=n_in)
    tile = "chain" if n_in <= 1024 else "carry"
    assert tfp.BF16_CHAIN_MAX == 1024 and tfp.BF16_FOLD == 256
    assert s["tile"] == tile and s["fold"] == (None if tile == "chain" else 256)
    stage = 4 * 8192 + 128 * 64 * itemsize
    ring = 1024 + s["stages"] * (stage + 16) + (65_536 if tile == "carry" else 0)
    if tile == "carry":
        assert s["stages"] == stages
    assert s["phasor_in_smem"] == (ring + 8 * 1024 <= SMEM_MAX)
    assert s["smem"] == ring + (8 * 1024 if s["phasor_in_smem"] else 0) <= SMEM_MAX
    assert s["phasor_in_smem"] == (tile == "chain" or itemsize > 1)


@pytest.mark.parametrize("itemsize,stages,ring", [(1, 4, 164_928), (2, 4, 197_696),
                                                  (4, 3, 197_680)])
def test_schedule_stages_fit_shared_memory(itemsize, stages, ring):
    """A stage holds four 8 KB operator boxes and the raw tile, 128 lines of
    64 samples: four stages for uint8 and uint16 lines, three for float32
    lines, and beside the ring the phase kernel's phasor rows (8 bytes a
    column, 8 KB at n_out = 1024), all within the 232 448 bytes of dynamic
    shared memory a block may have on sm_90; the real kernel keeps none."""
    s = tfp.prep_bf16_schedule(999, 1024, itemsize, H100_SMS)
    assert s["stages"] == stages and s["phasor_in_smem"] and s["tile"] == "chain"
    assert s["smem"] == ring + 8 * 1024 <= SMEM_MAX
    stage = 4 * 8192 + 128 * 64 * itemsize
    assert stage % 1024 == 0
    assert stages == 4 or 1024 + (stages + 1) * stage + 16 * (stages + 1) > SMEM_MAX
    real = tfp.prep_bf16_schedule(999, 1024, itemsize, H100_SMS, phase=False)
    assert real["smem"] == ring and not real["phasor_in_smem"]


def test_schedule_phasor_beyond_shared_memory():
    """Where 8 * n_out bytes do not fit beside the ring the phase kernel
    reads its phasor rows from device memory and asks for the ring alone:
    past 4344 columns beside the one-chain ring of uint16 lines, past 2298
    beside three stages and the hi parts of uint16 lines (214 064 bytes),
    past 4348 beside two stages and the hi parts of float32 lines."""
    for n_in, itemsize, ring, limit in ((1024, 2, 197_696, 4344), (4352, 2, 214_064, 2298),
                                        (4352, 4, 197_664, 4348)):
        past = tfp.prep_bf16_schedule(999, limit + 8, itemsize, H100_SMS, n_in=n_in)
        assert not past["phasor_in_smem"] and past["smem"] == ring
        fits = tfp.prep_bf16_schedule(999, limit, itemsize, H100_SMS, n_in=n_in)
        assert fits["phasor_in_smem"] and fits["smem"] == ring + 8 * limit <= SMEM_MAX


def test_schedule_fewer_tiles_than_sms():
    """A small buffer launches one block per tile."""
    s = tfp.prep_bf16_schedule(129, 300, 2, H100_SMS)
    assert (s["tiles"], s["grid"]) == (4, 4)


# ---------------------------------------------------------------------------
# The bf16 prep rows of the bench (CPU stand-ins)
# ---------------------------------------------------------------------------

SMALL = AcqParams(samples_per_line=256, ascans_per_bscan=16, bscans_per_buffer=2,
                  buffers_per_volume=1, bit_depth=12)


@pytest.fixture
def small_bench(monkeypatch):
    """The bench at a small geometry, its prep launch replaced by a
    stand-in that reads the route the wrapper would take and runs the plain
    version: the routes it saw are returned."""
    monkeypatch.setattr(bench, "FULL_ACQ", SMALL)
    monkeypatch.setattr(bench, "CURVE_KW", dict(bench.CURVE_KW,
                                                resample_coeffs=(0.0, 255.0, 10.0, -4.0)))
    routes = []

    def prep(raw, parts, cos_row, sin_row, *, bitshift):
        family = "prep_phase" if cos_row is not None else "prep_real"
        routes.append(tfp._kernel_operands(raw, (parts,), family)[3])
        if cos_row is None:
            return tfp.prep_real_plain(raw, parts, bitshift=bitshift)
        return tfp.prep_phase_plain(raw, parts, cos_row, sin_row, bitshift=bitshift)

    monkeypatch.setattr(tfp, "_launch_prep", prep)
    return routes


@pytest.mark.parametrize("name", ["prep_phase_bf16", "prep_real_bf16"])
def test_bf16_prep_cases_take_the_bf16_route(small_bench, name):
    """Each bf16 prep case feeds shifted 12-bit samples and the operator as
    one rounded bf16 part: its launch takes the ``tensor_core_bf16`` route
    and equals its plain version (complex64 with the phasor, float32
    without), and its library call is cuBLAS's bf16 product of the same
    rounded operands, which stores bf16."""
    kernel, plain, library, bound = bench._kernel_cases(name, "cpu")
    got, want = kernel(), plain()
    assert small_bench == ["tensor_core_bf16"]
    want_dtype = torch.complex64 if name == "prep_phase_bf16" else torch.float32
    assert got.dtype == want.dtype == want_dtype and torch.equal(got, want)
    assert tuple(got.shape) == (SMALL.ascans_per_buffer, 256)
    y = library()
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (SMALL.ascans_per_buffer, 256)
    assert bound == bench.kernel_bound(name, lines=SMALL.ascans_per_buffer, n_in=256,
                                       n_out=256, bf16=True)


@pytest.mark.parametrize("name,bound_ms,bound_by,out", [
    ("prep_phase_bf16", 0.4012, "bytes", 131072 * 1024 * 8 + 2 * 1024 * 4),
    ("prep_real_bf16", 0.2779, "operations", 131072 * 1024 * 4)])
def test_kernel_bound_of_the_bf16_prep_rows(name, bound_ms, bound_by, out):
    """At the main path's shape: one bf16 term of 275 GFLOP (0.278 ms at 989
    TFLOP/s) against the uint16 lines, the one bf16 part of P and the
    output -- 1.34 GB with complex64 spectra, 0.401 ms at 3.35 TB/s, so the
    phase kernel is bound by its bytes and the real one by its
    operations."""
    got = bench.kernel_bound(name, lines=131072, n_in=1024, n_out=1024, bf16=True)
    assert got["bound_ms"] == pytest.approx(bound_ms, abs=1e-4)
    assert got["bound_by"] == bound_by
    assert got["flops"] == 2 * 131072 * 1024 * 1024
    assert got["bytes"] == 131072 * 1024 * 2 + 1024 * 1024 * 2 + out


# ---------------------------------------------------------------------------
# The kernel's sum order against the JAX package (CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jfp():
    """The JAX package's fused_prep module (the pallas package's __init__
    re-exports a function of the same name, hence import_module)."""
    import importlib

    return importlib.import_module("octproz_tpu.pallas.fused_prep")


@pytest.mark.parametrize("background", [False, True])
@pytest.mark.parametrize("n_in", [2048, 4096])
def test_folded_sum_order_matches_pallas(jfp, n_in, background):
    """B7 at bf16 on 2048- and 4096-sample lines of unshifted 12-bit
    samples, with and without background removal in the ``make_curves``
    operator: x and P rounded to bf16, y = x P summed as the kernel's
    "carry" tiles sum it (the bulk of the float32 sums moved into bf16 hi
    parts every F = 256 samples), times the phasor, against the JAX
    package's bf16 ``fused_prep`` in interpret mode, within the prep
    bound."""
    import dataclasses

    import jax.numpy as jnp
    import octproz_tpu.params as jparams

    geometry = dict(samples_per_line=n_in, ascans_per_bscan=8, bscans_per_buffer=2,
                    bit_depth=12)
    fields = dict(bitshift=False, compute_dtype="bfloat16", background_removal=background)
    cfg = dataclasses.replace(bench.fft_config(), **fields)
    jcfg = dataclasses.replace(jparams.default_full_config(), fft_via_matmul=False,
                               use_pallas_prep=True, **fields)
    acq = AcqParams(**geometry)
    cv = tcurves.make_curves(acq, cfg, **{**bench.CURVE_KW,
                                          "resample_coeffs": (0.0, n_in - 1.0, 10.0, -4.0)},
                             device="cpu")
    raw = np.random.default_rng(17).integers(0, 4096, size=acq.buffer_shape).astype(np.uint16)
    want = jfp.fused_prep(jnp.asarray(raw), jnp.asarray(cv.prep_operator.numpy()),
                          jnp.asarray(cv.phase.numpy()), jparams.AcqParams(**geometry), jcfg,
                          interpret=True)
    x = torch.from_numpy(raw.reshape(-1, n_in).astype(np.float32))
    x = x.to(torch.bfloat16).to(torch.float32)
    w = cv.prep_parts[0].to(torch.float32)
    fold = tfp.prep_bf16_schedule(16, n_in, 2, H100_SMS)["fold"]
    assert fold == 256
    hi = sums = torch.zeros((x.shape[0], n_in))
    for k0 in range(0, n_in, fold):  # the kernel's "carry" order, as in test_torch_fold_bf16
        t = hi + (sums + x[:, k0:k0 + fold] @ w[k0:k0 + fold])
        hi = t.to(torch.bfloat16).to(torch.float32)
        sums = t - hi
    y = hi + sums
    got = torch.complex(y * cv.phase.real, y * cv.phase.imag)
    err = tfp.prep_error(got, torch.from_numpy(np.array(want)).reshape(-1, n_in))
    assert err <= tfp.PREP_REL_L2, err


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

KINDS = {"u8": False, "u12-shifted": True, "u12": False, "f32": False}  # -> bitshift


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the one-term kernel is CUDA C++ for sm_90a and has "
                    "no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true float32
    return torch.device("cuda", 0)


def _card_raw(kind, lines, n, g, dev):
    if kind == "u8":
        return torch.randint(0, 256, (lines, n), dtype=torch.uint8, generator=g, device=dev)
    if kind == "f32":
        return torch.randint(0, 1 << 24, (lines, n), dtype=torch.int32, generator=g,
                             device=dev).to(torch.float32)
    return torch.randint(0, 4096, (lines, n), dtype=torch.int16, generator=g,
                         device=dev).view(torch.uint16)


def _prep_operator(n, background_removal, dev):
    """The FFT path's float32 prep operator and phasor rows at n samples."""
    acq = AcqParams(samples_per_line=n, ascans_per_bscan=8, bscans_per_buffer=1)
    cfg = bench.fft_config(background_removal=background_removal, compute_dtype="bfloat16")
    cv = tcurves.make_curves(acq, cfg, **{**bench.CURVE_KW,
                                          "resample_coeffs": (0.0, n - 1.0, 10.0, -4.0)},
                             device=dev)
    return cv.prep_operator, (cv.phase.real.contiguous(), cv.phase.imag.contiguous())


def _run(raw, parts, rows, bitshift):
    """The kernel (phase with ``rows``, real without) and its plain version."""
    if rows is None:
        return (tfp.prep_real(raw, parts, bitshift=bitshift),
                tfp.prep_real_plain(raw, parts, bitshift=bitshift))
    return (tfp.prep_phase(raw, parts, *rows, bitshift=bitshift),
            tfp.prep_phase_plain(raw, parts, *rows, bitshift=bitshift))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
def test_prep_bf16_matches_plain_on_card(cuda_device, kind):
    """B7 and B8 at bf16 on every (lines, n_out) of the grid and on odd
    n_out = 1001, background removal in every other operator, against the
    plain versions; each launch on ``tensor_core_bf16``."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(41)
    case = 0
    for n in N_OUTS + (1001,):
        ops = {bg: _prep_operator(n, bg, cuda_device) for bg in (False, True)}
        for lines in LINES if n != 1001 else (129, 999):
            op, rows = ops[case % 2 == 1]
            parts = tfp._operator_parts(op, tfp.BF16)
            raw = _card_raw(kind, lines, n, g, cuda_device)
            for family, epi_rows in (("prep_phase", rows), ("prep_real", None)):
                tfp.reset_launch_counts()
                got, want = _run(raw, parts, epi_rows, KINDS[kind])
                torch.cuda.synchronize()
                assert tfp.ONE_PASS_ROUTES[family] == {"tensor_core": 0,
                                                       "tensor_core_bf16": 1}, family
                assert got.dtype == want.dtype and got.shape == (lines, n)
                err = tfp.prep_error(got, want)
                assert err <= tfp.PREP_REL_L2, (family, n, lines, case % 2, err)
            case += 1


def _dense_operator(n_in, n_out, g, dev):
    """A dense random P (n_in terms of random sign in every sum) and a
    random phasor."""
    op = torch.randn((n_in, n_out), generator=g, device=dev).div(64.0)
    angle = torch.rand(n_out, generator=g, device=dev) * 6.283185307179586
    return op, (torch.cos(angle), torch.sin(angle))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["u12", "f32"])
def test_prep_bf16_phasor_in_device_memory_on_card(cuda_device, kind):
    """Where the phasor rows (8 bytes a column) do not fit beside the ring
    -- 4352 columns beside the one-chain ring of uint16 lines (n_in = 1024)
    and the "carry" ring of float32 lines (n_in = 4352) -- the phase kernel
    reads them from device memory and still matches its plain version, on
    a dense random operator."""
    n_in, n_out = (1024, 4352) if kind == "u12" else (4352, 4352)
    itemsize = 2 if kind == "u12" else 4
    s = tfp.prep_bf16_schedule(999, n_out, itemsize, H100_SMS, n_in=n_in)
    assert not s["phasor_in_smem"] and s["tile"] == ("chain" if kind == "u12" else "carry")
    g = torch.Generator(device=cuda_device)
    g.manual_seed(43)
    op, rows = _dense_operator(n_in, n_out, g, cuda_device)
    parts = tfp._operator_parts(op, tfp.BF16)
    raw = _card_raw(kind, 999, n_in, g, cuda_device)
    tfp.reset_launch_counts()
    got, want = _run(raw, parts, rows, False)
    torch.cuda.synchronize()
    assert tfp.ONE_PASS_ROUTES["prep_phase"]["tensor_core_bf16"] == 1
    assert tfp.prep_error(got, want) <= tfp.PREP_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("operators", ["curves", "dense"])
@pytest.mark.parametrize("n_in", [2048, 4096, 4352])
def test_prep_bf16_long_lines_match_plain_on_card(cuda_device, n_in, operators):
    """B7 and B8 at bf16 on 2048-, 4096- and 4352-sample lines (tile
    "carry": the bulk of the sums moved out of the chain every 256 samples;
    the phasor rows in shared memory at 2048, in device memory beyond),
    12-bit and 24-bit float32 samples, with the ``make_curves`` operators
    (with and without background removal) and a dense random one (where
    one chain over n_in read 4.1e-6 at 4096): within the prep bound."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(44 + n_in)
    if operators == "curves":
        ops = [_prep_operator(n_in, bg, cuda_device) for bg in (False, True)]
    else:
        ops = [_dense_operator(n_in, n_in, g, cuda_device)]
    assert tfp.prep_bf16_schedule(999, n_in, 2, H100_SMS)["tile"] == "carry"
    for kind in ("u12", "f32"):
        raw = _card_raw(kind, 999, n_in, g, cuda_device)
        for op, rows in ops:
            parts = tfp._operator_parts(op, tfp.BF16)
            for family, epi_rows in (("prep_phase", rows), ("prep_real", None)):
                tfp.reset_launch_counts()
                got, want = _run(raw, parts, epi_rows, False)
                torch.cuda.synchronize()
                assert tfp.ONE_PASS_ROUTES[family]["tensor_core_bf16"] == 1
                err = tfp.prep_error(got, want)
                assert err <= tfp.PREP_REL_L2, (kind, family, err)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["prep_phase", "prep_real"])
def test_prep_bf16_controls_fail_on_card(cuda_device, family):
    """On unshifted 12-bit samples a kernel fed x truncated to bf16, and the
    one-pass rung's three-part route, both fail the prep bound against the
    bf16 plain version."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(42)
    op, rows = _prep_operator(1024, False, cuda_device)
    rows = rows if family == "prep_phase" else None
    bf = tfp._operator_parts(op, tfp.BF16)
    raw = _card_raw("u12", 4096, 1024, g, cuda_device)
    x_trunc = tfp._bf16_trunc(raw.to(torch.float32)).to(torch.int16).view(torch.uint16)
    want = _run(raw, bf, rows, False)[1]
    for kernel_in in ((x_trunc, bf), (raw, tfp._operator_parts(op, "default"))):
        got = _run(*kernel_in, rows, False)[0]
        err = tfp.prep_error(got, want)
        assert err > tfp.PREP_REL_L2, err


@pytest.mark.cuda
def test_prep_bf16_refuses_other_than_one_part(cuda_device):
    """At passes = BF16_PASS the C entries take one bf16 part; two are
    refused with an error code (the wrapper raises on it), never run on
    another kernel."""
    from octproz_tpu_torch.kernels import build

    lib = build.load()
    raw = torch.zeros((128, 256), dtype=torch.uint16, device=cuda_device)
    w = torch.zeros((256, 256), dtype=torch.bfloat16, device=cuda_device)
    row = torch.zeros(256, device=cuda_device)
    out = torch.empty((128, 256), dtype=torch.complex64, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    p = w.data_ptr()
    rc = lib.prep_gemm_phase(raw.data_ptr(), 1, 0, tfp._BF16_PASS, p, p, None, row.data_ptr(),
                             row.data_ptr(), out.data_ptr(), 128, 256, 256, stream)
    assert rc != 0
    rc_real = lib.prep_gemm_real(raw.data_ptr(), 1, 0, tfp._BF16_PASS, p, p, None,
                                 out.data_ptr(), 128, 256, 256, stream)
    assert rc_real != 0
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tfp._raise_on(rc, lib, "prep_phase")
    torch.cuda.synchronize()
