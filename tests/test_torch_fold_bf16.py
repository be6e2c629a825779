"""The persistent one-term kernel of the fold families at
``compute_dtype="bfloat16"`` (``csrc/fold_bf16.cuh``: B1 ``_kernel_depth``,
B2 ``_kernel_depth_scale`` and B5 ``_kernel_depth_scale_concat`` with x and
the operator rounded to bf16), and the float32-line kernels' rows of the
bench.

On the CPU: the mirror of the kernel's host arithmetic
(``fused_prep.fold_bf16_schedule`` / ``fold_bf16_tile``: the tile by n_in
-- one wgmma chain up to 1024 samples, beyond it the bulk of the sums moved
out of the chain every F = 256 samples into bf16 hi parts in shared memory
-- grid, stages,
shared memory, the walk of the tiles) on odd shapes; a torch emulation of
the kernel's sum order (the bulk of the float32 sums moved into bf16 hi
parts every F = 256 samples) against the JAX package's bf16
``fused_depth_transform`` in
interpret mode at 2048- and 4096-sample lines; the bench's ``depth_bf16``
row and ``*_f32lines`` names (B1/B2/B5/B7/B8 at one pass on 24-bit samples
as float32 lines, all five on the tensor cores as three x parts) through
``bench._kernel_cases``
with the launches replaced by stand-ins that take the wrapper's route and
run the plain version, beside ``bench.kernel_bound`` for those rows.  The
agreement of B1/B2/B5 at bf16 with the JAX package's Pallas kernels is
held in ``tests/test_torch_bf16.py``.

On a CUDA GPU only (marked ``cuda``; this file imports JAX only inside its
CPU comparison): the scaled kernels against their plain versions over
lines {1, 127, 129, 999, 131073}, half {64, 100, 128, 512, 550}, uint8 /
12-bit / float32 lines, float32 and bf16 stores and the three scaling
modes, the concat views among them, and the planar kernel over the same
grid; B1/B2/B5 at 2048-, 4096- and 4352-sample lines (folded chains)
with the ``make_curves`` operators and a dense random operator; every launch counted on ``tensor_core_bf16``; the controls that
must fail (x truncated instead of rounded, the three-part route, on
unshifted 12-bit samples); a launch with other than one part per axis
refused.  Bounds: ``fused_prep.planar_error`` for B1 (relative L2 <=
3e-6), ``fused_prep.scale_error`` for B2/B5 (RMS <= 1e-6, max <= 1e-4
display units above the display floor, one bf16 step more for a bf16
store), with the floor at 20 log10 of the samples' range over that of
8-bit values (0, 24 and 96 dB for 8-bit, 12-bit and 24-bit samples): below
it log10 amplifies the two float32 sums' rounding without bound.  Linear
scaling on 8-bit ranges, or over a display range as many times wider as the
samples' range is, its bound being absolute display units.
"""

import dataclasses

import numpy as np
import pytest
import torch

from octproz_tpu_torch import bench
from octproz_tpu_torch import curves as tcurves
from octproz_tpu_torch.kernels import fused_prep as tfp
from octproz_tpu_torch.params import AcqParams, default_full_config

LINES = (1, 127, 129, 999, 131073)
HALVES = (64, 100, 128, 512, 550)
H100_SMS = 132


# ---------------------------------------------------------------------------
# The host arithmetic of fold_bf16.cuh (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("half", HALVES)
@pytest.mark.parametrize("lines", LINES)
def test_schedule_walks_every_tile_once(lines, half):
    """Blocks b = 0 .. grid-1 walking tiles b, b + grid, ... cover every
    (line, bin) of the image exactly once, each tile inside the image at its
    first line and bin, the grid at most one block per SM."""
    s = tfp.fold_bf16_schedule(lines, half, 2, H100_SMS)
    assert s["grid"] == min(s["tiles"], H100_SMS)
    assert s["tiles"] == -(-lines // 128) * s["col_tiles"] and s["col_tiles"] == -(-half // 128)
    seen = np.zeros((-(-lines // 128) * 128, s["col_tiles"] * 128), np.int32)
    for block in range(s["grid"]):
        for t in range(block, s["tiles"], s["grid"]):
            m0, n0 = tfp.fold_bf16_tile(t, s["col_tiles"])
            assert m0 < lines and n0 < half
            seen[m0:m0 + 128, n0:n0 + 128] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("itemsize,stages", [(1, 4), (2, 3), (4, 2)])
@pytest.mark.parametrize("n_in", [64, 1024, 1088, 2048, 4096, 4352])
def test_schedule_tile_switches_at_the_longest_chain(n_in, itemsize, stages):
    """Up to 1024 samples one wgmma chain over n_in (tile "chain"); beyond,
    the bulk of every sum moved out of the chain every F = 256 samples into
    bf16 hi parts in shared memory (tile "carry", 64 KB a block), beside
    four, three and two stages of uint8, uint16 and float32 lines: the
    planar and the scaled fold families alike, within a block's 232 448
    bytes, the tiles as wide at every n_in."""
    half = n_in // 2
    s = tfp.fold_bf16_schedule(999, half, itemsize, H100_SMS, n_in=n_in)
    tile = "chain" if n_in <= 1024 else "carry"
    assert tfp.BF16_CHAIN_MAX == 1024 and tfp.BF16_FOLD == 256
    assert s["tile"] == tile and s["fold"] == (None if tile == "chain" else 256)
    assert s["col_tiles"] == -(-half // 128)
    stage = 4 * 8192 + 128 * 64 * itemsize
    hi = 65_536 if tile == "carry" else 0
    if tile == "carry":
        assert s["stages"] == stages
        assert 1024 + (stages + 1) * (stage + 16) + hi > 232_448 or stages == 4
    assert s["smem"] == 1024 + s["stages"] * (stage + 16) + hi <= 232_448
    assert tfp.fold_bf16_schedule(999, half, itemsize, H100_SMS) == s  # n_in = 2 half


def test_schedule_keeps_a_row_tile_together():
    """Column tiles run fastest: the 132 tiles one wave holds at the main
    path's shape (131072 lines, 512 bins) span 33 row tiles, 4.2 MB of raw
    uint16 lines, so each raw tile comes from device memory once."""
    s = tfp.fold_bf16_schedule(131072, 512, 2, H100_SMS)
    assert (s["tiles"], s["col_tiles"], s["grid"]) == (4096, 4, 132)
    rows = {tfp.fold_bf16_tile(t, 4)[0] for t in range(s["grid"])}
    assert len(rows) == 33 and max(rows) == 32 * 128


@pytest.mark.parametrize("itemsize,stages,smem", [(1, 4, 164_928), (2, 4, 197_696),
                                                  (4, 3, 197_680)])
def test_schedule_stages_fit_shared_memory(itemsize, stages, smem):
    """A stage holds four 8 KB operator boxes and the raw tile, 128 lines of
    64 samples: four stages for uint8 and uint16 lines, three for float32
    lines, within the 232 448 bytes of dynamic shared memory a block may
    have on sm_90, 1024 of them for alignment; each stage a multiple of the
    1024-byte swizzle atom."""
    s = tfp.fold_bf16_schedule(999, 512, itemsize, H100_SMS)
    assert (s["stages"], s["smem"]) == (stages, smem) and s["tile"] == "chain"
    assert s["smem"] <= 232_448
    stage = 4 * 8192 + 128 * 64 * itemsize
    assert stage % 1024 == 0
    assert stages == 4 or 1024 + (stages + 1) * stage + 16 * (stages + 1) > 232_448


def test_schedule_fewer_tiles_than_sms():
    """A small image launches one block per tile."""
    s = tfp.fold_bf16_schedule(129, 100, 2, H100_SMS)
    assert (s["tiles"], s["grid"]) == (2, 2)


# ---------------------------------------------------------------------------
# The float32-line rows of the bench (CPU stand-ins)
# ---------------------------------------------------------------------------

SMALL = AcqParams(samples_per_line=256, ascans_per_bscan=16, bscans_per_buffer=2,
                  buffers_per_volume=1, bit_depth=12)


@pytest.fixture
def small_bench(monkeypatch):
    """The bench at a small geometry, its launches replaced by stand-ins
    that read the route the wrapper would take and run the plain version:
    the routes they saw are returned."""
    monkeypatch.setattr(bench, "FULL_ACQ", SMALL)
    monkeypatch.setattr(bench, "CURVE_KW", dict(bench.CURVE_KW,
                                                resample_coeffs=(0.0, 255.0, 10.0, -4.0)))
    routes = []

    def depth(raw, wre, wim, *, bitshift):
        routes.append(tfp._kernel_operands(raw, (wre, wim), "depth")[3])
        return tfp.depth_plain(raw, wre, wim, bitshift=bitshift)

    def depth_scale(raw, wre, wim, mean2, *, fast_log, **kw):
        routes.append(tfp._kernel_operands(raw, (wre, wim), "depth_scale")[3])
        return tfp.depth_scale_plain(raw, wre, wim, mean2, fast_log=fast_log, **kw)

    def concat(raw, wide, mean2, **kw):
        routes.append(tfp._kernel_operands(raw, (wide,), "depth_scale_concat")[3])
        return tfp.depth_scale_concat_plain(raw, wide, mean2, **kw)

    def prep(raw, parts, cos_row, sin_row, *, bitshift):
        family = "prep_phase" if cos_row is not None else "prep_real"
        routes.append(tfp._kernel_operands(raw, (parts,), family)[3])
        if cos_row is None:
            return tfp.prep_real_plain(raw, parts, bitshift=bitshift)
        return tfp.prep_phase_plain(raw, parts, cos_row, sin_row, bitshift=bitshift)

    monkeypatch.setattr(tfp, "_launch_depth", depth)
    monkeypatch.setattr(tfp, "_launch_depth_scale", depth_scale)
    monkeypatch.setattr(tfp, "_launch_depth_scale_concat", concat)
    monkeypatch.setattr(tfp, "_launch_prep", prep)
    return routes


@pytest.mark.parametrize("name", bench.F32_LINE_KERNELS)
def test_f32line_cases_take_the_three_x_part_route(small_bench, name):
    """Each ``*_f32lines`` case feeds 24-bit samples as float32 lines (no
    bitshift): its launch takes the tensor-core route with three x parts,
    equals its plain version,
    and its library call is the float32 product of the same x by the
    float32 operator [W_re | W_im] (or P); its bound counts the six terms
    of three x parts on the tensor-core route."""
    kernel, plain, library, bound = bench._kernel_cases(name, "cpu")
    got, want = kernel(), plain()
    assert small_bench == ["tensor_core"]
    for g, w in zip(*((t if isinstance(t, tuple) else (t,)) for t in (got, want))):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
    y = library()
    assert y.dtype == torch.float32
    n_out = 256 if name.startswith("prep") else 128
    assert tuple(y.shape) == (SMALL.ascans_per_buffer, n_out * (1 if name.startswith("prep")
                                                                 else 2))
    assert bound == bench.kernel_bound(name, lines=SMALL.ascans_per_buffer, n_in=256,
                                       n_out=n_out, in_itemsize=4, x_parts=3)


def test_float32_lines_are_24_bit_samples():
    """The bench's float32 lines: integers below 2^24, most above 16 bits
    (beyond what x_hi + x_lo carries), made from a seed."""
    a = bench.float32_lines(SMALL, "cpu", seed=5)
    assert a.dtype == torch.float32 and tuple(a.shape) == (32, 256)
    assert torch.equal(a, bench.float32_lines(SMALL, "cpu", seed=5))
    assert float(a.max()) < 2 ** 24 and float((a >= 2 ** 16).double().mean()) > 0.9
    assert torch.equal(a, a.round())


@pytest.mark.parametrize("name", bench.F32_LINE_KERNELS)
def test_kernel_bound_of_the_f32line_rows(name):
    """At the main path's shapes on float32 lines of 24-bit samples (three
    x parts): six bf16 terms of 275 GFLOP at 989 TFLOP/s, 1.668 ms, bound
    by its operations; bytes are the float32 lines, the operator's three
    bf16 parts (two operators for the fold families' re and im, one P) and
    the output."""
    n_out = 1024 if name.startswith("prep") else 512
    got = bench.kernel_bound(name, lines=131072, n_in=1024, n_out=n_out, in_itemsize=4,
                             x_parts=3)
    family = name[:-len("_f32lines")]
    assert got["bound_ms"] == pytest.approx(1.6676, abs=1e-4)
    assert got["bound_by"] == "operations"
    assert got["flops"] == 6 * 2 * 131072 * 1024 * 1024
    gemms = 1 if name.startswith("prep") else 2
    out = {"depth": 2 * 131072 * 512 * 4, "depth_scale": 131072 * 512 * 4 + 2 * 512 * 4,
           "depth_scale_concat": 131072 * 512 * 4 + 2 * 512 * 4,
           "prep_phase": 131072 * 1024 * 8 + 2 * 1024 * 4,
           "prep_real": 131072 * 1024 * 4}[family]
    assert got["bytes"] == 131072 * 1024 * 4 + gemms * 3 * 1024 * n_out * 2 + out


def test_bf16_depth_case_takes_the_bf16_route(small_bench):
    """The bench's ``depth_bf16`` case feeds shifted 12-bit samples and one
    rounded bf16 part per axis: its launch takes the ``tensor_core_bf16``
    route and equals its plain version (planar float32 re and im), and its
    library call is cuBLAS's bf16 product of the same rounded operands
    against [W_re | W_im], which stores bf16."""
    kernel, plain, library, bound = bench._kernel_cases("depth_bf16", "cpu")
    got, want = kernel(), plain()
    assert small_bench == ["tensor_core_bf16"]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and torch.equal(g, w)
        assert tuple(g.shape) == (SMALL.ascans_per_buffer, 128)
    y = library()
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (SMALL.ascans_per_buffer, 256)
    assert bound == bench.kernel_bound("depth_bf16", lines=SMALL.ascans_per_buffer, n_in=256,
                                       n_out=128, bf16=True)


def test_kernel_bound_of_the_depth_bf16_row():
    """At the main path's shape: two bf16 products (re, im) of 137 GFLOP
    each, 0.278 ms at 989 TFLOP/s, against the uint16 lines, the two rounded
    bf16 operators and two float32 planes of 131072 x 512 -- 0.81 GB, 0.241
    ms at 3.35 TB/s: bound by its operations."""
    got = bench.kernel_bound("depth_bf16", lines=131072, n_in=1024, n_out=512, bf16=True)
    assert got["bound_ms"] == pytest.approx(0.2779, abs=1e-4)
    assert got["bound_by"] == "operations"
    assert got["flops"] == 2 * 2 * 131072 * 1024 * 512
    assert got["bytes"] == 131072 * 1024 * 2 + 2 * 1024 * 512 * 2 + 2 * 131072 * 512 * 4
    assert got["bytes"] / 3.35e12 * 1e3 == pytest.approx(0.2410, abs=1e-4)


@pytest.mark.parametrize("mode", ["log", "fast_log", "lin"])
def test_depth_scale_f64_matches_the_plain_version(mode):
    """The image of the float64 products (``fused_prep.depth_scale_f64``,
    the long-line card cases' reference for the scaled images) agrees with
    the plain version within the scale bounds on 12-bit samples (8-bit for
    lin), and equals the float32 epilogue of the float64 p."""
    n, half = 512, 256
    g = torch.Generator().manual_seed(35)
    _, _, (wre, wim) = _bf16_operators(n, "cpu")
    raw = torch.randint(0, 256 if mode == "lin" else 4096, (64, n), generator=g,
                        dtype=torch.int16).view(torch.uint16)
    mean2 = torch.randn((2, half), generator=g) * 50.0
    floor = 0.0 if mode == "lin" else 24.0
    a, b = tfp._scale_affine(mode != "lin", half, floor, floor + 60.0, 0.0, 1.0)
    kw = dict(bitshift=False, log_scaling=mode != "lin", a=a, b=b, fast_log=mode == "fast_log")
    exact = tfp.depth_scale_f64(raw, wre, wim, mean2, **kw)
    assert exact.dtype == torch.float32 and exact.shape == (64, half)
    rms, worst, ok = tfp.scale_error(tfp.depth_scale_plain(raw, wre, wim, mean2, **kw), exact)
    assert ok, (rms, worst)
    x = raw.to(torch.float32).to(torch.bfloat16).to(torch.float64)
    re = x @ wre[0].double() - mean2[0].double()
    im = x @ wim[0].double() - mean2[1].double()
    p = (re * re + im * im).float()
    assert torch.equal(exact, tfp._scale_epilogue(p, log_scaling=mode != "lin", a=a, b=b,
                                                  fast_log=mode == "fast_log"))


# ---------------------------------------------------------------------------
# The kernel's sum order against the JAX package (CPU)
# ---------------------------------------------------------------------------

def _carried_product(x: torch.Tensor, w: torch.Tensor, fold: int) -> torch.Tensor:
    """x @ w in the one-term kernel's order on "carry" tiles: the chain's
    float32 sums (here a float32 product of each ``fold`` samples, added to
    them) and, every ``fold`` samples, t = hi + sums, hi = bf16_rn(t), sums
    = t - hi; hi + sums at the end."""
    hi = sums = torch.zeros((x.shape[0], w.shape[1]))
    for k0 in range(0, x.shape[1], fold):
        t = hi + (sums + x[:, k0:k0 + fold] @ w[k0:k0 + fold])
        hi = t.to(torch.bfloat16).to(torch.float32)
        sums = t - hi
    return hi + sums


@pytest.fixture(scope="module")
def jfp():
    """The JAX package's fused_prep module (the pallas package's __init__
    re-exports a function of the same name, hence import_module)."""
    import importlib

    return importlib.import_module("octproz_tpu.pallas.fused_prep")


@pytest.mark.parametrize("n_in", [2048, 4096])
def test_folded_sum_order_matches_pallas(jfp, n_in):
    """B1 at bf16 on 2048- and 4096-sample lines of unshifted 12-bit
    samples: x and the ``make_curves`` operators rounded to bf16, the
    product summed as the kernel's "carry" tiles sum it (the bulk of the
    float32 sums moved into bf16 hi parts every F = 256 samples) against
    the JAX package's bf16
    ``fused_depth_transform`` in interpret mode, within the planar bound."""
    import jax.numpy as jnp
    import octproz_tpu.params as jparams

    geometry = dict(samples_per_line=n_in, ascans_per_bscan=8, bscans_per_buffer=2,
                    bit_depth=12)
    fields = dict(bitshift=False, compute_dtype="bfloat16")
    cfg = dataclasses.replace(default_full_config(), **fields)
    jcfg = dataclasses.replace(jparams.default_full_config(), **fields)
    acq = AcqParams(**geometry)
    cv = tcurves.make_curves(acq, cfg, resample_coeffs=(0.0, n_in - 1.0, 10.0, -4.0),
                             **CURVE_KW, device="cpu")
    raw = np.random.default_rng(16).integers(0, 4096, size=acq.buffer_shape).astype(np.uint16)
    want = jfp.fused_depth_transform(jnp.asarray(raw), jnp.asarray(cv.depth_op_re.numpy()),
                                     jnp.asarray(cv.depth_op_im.numpy()),
                                     jparams.AcqParams(**geometry), jcfg, interpret=True)
    x = torch.from_numpy(raw.reshape(-1, n_in).astype(np.float32))
    x = x.to(torch.bfloat16).to(torch.float32)
    fold = tfp.fold_bf16_schedule(16, n_in // 2, 2, H100_SMS)["fold"]
    assert fold == 256
    got = [_carried_product(x, w[0].to(torch.float32), fold) for w in cv.depth_parts]
    want = [torch.from_numpy(np.array(w)).reshape(-1, n_in // 2) for w in want]
    err = tfp.planar_error(got, want)
    assert err <= tfp.PLANAR_REL_L2, err
    # the plain version (one float32 product) agrees as well
    assert tfp.planar_error(tfp.depth_plain(torch.from_numpy(raw.reshape(-1, n_in)),
                                            *cv.depth_parts, bitshift=False), got) \
        <= tfp.PLANAR_REL_L2


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

CURVE_KW = dict(dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
#: input kind -> (display floor dB, bitshift)
KINDS = {"u8": (0.0, False), "u12-shifted": (0.0, True), "u12": (24.0, False),
         "f32": (96.0, False)}


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


def _bf16_operators(n, dev):
    acq = AcqParams(samples_per_line=n, ascans_per_bscan=8, bscans_per_buffer=1)
    cfg = dataclasses.replace(default_full_config(), compute_dtype="bfloat16")
    cv = tcurves.make_curves(acq, cfg, resample_coeffs=(0.0, n - 1.0, 10.0, -4.0),
                             **CURVE_KW, device=dev)
    return cv.depth_op_re, cv.depth_op_im, cv.depth_parts


def _routes_are_bf16(family):
    assert tfp.ONE_PASS_ROUTES[family] == {"tensor_core": 0,
                                           "tensor_core_bf16": 1}, tfp.ONE_PASS_ROUTES[family]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
def test_fold_bf16_matches_plain_on_card(cuda_device, kind):
    """B2 and B5 at bf16 on every (lines, half) of the grid, the scaling
    mode, store and concat view cycling through the cases, against the
    plain versions; each launch on ``tensor_core_bf16``."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(31)
    floor, bitshift = KINDS[kind]
    modes = ("log", "fast_log", "lin") if floor == 0.0 else ("log", "fast_log")
    case = 0
    for half in HALVES:
        w_re, w_im, (wre, wim) = _bf16_operators(2 * half, cuda_device)
        wide = tfp.concat_operator(w_re, w_im, tfp.BF16)
        for lines in LINES:
            raw = _card_raw(kind, lines, 2 * half, g, cuda_device)
            mode = modes[case % len(modes)]
            odt = (torch.float32, torch.bfloat16)[case // len(modes) % 2]
            case += 1
            mean2 = torch.randn((2, half), generator=g, device=cuda_device) * 50.0
            a, b = tfp._scale_affine(mode != "lin", half, floor, floor + 60.0, 0.0, 1.0)
            kw = dict(bitshift=bitshift, log_scaling=mode != "lin", a=a, b=b, out_dtype=odt)
            tfp.reset_launch_counts()
            got = tfp.fold_depth_scale(raw, wre, wim, mean2, fast_log=mode == "fast_log", **kw)
            want = tfp.depth_scale_plain(raw, wre, wim, mean2, fast_log=mode == "fast_log",
                                         **kw)
            torch.cuda.synchronize()
            _routes_are_bf16("depth_scale")
            assert got.dtype == odt and got.shape == (lines, half)
            rms, worst, ok = tfp.scale_error(got, want)
            assert ok, (half, lines, mode, odt, rms, worst)
            if mode == "fast_log":
                continue  # the concat kernel takes log and lin
            got = tfp.fold_depth_scale_concat(raw, wide, mean2, **kw)
            want = tfp.depth_scale_concat_plain(raw, wide, mean2, **kw)
            torch.cuda.synchronize()
            _routes_are_bf16("depth_scale_concat")
            rms, worst, ok = tfp.scale_error(got, want)
            assert ok, ("concat", half, lines, mode, odt, rms, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
def test_fold_bf16_planar_matches_plain_on_card(cuda_device, kind):
    """B1 at bf16 (``one_term<InT, Planar>``: chain 0 to re, chain 1 to im,
    float2 stores, bin by bin at odd half) on every (lines, half) of the
    grid against its plain version; each launch on ``tensor_core_bf16``."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(33)
    bitshift = KINDS[kind][1]
    for half in HALVES + (257,):
        _, _, (wre, wim) = _bf16_operators(2 * half, cuda_device)
        for lines in LINES:
            raw = _card_raw(kind, lines, 2 * half, g, cuda_device)
            tfp.reset_launch_counts()
            got = tfp.fold_depth(raw, wre, wim, bitshift=bitshift)
            want = tfp.depth_plain(raw, wre, wim, bitshift=bitshift)
            torch.cuda.synchronize()
            _routes_are_bf16("depth")
            assert all(t.dtype == torch.float32 and t.shape == (lines, half) for t in got)
            err = tfp.planar_error(got, want)
            assert err <= tfp.PLANAR_REL_L2, (half, lines, err)


def _dense_operators(n, g, dev):
    """A dense random (W_re, W_im): n terms of random sign in every sum."""
    return tuple(torch.randn((n, n // 2), generator=g, device=dev).div(64.0) for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("operators", ["curves", "dense"])
@pytest.mark.parametrize("n_in", [2048, 4096, 4352])
def test_fold_bf16_long_lines_match_plain_on_card(cuda_device, n_in, operators):
    """B1, B2 and B5 at bf16 on 2048-, 4096- and 4352-sample lines (tile
    "carry": the bulk of the sums moved out of the chain every 256
    samples), 12-bit and 24-bit float32 samples, with the ``make_curves``
    operators and a dense random one (where one chain over n_in missed the
    planar bound, 4.0e-6 at 4096): the planar output within its bound
    against the plain version; the log, fast-log and linear images within
    the scale bounds against the image of the float64 products
    (``fused_prep.depth_scale_f64``) and within the RMS bound against the
    plain version, whose own float32 products reach the max bound in the
    deepest shown voxels from 4096 samples on (1.0e-4 from the float64
    image at 4352, the kernel 3.4e-5)."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(34 + n_in)
    if operators == "curves":
        w_re, w_im, _ = _bf16_operators(n_in, cuda_device)
    else:
        w_re, w_im = _dense_operators(n_in, g, cuda_device)
    wre, wim = (tfp._operator_parts(w, tfp.BF16) for w in (w_re, w_im))
    wide = tfp.concat_operator(w_re, w_im, tfp.BF16)
    half = n_in // 2
    assert tfp.fold_bf16_schedule(999, half, 2, H100_SMS)["tile"] == "carry"
    for kind in ("u12", "f32"):
        floor = KINDS[kind][0]
        raw = _card_raw(kind, 999, n_in, g, cuda_device)
        tfp.reset_launch_counts()
        got = tfp.fold_depth(raw, wre, wim, bitshift=False)
        want = tfp.depth_plain(raw, wre, wim, bitshift=False)
        torch.cuda.synchronize()
        _routes_are_bf16("depth")
        err = tfp.planar_error(got, want)
        assert err <= tfp.PLANAR_REL_L2, (kind, "planar", err)
        mean2 = torch.randn((2, half), generator=g, device=cuda_device) * 50.0
        for mode in ("log", "fast_log", "lin"):
            lo, hi = (0.0, 60.0 * 10 ** (floor / 20)) if mode == "lin" else (floor, floor + 60)
            a, b = tfp._scale_affine(mode != "lin", half, lo, hi, 0.0, 1.0)
            kw = dict(bitshift=False, log_scaling=mode != "lin", a=a, b=b)
            fast = dict(fast_log=mode == "fast_log")
            exact = tfp.depth_scale_f64(raw, wre, wim, mean2, **kw, **fast)
            runs = [("depth_scale", tfp.fold_depth_scale(raw, wre, wim, mean2, **kw, **fast),
                     tfp.depth_scale_plain(raw, wre, wim, mean2, **kw, **fast))]
            if mode != "fast_log":
                runs.append(("depth_scale_concat",
                             tfp.fold_depth_scale_concat(raw, wide, mean2, **kw),
                             tfp.depth_scale_concat_plain(raw, wide, mean2, **kw)))
            for family, got, want in runs:
                rms, worst, ok = tfp.scale_error(got, exact)
                assert ok, (kind, family, mode, "against float64", rms, worst)
                rms, worst, _ = tfp.scale_error(got, want)
                assert rms <= tfp.SCALE_RMS, (kind, family, mode, rms, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["depth_scale", "depth_scale_concat"])
def test_fold_bf16_controls_fail_on_card(cuda_device, family):
    """On unshifted 12-bit samples a kernel fed x truncated to bf16, and the
    one-pass rung's three-part route, both fail the scale bounds against
    the bf16 plain version (display floor 24 dB)."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(32)
    w_re, w_im, bf = _bf16_operators(1024, cuda_device)
    three = tuple(tfp._operator_parts(w, "default") for w in (w_re, w_im))
    raw = _card_raw("u12", 4096, 1024, g, cuda_device)
    x_trunc = tfp._bf16_trunc(raw.to(torch.float32)).to(torch.int16).view(torch.uint16)
    mean2 = torch.randn((2, 512), generator=g, device=cuda_device) * 50.0
    a, b = tfp._scale_affine(True, 512, 24.0, 84.0, 0.0, 1.0)
    kw = dict(bitshift=False, log_scaling=True, a=a, b=b)
    if family == "depth_scale":
        want = tfp.depth_scale_plain(raw, *bf, mean2, **kw)
        runs = (tfp.fold_depth_scale(x_trunc, *bf, mean2, **kw),
                tfp.fold_depth_scale(raw, *three, mean2, **kw))
    else:
        wide = tfp.concat_operator(w_re, w_im, tfp.BF16)
        want = tfp.depth_scale_concat_plain(raw, wide, mean2, **kw)
        runs = (tfp.fold_depth_scale_concat(x_trunc, wide, mean2, **kw),
                tfp.fold_depth_scale_concat(raw, tfp.concat_operator(w_re, w_im, "default"),
                                            mean2, **kw))
    for got in runs:
        rms, worst, ok = tfp.scale_error(got, want)
        assert not ok and rms > tfp.SCALE_RMS, (rms, worst)


@pytest.mark.cuda
def test_fold_bf16_refuses_other_than_one_part(cuda_device):
    """At passes = BF16_PASS the C entries take one bf16 part per axis; two
    are refused with an error code (the wrapper raises on it), never run on
    another kernel."""
    from octproz_tpu_torch.kernels import build

    lib = build.load()
    raw = torch.zeros((128, 256), dtype=torch.uint16, device=cuda_device)
    w = torch.zeros((256, 128), dtype=torch.bfloat16, device=cuda_device)
    mean2 = torch.zeros((2, 128), device=cuda_device)
    out = torch.empty((128, 128), device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    p = w.data_ptr()
    rc = lib.fold_gemm_scale(raw.data_ptr(), 1, 0, tfp._BF16_PASS, p, p, None, p, p, None,
                             mean2.data_ptr(), out.data_ptr(), 0, 0, 1.0, 0.0, 128, 256, 128,
                             stream)
    assert rc != 0
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tfp._raise_on(rc, lib, "fold_gemm_scale")
    rc = lib.fold_gemm_planar(raw.data_ptr(), 1, 0, tfp._BF16_PASS, p, p, None, p, p, None,
                              out.data_ptr(), out.data_ptr(), 128, 256, 128, stream)
    assert rc != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_split_planar_refuses_the_bf16_pass(cuda_device):
    """The shared pipeline of ``fold_split.cuh`` has no one-term mode: a
    BF16_PASS launch with one bf16 part per axis that reaches
    ``fold_split_planar`` directly is refused, as the scaled one is."""
    import ctypes

    from octproz_tpu_torch.kernels import build

    lib = build.load()
    raw = torch.zeros((128, 256), dtype=torch.uint16, device=cuda_device)
    w = torch.zeros((256, 128), dtype=torch.bfloat16, device=cuda_device)
    out = torch.empty((128, 128), device=cuda_device)
    parts = (ctypes.c_void_p * 3)(w.data_ptr(), None, None)
    vp = ctypes.c_void_p
    lib.fold_split_planar.argtypes = [vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, vp, vp,
                                      vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp]
    lib.fold_split_planar.restype = ctypes.c_int
    rc = lib.fold_split_planar(raw.data_ptr(), 1, 0, tfp._BF16_PASS, ctypes.addressof(parts),
                               ctypes.addressof(parts),
                               out.data_ptr(), out.data_ptr(), 128, 256, 128,
                               torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    torch.cuda.synchronize()
