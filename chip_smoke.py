"""Smoke test of the PyTorch/CUDA port (octproz_tpu_torch) on one GPU.

    python3 chip_smoke.py        (from the root of a checkout, one CUDA GPU)

Phases, each printing progress; any failure raises, so the exit code is
nonzero and the final line is not printed:

1. device: the card's name and power limit;
2. build: the CUDA kernels from ``octproz_tpu_torch/kernels/csrc``;
3. kernels: each kernel family (four fold, two concat fold, four prep)
   against its plain PyTorch version on the card, at the main path's
   widths, an odd line count and 1664-sample lines (and 1100 for the split
   fold, the concat and the prep kernels: 550 bins, not a multiple of the
   64-bin tile, and for the concat kernel's split rung an im view that is
   not 16-byte aligned, read element by element; 1088 for the concat and
   the prep kernels: 544 bins, a half-empty last tile), every family's
   one pass on the tensor cores (uint8/uint16 lines; float32 lines --
   24- and 32-bit samples and 16-bit values, n_in 1000 to 4096, 999 and
   131073 lines -- with three x parts for all five one-pass families; the
   route read back and logged), then controls (a kernel computing a
   neighbouring rung, the three-x-part kernels without x_lo, or for the
   concat kernels reading the im half one column early) that must fail;
4. fold path: ``FdOctModel`` on full 1024 x 512 x 256 buffers of the
   reference benchmark chain on the folded GEMM -- FPN determination,
   steady buffers and a batched chunk -- at the default and the "high"
   rung, then the handheld preset (post stages, batched chunk), with the
   fold kernels' launch counts read around that run; each rung's steady
   output and buffer 0's GEMM against the plain versions at full size (a
   one-pass steady output against the float64 product of its float32
   operator, see ``_check_steady_full_size``);
5. FFT path: the same chain through the prep kernels and cuFFT at the
   default, "high" and "highest" rungs (scan chunk against per-buffer
   steps), its dispersion-free variant and the handheld preset, with the
   prep kernels' launch counts read around that run (every default-rung
   phase and real launch on the tensor cores) and the split kernels' around each
   split rung's runs; each rung's full-size prep output against the plain
   versions; then 24-bit samples in uint32 containers through the fold,
   concat fold and FFT paths (with and without dispersion) at the default
   rung, each run between a reset and a read of the launch counts (every
   one-pass launch on the tensor cores with three x parts), with the
   full-size checks of phases 4 and 5; then the fold path with continuous
   FPN (``FpnMode.CONTINUOUS``: the FPN mean determined on every buffer,
   so B1 runs on every one) on 12-bit and 24-bit samples, B1's launches
   counted (one per buffer, on the tensor cores) and one buffer's planes
   held against the float64 product of its float32 operators, with its
   steady ms per buffer;
6. stream: ``StreamingEngine`` over full 12-bit buffers replayed from RAM
   by ``VirtualOctSource``, the benchmark chain with ``fold_concat`` at the
   default and the "high" rung, per buffer and in batch chunks of four, on
   the uint16 and the packed-12 wire, every buffer quantized and fetched
   to the host, with the launch counts read around each engine run (the
   rung's concat kernel launched for every steady buffer or chunk, the
   two-operator steady-state kernels not, every one-pass launch on the
   tensor cores): the streamed float32 recorder
   output against ``process_buffer`` on the same buffers, the packed-12
   wire's against the uint16 wire's (exact), the steady concat output at
   full size as in phase 4, and the engine's A-scan rate
   with the upload included (buffers over wall time, 3 s after warm-up)
   beside the steady ``process_buffer`` rate;
7. acquisition: the acquisition back ends and plugin loading, every engine
   run on the two-operator benchmark chain's kernels, with the launch
   counts read around each (B1 once for the FPN buffer, B2 once per steady
   buffer, nothing else, every launch on the tensor cores): a producer
   thread writes full 1024 x 512 x 256 buffers into a ``HardwareRingSource``
   of four slots (the native aligned ring) and ``StreamingEngine`` streams
   them -- three buffers recorded in float32 against ``process_buffer``,
   then the engine's A-scan rate over about 3 s after warm-up, on the ring
   and on the same buffers replayed from RAM, beside the steady
   ``process_buffer`` rate and the ring's host stages alone
   (``bench.ring_ms``); a plugin module loaded through
   ``plugins.load_plugin`` registers the PhytoOCT system and three bundled
   extensions, the system runs at its device's defaults for two volumes
   through the engine (every buffer against ``process_buffer`` on the
   device model's buffer, every extension fed every buffer) and each
   calibration stage is shown to cancel its artifact on the card's output;
   the dispersion estimator recovers d2 = 35 and d3 = -25 within 5 on the
   card, and at full width (a PhytoOCT buffer, 512 lines) reaches the host
   CPU's best sharpness;
8. application: the host application on the two-operator benchmark chain
   at full width, the launch counts read around each run (B1 once, B2 once
   per steady buffer, every launch on the tensor cores): ``cli.main``'s
   ``process`` on a raw file of two full buffers (``--preset benchmark``
   with ``bench.CURVE_KW``'s curves), its float32 output equal to
   ``process_buffer``'s (max difference 0) and its B-scan and en-face PNGs
   to the port's projections of that volume on the card; ``python -m
   octproz_tpu_torch info`` in a subprocess; the seven render modes at
   512 x 512 on the full processed buffer (256 x 512 x 512), timed with
   CUDA events, each finite, in [0, 1] and not all background, and each on
   a cut volume (32 x 64 x 64) on the card against the same function on
   the CPU; ``StreamingEngine`` with a ``LiveView`` (volume rendering on)
   and a camera pane on localhost: a ``POST /control`` dispersion change
   mid-stream, after which every streamed float32 buffer equals a fresh
   model's on the new coefficients (max difference 0; before it, the old
   model's), every PNG endpoint parsed and every JSON endpoint read, a
   ``POST /render`` refresh timed and the host volume's copy to the card
   timed alone; the engine's rate from RAM without and with a viewer in
   the same call; a recording with ``save_screenshots=True`` leaving three
   PNGs that decode; ``cli.main``'s ``replay --live --live-volume`` on a
   raw file of two full buffers, ``/render.json`` and ``/volume.png`` read
   from its viewer while it streams, then rc 0, the viewer's port closed
   and its threads joined;
9. mesh: the sharded step (``parallel``) at full width on the one card,
   the launch counts read around each run: ``FdOctModel`` on
   ``make_mesh(4, 1, [cuda:0] * 4)`` with the benchmark chain (FPN once),
   the FPN buffer and four steady buffers -- B1 once and B2 once per
   steady buffer on each shard, on the tensor cores -- against the
   single-device model (2e-4; the mean line 1e-4/1e-5; the transfers
   exactly the 55 296-byte FPN reduction), again with the noise lines over
   96 B-scans (two shards), and with FPN off (the max difference printed);
   the handheld preset with post background removal on
   ``make_mesh(2, 2, [cuda:0] * 4)`` (whole-row gathers for the flip and
   the sinusoidal correction, their bytes checked; the split cuts an FPN
   segment, so a mean-line bin that misses 1e-4/1e-5 is logged and both
   lines must lie within the float32 summation bound of the float64
   segment means); ``StreamingEngine``
   over the (4, 1) model from RAM on both wires (the recorded float32
   stream equal to ``process_buffer`` on the mesh, packed-12 equal to
   uint16, the engine's rate beside the single-device engine's); ``python
   -m octproz_tpu_torch.parallel.multihost --selftest --full`` as two
   processes of a gloo world on cuda:0 and as the one process of an NCCL
   world, each rank feeding its B-scan block and holding its fetched block
   to a single-device model, the FPN statistics in one all_reduce of
   55 296 bytes; the sharded step's ms per buffer beside the single-device
   step's;
10. bf16: ``compute_dtype="bfloat16"`` -- the bf16 route of the five
   one-pass families (B1/B2/B5/B7/B8: x rounded to nearest, one rounded
   bf16 operator part, one term) against its plain version on uint8,
   shifted and unshifted 12-bit, full 16-bit and float32 lines and the
   ragged shapes, the route read back per case, and two controls that must
   fail (x truncated, not rounded; the one-pass rung's three-part route);
   the five at 2048, 4096 and 4352 samples (the bulk of the wgmma chain's
   sums moved into bf16 hi parts in shared memory every 256 samples) on
   unshifted 12-bit and 24-bit float32 lines, with the ``make_curves``
   operators and a dense random operator;
   and B2/B5 at the edges of the one-term kernel's 128 x 128 tiles (1, 127,
   129 and 131073 lines; 64, 100, 128 and 550 bins), B7/B8 at the edges of
   its 128 x 256 prep tiles (1, 127, 129, 999 and 131073 lines; 64, 100,
   256, 1000, 1024, 1100 and 1001 columns), then
   ``default_full_config()`` at bf16 on full 1024 x 512 x 256 buffers
   through ``FdOctModel`` on the fold path, the concat path and the FFT
   path with and without dispersion, with the launch counts read around
   that run (every launch of the five families on the bf16 route, none on
   another), each steady output at full size against the float64 product
   of the rounded operands (the prep output against its plain version);
11. fidelity: the golden pair and the float64-oracle ladder on the fold,
   concat and FFT paths (bf16 at least at the default gate and 20 dB below
   the default rung; its golden pair recorded, not gated), the golden pair
   through the concat kernels (``fold_concat``, the buffer's steady-state
   output) at the default and the "high" rung, and the prep output of the
   phase and the real kernels against float64 per rung (default and
   "highest" at least 20 dB above "high");
12. trace: one ``utils.profiling.trace`` of ``StreamingEngine.run`` on the
   concat path at the default rung, uint16 wire, after a warm-up run: the
   device's busy time (the union of its kernels and copies), its idle share
   over the traced window, the top device operations and the longest idle
   gaps with the host operations that overlap them; a trace without CUDA
   events fails;
13. times: steady-state ms per buffer and MHz on both paths at every timed
   rung, bf16 included (the FFT path split into prep kernel, FFT and FPN
   plus scaling), and each kernel beside its plain version, the library
   call for its product (``bench.library_operands``) and its bound
   (``bench.kernel_bound``), and the one-pass families on float32 lines
   (``bench.F32_LINE_KERNELS``, 24-bit samples, off the main path)
   likewise, and both paths' steady state on 24-bit samples;
14. configurations: every configuration the CPU tests hold against the JAX
   package (``slice_configs()``, tests/test_torch_pipeline.py's
   ``SLICE_CONFIGS``: the rungs, FPN modes, the "xla" fold backend, the
   unfused scaling, bf16 stores, fast log, lin scaling, the post stages,
   the concat kernels, the FFT path through the prep kernels and through
   torch ops -- the resampling matrix, the gather resampler at every
   interpolation, background removal --, 8- to 32-bit samples, the window
   types, bf16 compute) and ``fold_k_split``, through ``FdOctModel`` on
   the card and on the CPU on the same 8-B-scan buffers of full-width lines
   (buffer 0, two steady buffers, a chunk with strategy "auto", for some a
   scan chunk): each card run's kernel families and routes checked, every
   output held to the CPU's within 1e-4 display units (a bf16 step more on
   a bf16 store) -- where it misses, the card's output held to the image of
   the float64 products instead, at most a 1e-5 share of its voxels past
   1e-4 and each of those within its float32 bound, the CPU's distance
   printed --, the FPN mean lines within rtol 1e-5; then the user-facing
   chains at full depth
   (``default_chains()``: ``ProcConfig()``'s torch-ops FFT chain,
   ``benchmark_config(tpu=False)`` with the gather resampler, the torch-ops
   chain at bf16, the fold path on the "xla" backend and unfused):
   buffer 0, steady buffers and ``process_volume``, each against the
   kernel route computing the same function on the card and on its first
   8 B-scans against the port on the CPU, with its ms per buffer, its
   FPN-determination buffer's ms and its stages, and the post stages' ms;
15. harnesses: the fidelity anchor (``fullgeom_fidelity.run``) at the full
   1024 x 512 x 256 geometry of the PhytoOCT device model -- the SNR bound
   derived from the float64 oracle on the 12-bit codes against the analog
   interferogram, within ``BOUND_MATCH_DB`` of ``bench.IN_BOUND_SNR_DB``;
   every rung's PSNR against the oracle with FPN off and on ("default" and
   "highest" at least ``FLOAT32_MARGIN_DB`` above the bound, "high" at
   least the bound, bf16 under it), each rung's run between a reset and a
   read of the launch counts (its family on its route: the steady-state
   kernel with FPN off, the FPN buffer's planar kernel with FPN on); the
   ``cli compare`` gate on the saved pair --, then the soak (``soak``'s
   upload-only, engine, upload-only windows of ``SOAK_WINDOW_S``, the
   feeder built alike in both kinds, its pinned slots allocated by the
   warm-up, none in a timed window) on the JAX soak's chain (bf16 compute and store,
   chunks of 8) on the packed-12 and the uint16 wire, ``SOAK_CYCLES``
   cycles each, and one cycle each of the FFT path with the prep kernel,
   of ``ProcConfig()``'s torch-ops FFT chain (no kernel) and of 24-bit
   samples in uint32 on the fold path: each engine window's launches one
   per chunk of its family on its route and nothing else, the
   engine's MHz, the upload-only MHz and their ratio logged, and each
   chain's streamed output held to ``process_buffer`` on the same buffers;
16. rates: the harnesses of the per-buffer latency, the chunked dispatch
   and the scaling sweep at full width -- ``latency.measure`` (the JAX
   harness's chain, one call and one sync per buffer) at bf16 and at the
   default rung, ``LATENCY_N`` buffers, its percentiles, mean and
   pipelined companion; ``bench.chunk_attempt`` for the scan and the
   batch at 4, 8, 16 and 32 at bf16 (the batch of 32 also with a bf16 store) and at
   8 at the default rung, beside the per-buffer steady ms and the scan's
   ``torch.stack`` copy alone, every buffer of the batches of 16 and 32
   held to the per-buffer step (atol 1e-5); ``scaling.run_scaling`` over
   1, 2 and 4 repeats of cuda:0, each mesh's output held to the single
   device, the traffic report (the FPN reduction 55 296 B on each of its
   three meshes, the compute time measured here), and one gloo-anchor
   pair; every in-process run between a reset and a read of the launch
   counts (B1 once per FPN buffer, B2 once per steady buffer or batch, on
   the route of the run's compute dtype).

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the kernels' JSON record (the bf16 routes as ``*_bf16``, the one pass on
float32 lines as ``*_f32lines`` with the 24-bit paths' launches), the one before
that nvidia-smi's name and power limit.  JAX is never imported: the oracle
comes from ``tests/oracle.py`` (numpy only).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "octproz_tpu_torch/kernels/csrc/"
PALLAS = "octproz_tpu/pallas/fused_prep.py:"
# family -> (source of the kernel the main path launches, Pallas kernel body
# it replaces); every family runs on the tensor cores: the fold families
# enter through fold_split.cu, the prep families through prep_split.cu
KERNELS = {
    "depth": ("fold_split.cu", 261),
    "depth_split": ("fold_split.cu", 271),
    "depth_scale": ("fold_split.cu", 375),
    "depth_scale_split": ("fold_split.cu", 422),
    "depth_scale_concat": ("fold_split.cu", 337),
    "depth_scale_concat_split": ("fold_split.cu", 354),
    "prep_phase": ("prep_split.cu", 228),
    "prep_phase_split": ("prep_split.cu", 245),
    "prep_real": ("prep_split.cu", 238),
    "prep_real_split": ("prep_split.cu", 254),
    # compute_dtype="bfloat16": the one-pass families' bf16 route, all five
    # on the persistent one-term kernel
    "depth_bf16": ("fold_bf16.cu", 261),
    "depth_scale_bf16": ("fold_bf16.cu", 375),
    "depth_scale_concat_bf16": ("fold_bf16.cu", 337),
    "prep_phase_bf16": ("prep_bf16.cu", 228),
    "prep_real_bf16": ("prep_bf16.cu", 238),
}
#: The one pass of the five one-pass families on float32 lines (samples
#: above 16 bits, ``bench.F32_LINE_KERNELS``): all five on the tensor cores
#: with three x parts; their launches are those of the 24-bit paths
#: (``phase_wide_samples``, and B1's of ``phase_continuous_fpn``).
F32_ROWS = {
    "depth_f32lines": ("fold_split.cu", 261),
    "depth_scale_f32lines": ("fold_split.cu", 375),
    "depth_scale_concat_f32lines": ("fold_split.cu", 337),
    "prep_phase_f32lines": ("prep_split.cu", 228),
    "prep_real_f32lines": ("prep_split.cu", 238),
}
#: The bf16 rows of KERNELS by their LAUNCHES family.
BF16_ROWS = {k[:-len("_bf16")]: k for k in KERNELS if k.endswith("_bf16")}
CONCAT = ("depth_scale_concat", "depth_scale_concat_split")
TWO_OPERATOR = ("depth_scale", "depth_scale_split")
FOLD = tuple(k for k in KERNELS if k.startswith("depth") and k not in CONCAT
             and k not in BF16_ROWS.values())
PREP = tuple(k for k in KERNELS if k.startswith("prep") and k not in BF16_ROWS.values())

# Kernel vs plain version on the card (both float32): the bounds of
# fused_prep.planar_error / scale_error / prep_error -- relative L2 <= 3e-6
# for planar fold output and <= 1e-6 for prep spectra; RMS <= 1e-6 and max
# <= 1e-4 display units above the display floor for a float32 store; one
# bf16 step more for a bf16 store -- each set between the float32
# reordering noise and the nearest wrong rung (readings in fused_prep.py).
# The controls at the end of phase 3 show on the card that a wrong rung
# fails them.
#
# Oracle rungs: the gates of bench.py are floors; "highest" must also clear
# "high" by RUNG_GAP_DB, since its operator carries ~24 bits against ~16
# (about 30 dB apart on an H100), so a 5-pass kernel that computed the
# 3-pass math would read as "high" and fail.  On the FFT path the float32
# FFT's own rounding caps "highest" at the default rung's level (135.1
# against 135.0 dB on an H100 at a 700 W limit; "high" 111.7 dB): the gap
# still holds end to end and is held there, and it is held again on the
# prep output before the FFT, where each rung keeps its own error budget
# (``_prep_snr_db``).
RUNG_GAP_DB = 20.0
#: Display floor (dB) of the one-pass kernel cases by sample kind: 20 log10 of
#: the samples' range over that of 8-bit values (12, 16, 24 and 32 bits; 16-bit
#: values as float32 lines).
ONE_PASS_FLOOR_DB = {"u16": 24.0, "u16f": 48.0, "f16": 48.0, "f32": 96.0, "f32w": 144.0}
#: The precision rungs the FFT path phase drives.
RUNGS = ("default", "high", "highest")
#: The bf16 rung (compute_dtype="bfloat16") must sit this far below the
#: default rung's oracle PSNR: a bf16 run that took a float32-grade route
#: would read as the default rung (bf16 operands carry 8 bits, about 2^-9
#: relative, against float32's 24).
BF16_GAP_DB = 20.0


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs one CUDA GPU")
    sys.path.insert(0, ROOT)
    from octproz_tpu_torch import bench

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true float32
    torch.backends.cudnn.allow_tf32 = False
    info = bench.device_info()
    log(f"[device] {info['device_name']} x{info['device_count']}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return info


def phase_build():
    """The CUDA kernels and the native host library (the acquisition ring),
    both before any producer thread starts."""
    from octproz_tpu_torch import native
    from octproz_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load()
    took = time.perf_counter() - t0
    lines = (build.library_path().parent / "build.log").read_text().splitlines()
    regs = [int(l.split("Used ")[1].split()[0]) for l in lines if "Used " in l]
    spills = [l.strip() for l in lines if "spill stores" in l
              and "0 bytes spill stores, 0 bytes spill loads" not in l]
    log(f"[build] {build.library_path()} in {took:.1f} s; {len(regs)} kernels, "
        f"max {max(regs) if regs else 'n/a'} registers; spills: {spills or 'none'}")
    t0 = time.perf_counter()
    if not native.native_available():
        raise AssertionError("the native host library (g++) did not build")
    log(f"[build] {native.library_path()} in {time.perf_counter() - t0:.1f} s")
    return took


def _raw(kind, lines, n_in, g, dev):
    """Random raw lines: "u16s" 12-bit samples shifted to 8 bits (as on the
    main path: x_lo = 0), "u16" 12 bits unshifted (x_lo != 0), "u16f" all 16
    bits, "u8", or "f32" / "f32w" / "f16" (a 24-bit / 32-bit / 16-bit source
    decoded before the kernel: float32 lines)."""
    import torch

    if kind == "f16":
        return torch.randint(0, 1 << 16, (lines, n_in), dtype=torch.int32,
                             generator=g, device=dev).to(torch.float32)
    if kind == "u16f":
        return torch.randint(-32768, 32768, (lines, n_in), dtype=torch.int16,
                             generator=g, device=dev).view(torch.uint16)
    if kind in ("u16", "u16s"):
        return torch.randint(0, 4096, (lines, n_in), dtype=torch.int16,
                             generator=g, device=dev).view(torch.uint16)
    if kind == "u8":
        return torch.randint(0, 256, (lines, n_in), dtype=torch.uint8,
                             generator=g, device=dev)
    if kind == "f32w":
        return torch.randint(0, 1 << 32, (lines, n_in), dtype=torch.int64,
                             generator=g, device=dev).to(torch.float32)
    return torch.randint(0, 1 << 24, (lines, n_in), dtype=torch.int32,
                         generator=g, device=dev).to(torch.float32)


def _compare(raw, wre, wim, bitshift, mode, odt, g, ref=None, floor_db=0.0):
    """The kernel on (raw, wre, wim) against the plain version on ``ref``
    (default the same inputs), log scaling over the 60 dB from ``floor_db``
    up; a one-pass scaled output against the float64 product of the same
    float32 operator (``_scale_check``).  Returns (max |err|, detail, within
    bounds)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    rraw, rre, rim = ref or (raw, wre, wim)
    if mode is None:
        got = fp.fold_depth(raw, wre, wim, bitshift=bitshift)
        want = fp.depth_plain(rraw, rre, rim, bitshift=bitshift)
        err = fp.planar_error(got, want)
        worst = max(float((a - b).abs().max()) for a, b in zip(got, want))
        return worst, (f"rel L2 {err:.3e} (bound {fp.PLANAR_REL_L2:g}), "
                       f"max|err| {worst:.3e}"), err <= fp.PLANAR_REL_L2
    half = wre[0].shape[1]
    mean2 = torch.randn((2, half), generator=g, device=raw.device) * 50.0
    lo = 0.0 if mode == "lin" else floor_db
    a, b = fp._scale_affine(mode != "lin", half, lo, lo + 60.0, 0.0, 1.0)
    kw = dict(bitshift=bitshift, log_scaling=mode != "lin", a=a, b=b,
              fast_log=mode == "fast_log", out_dtype=odt)
    got = fp.fold_depth_scale(raw, wre, wim, mean2, **kw)
    want = fp.depth_scale_plain(rraw, rre, rim, mean2, **kw)
    exact = None
    if len(rre) == 1 and rre[0].dtype == torch.float32:  # the one pass
        exact = fp.depth_scale_f64(rraw, rre, rim, mean2, bitshift=bitshift,
                                   log_scaling=mode != "lin", a=a, b=b,
                                   fast_log=mode == "fast_log")
    return _scale_check(got, want, odt, exact)


def _scale_check(got, want, odt, exact=None):
    """A scaled kernel output within the scale bounds: against ``exact``
    where it is given -- at the one pass, the image of the float64 products
    of the same float32 operator (``fused_prep.depth_scale_f64``), from
    which the float32 plain version ``want`` drifts on long lines
    (``diagnose.plain_drift``: up to 1.07e-4 on float32 lines at n_in >=
    1664, the kernel within 1e-5), its own distance printed beside -- else
    against ``want``.  Returns (max |err|, detail, within the bounds)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    bound = (f"{fp.SCALE_MAX:g} + bf16 step" if odt == torch.bfloat16
             else f"RMS {fp.SCALE_RMS:g}, max {fp.SCALE_MAX:g}")
    if exact is None:
        rms, worst, ok = fp.scale_error(got, want)
        return worst, (f"above the display floor RMS {rms:.3e}, max {worst:.3e} "
                       f"(bound {bound})"), ok
    rms, worst, ok = fp.scale_error(got, exact)
    rms_p, worst_p, _ = fp.scale_error(want, exact)
    return worst, (f"against the float64 product above the display floor RMS {rms:.3e}, "
                   f"max {worst:.3e} (bound {bound}; the float32 plain version RMS "
                   f"{rms_p:.3e}, max {worst_p:.3e})"), ok


def phase_kernels():
    """Each family at rungs 1/3/5 -- with x_lo terms zero (shifted 12-bit
    samples, as on the main path) and nonzero (unshifted 12-bit, full 16-bit
    and float inputs) --, fast_log, lin, float32 and bf16 stores,
    uint8/uint16/float inputs, an odd line count and n_in = 1664; the
    one-pass rung's route is read back after each of its cases
    (``_route_read_back``); then the controls, which must fail."""
    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch import curves as curves_mod
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.params import AcqParams

    dev = torch.device("cuda", 0)
    f32, bf16 = torch.float32, torch.bfloat16
    # max |err| at the main path's inputs (the float32-line rows: at n_in =
    # 1024 on 24-bit samples)
    worst = {k: 0.0 for k in (*KERNELS, *F32_ROWS)}
    cases = [
        # (n_in, lines, input, passes, scale mode or None, out dtype)
        (1024, 4096, "u16s", 1, None, None),
        (1024, 4096, "u16s", 3, None, None),
        (1024, 4096, "u16s", 5, None, None),
        (1024, 4096, "u16", 3, None, None),
        (1024, 4096, "u16", 5, None, None),
        (1024, 4096, "u16s", 1, "log", f32),
        (1024, 4096, "u16s", 3, "log", f32),
        (1024, 4096, "u16s", 5, "log", f32),
        (1024, 4096, "u16", 3, "log", f32),
        (1024, 4096, "u16", 5, "log", f32),
        (1024, 4096, "u16s", 1, "fast_log", f32),
        (1024, 4096, "u16s", 1, "lin", f32),
        (1024, 4096, "u16s", 1, "log", bf16),
        (1024, 4096, "u16s", 3, "log", bf16),
        (1024, 4133, "u16s", 1, None, None),
        (1024, 4133, "u16s", 3, "log", f32),
        (1664, 1000, "u16s", 3, None, None),
        (1664, 1000, "u16", 5, None, None),
        (1664, 1000, "u16s", 1, "log", f32),
        (1024, 2048, "u8", 1, "log", f32),
        (1024, 2048, "f32", 5, None, None),
        (1024, 2048, "f32", 3, "log", f32),
        # the split kernels' ragged edges: 550 bins (1100 samples) and 4133
        # lines against their 64-bin and 128-line tiles; uint8 input
        (1100, 999, "u16", 3, None, None),
        (1100, 999, "u16s", 3, "log", f32),
        (1100, 999, "u16", 5, "log", f32),
        (1024, 4133, "u16s", 3, None, None),
        (1024, 2048, "u8", 3, None, None),
        (1024, 2048, "u8", 3, "log", f32),
    ]
    ops = {}
    # 1088: the concat cases; 128, 200, 256: the one-term kernel's narrow cases;
    # 1000, 1001, 2048, 4096: the float32-line cases
    for n_in in sorted({c[0] for c in cases} | {1088, 128, 200, 256, 1000, 1001, 2048, 4096}):
        acq = AcqParams(samples_per_line=n_in, ascans_per_bscan=8, bscans_per_buffer=1)
        cv = curves_mod.make_curves(acq, bench.bench_config(), **{
            **bench.CURVE_KW, "resample_coeffs": (0.0, n_in - 1.0, 20.0, -10.0)}, device=dev)
        ops[n_in] = (cv.depth_op_re, cv.depth_op_im)

    def parts(n_in, precision):
        return tuple(fp._operator_parts(w, precision) for w in ops[n_in])

    g = torch.Generator(device=dev)
    g.manual_seed(3)
    _fold_cases(cases, parts, worst, g, dev)

    # Controls: a kernel that computed a neighbouring rung must fail.
    raw = _raw("u16", 4096, 1024, g, dev)
    p5, p3 = parts(1024, "highest"), parts(1024, "high")
    x_hi = fp._bf16_trunc(raw.to(torch.float32))
    controls = [
        ("3-pass kernel on the highest parts", (raw, p5[0][:2], p5[1][:2]), (raw, *p5)),
        ("3-pass kernel without x_lo (x_hi input)", (x_hi, *p3), (raw, *p3)),
    ]
    _fold_controls(controls, g)
    _concat_kernel_cases(worst, ops, g, dev)
    _prep_kernel_cases(worst, g, dev)
    _one_pass_kernel_cases(worst, parts, dev)
    _bf16_kernel_cases(worst, parts, ops, dev)
    _bf16_scale_edge_cases(worst, parts, ops, dev)
    _bf16_prep_edge_cases(worst, dev)
    return worst


#: A case's passes -> its rung: the C entries' passes argument, 0 for the
#: bf16 route (``compute_dtype="bfloat16"``).
RUNG_OF_PASSES = {0: "bfloat16", 1: "default", 3: "high", 5: "highest"}


def _row(family, passes):
    """The LAUNCHES family's row in KERNELS / ``worst`` at ``passes``."""
    return family + ("_bf16" if passes == 0 else "")


def _fold_cases(cases, parts, worst, g, dev):
    """Each (n_in, lines, input, passes, scale mode or None, out dtype) of
    the two-operator fold kernels against its plain version; a one-pass
    case's route is read back and must follow its input type (at passes 0,
    the bf16 route, on every input type)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    f32 = torch.float32
    for n_in, lines, kind, passes, mode, odt in cases:
        raw = _raw(kind, lines, n_in, g, dev)
        fp.reset_launch_counts()
        # At one pass (and at bf16) the plain version is a float32 product
        # of its own, so both sides carry their rounding, and log10
        # amplifies it without bound in the nulls: the display floor stays
        # 36 dB under the mean level of the samples, where 8-bit values
        # have it at 0 dB.
        floor_db = ONE_PASS_FLOOR_DB.get(kind, 0.0) if passes <= 1 else 0.0
        err, detail, ok = _compare(raw, *parts(n_in, RUNG_OF_PASSES[passes]), kind == "u16s",
                                   mode, odt, g, floor_db=floor_db)
        torch.cuda.synchronize()
        family = ("depth" if mode is None else "depth_scale") + ("_split" if passes > 1 else "")
        row = _row(family, passes)
        if n_in == 1024 and kind == "u16s" and odt in (None, f32):
            worst[row] = max(worst[row], err)  # the main path's inputs
        if n_in == 1024 and kind == "f32" and passes == 1 and odt in (None, f32):
            worst[family + "_f32lines"] = max(worst[family + "_f32lines"], err)
        route = _route_read_back(family, kind, bf16=passes == 0) if passes <= 1 else ""
        log(f"[kernels] {row:<17} n_in={n_in} lines={lines} {kind} passes={passes} "
            f"{mode or 'planar'} {str(odt).replace('torch.', '') if odt else ''}{route}: "
            f"{detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{row} kernel disagrees with its plain version")


def _route_read_back(family, kind, bf16=False):
    """The one-pass route of the last launch against the route it must
    take: at float32 compute the tensor cores on every input type (float32
    lines with three x parts), at bf16 compute (``bf16``) the bf16 route.
    The launch counts were reset before that one launch."""
    from octproz_tpu_torch.kernels import fused_prep as fp

    want = "tensor_core_bf16" if bf16 else "tensor_core"
    if fp.ONE_PASS_ROUTES[family] != {**dict.fromkeys(fp.ONE_PASS_ROUTES[family], 0), want: 1}:
        raise AssertionError(f"{family} on {kind} lines took the routes "
                             f"{fp.ONE_PASS_ROUTES[family]}, want {want}")
    return f" [route: {want}]"


def _fold_controls(controls, g, floor_db=0.0):
    """Each (name, kernel inputs, plain inputs): a kernel computing a
    neighbouring rung must fail the bounds, planar and scaled (display floor
    at ``floor_db``)."""
    import torch

    for name, kernel_in, plain_in in controls:
        for mode in (None, "log"):
            _, detail, ok = _compare(*kernel_in, False, mode, torch.float32, g, ref=plain_in,
                                     floor_db=floor_db)
            torch.cuda.synchronize()
            log(f"[kernels] control: {name}, {mode or 'planar'}: {detail} -> "
                f"{'passes (BAD)' if ok else 'fails, as it must'}")
            if ok:
                raise AssertionError(f"control {name!r} passed: the bounds do "
                                     f"not separate the rungs")


def _one_pass_kernel_cases(worst, parts, dev):
    """The one-pass rung of the two-operator fold kernels beyond the main
    path's inputs, on data of its own generator: on the tensor cores with
    x_lo nonzero (unshifted 12-bit and full 16-bit samples: five terms),
    uint8, every scale mode and store, n_in = 1664 and the ragged shapes;
    float32 lines (24- and 32-bit samples and 16-bit values, n_in 1000 to
    4096, 999 and 131073 lines): the planar and the scaled kernel on the
    tensor cores with three x parts; then its controls, which must fail
    against the float32 product: the "high" parts (two of its three, the
    third zeroed) through its entry, its three-part math without x_lo (x_hi
    as uint16 samples), and on float32 lines of 24 and 32 bits the
    three-x-part kernel without x_lo (x_hi + x_mid as its input)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # lin on 8-bit values: its bounds are absolute display units
        (1024, 4096, "u16", 1, None, None),
        (1024, 4096, "u16f", 1, None, None),
        (1024, 4096, "u16", 1, "log", f32),
        (1024, 4096, "u16f", 1, "log", f32),
        (1024, 4096, "u16", 1, "fast_log", f32),
        (1024, 4096, "u8", 1, "lin", f32),
        (1024, 4096, "u16", 1, "log", bf16),
        (1024, 2048, "u8", 1, None, None),
        (1024, 4133, "u16f", 1, None, None),
        (1664, 1000, "u16", 1, None, None),
        (1100, 999, "u16", 1, None, None),
        (1100, 999, "u16s", 1, "log", f32),
        (1100, 999, "u8", 1, "lin", f32),
        # float32 lines at one pass, the planar and the scaled kernel on the
        # tensor cores with three x parts -- 24- and 32-bit samples, the main
        # path's n_in and longer lines, a partial 128-line tile (999) and one
        # more line than a full buffer
        (1024, 2048, "f32", 1, None, None),
        (1024, 2048, "f32", 1, "log", f32),
        (1024, 4096, "f32w", 1, "log", f32),
        (1024, 999, "f32", 1, "fast_log", f32),
        (1024, 999, "f32w", 1, "log", bf16),
        (1664, 999, "f32", 1, "log", f32),
        (2048, 999, "f32w", 1, "log", f32),
        (4096, 999, "f32", 1, "log", f32),
        (4096, 2048, "f32w", 1, None, None),
        (1024, 131073, "f32", 1, "log", f32),
        # rows of 1001 float32 samples are not 16-byte aligned: the
        # element-wise producer writes the raw tile as TMA would
        (1001, 999, "f32", 1, "log", f32),
    ]
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    _fold_cases(cases, parts, worst, g, dev)
    # the planar kernel on float32 lines beyond the cases above, on a
    # generator of its own (the cases above keep their data): 32-bit samples
    # and 16-bit values (no x_lo), n_in up to 4096, 999 and 131073 lines,
    # and the element-wise producer -- rows of 1001 samples not 16-byte
    # aligned, and at n_in 1000 an operator row pitch (half = 500) that is
    # no multiple of 8
    g_planar = torch.Generator(device=dev)
    g_planar.manual_seed(19)
    _fold_cases([
        (1024, 4096, "f32w", 1, None, None),
        (1024, 4096, "f16", 1, None, None),
        (1024, 4096, "f16", 1, "log", f32),
        (1664, 999, "f32", 1, None, None),
        (2048, 999, "f32w", 1, None, None),
        (4096, 999, "f32", 1, None, None),
        (1024, 131073, "f32", 1, None, None),
        (1001, 999, "f32w", 1, None, None),
        (1000, 999, "f32", 1, None, None),
        (1000, 999, "f32w", 1, "log", f32),
    ], parts, worst, g_planar, dev)
    raw = _raw("u16", 4096, 1024, g, dev)
    p1 = parts(1024, "default")
    two = tuple(fp.OnePass(w[0], split=(*w.split[:2], torch.zeros_like(w.split[2])))
                for w in p1)
    x_hi16 = fp._bf16_trunc(raw.to(f32)).to(torch.int16).view(torch.uint16)
    _fold_controls([
        ("one-pass kernel on two of its three parts", (raw, *two), (raw, *p1)),
        ("one-pass kernel without x_lo (x_hi input)", (x_hi16, *p1), (raw, *p1)),
    ], g, floor_db=ONE_PASS_FLOOR_DB["u16"])
    # float32 lines: the three-x-part kernel without x_lo w_0 (five terms:
    # x cut to its 16 leading bits, x_hi + x_mid) must fail, planar and
    # scaled, on 24- and 32-bit samples
    for kind in ("f32", "f32w"):
        wide = _raw(kind, 4096, 1024, g, dev)
        _fold_controls([(f"three-x-part kernel without x_lo (x_hi + x_mid input, {kind})",
                         (_without_x_lo(wide), *p1), (wide, *p1))],
                       g, floor_db=ONE_PASS_FLOOR_DB[kind])


def _without_x_lo(x):
    """Float32 lines cut to x_hi + x_mid, their 16 leading significant bits:
    what the three-x-part kernel sums without its x_lo w_0 term."""
    from octproz_tpu_torch.kernels import fused_prep as fp

    hi = fp._bf16_trunc(x)
    return hi + fp._bf16_trunc(x - hi)


def _bf16_kernel_cases(worst, parts, ops, dev):
    """The bf16 route (passes 0: ``compute_dtype="bfloat16"``) of the five
    one-pass families -- B1/B2 (two operators), B5 (concat), B7/B8 (prep)
    -- against the plain versions on the same rounded operands, on uint8,
    shifted and unshifted 12-bit, full 16-bit and float32 lines, every
    scale mode and store, the ragged shapes (n_in 1088: a half-empty last
    tile; 1100: for B5 half % 8 != 0, the element-wise producer), the route
    read back per case; on a generator of their own.  Then two controls,
    which must fail against the bf16 plain version on unshifted 12-bit
    samples (shifted ones have at most 8 significant bits and are exact in
    bf16, so rounding and truncation agree there): the kernel fed x
    truncated to bf16 (the x_hi of the split rungs) in place of x rounded
    to nearest, and the one-pass rung's three-part route."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    _fold_cases([
        (1024, 4096, "u16s", 0, None, None),
        (1024, 4096, "u16", 0, None, None),
        (1024, 4096, "u16f", 0, None, None),
        (1024, 2048, "u8", 0, None, None),
        (1024, 2048, "f32", 0, None, None),
        (1024, 4133, "u16s", 0, None, None),
        (1664, 1000, "u16", 0, None, None),
        (1100, 999, "u16", 0, None, None),
        (1024, 4096, "u16s", 0, "log", f32),
        (1024, 4096, "u16", 0, "log", f32),
        (1024, 4096, "u16f", 0, "log", f32),
        (1024, 4096, "u16s", 0, "fast_log", f32),
        (1024, 4096, "u16", 0, "fast_log", f32),
        (1024, 4096, "u16s", 0, "lin", f32),
        (1024, 4096, "u16s", 0, "log", bf16),
        (1024, 2048, "u8", 0, "lin", f32),
        (1024, 2048, "f32", 0, "log", f32),
        (1100, 999, "u16s", 0, "log", f32),
        (1024, 4133, "u16", 0, "log", f32),
    ], parts, worst, g, dev)
    _concat_cases([
        (1024, 4096, "u16s", 0, True, f32),
        (1024, 4096, "u16", 0, True, f32),
        (1024, 4096, "u16f", 0, True, f32),
        (1024, 4096, "u16s", 0, False, f32),
        (1024, 4096, "u16s", 0, True, bf16),
        (1024, 2048, "u8", 0, True, f32),
        (1024, 2048, "f32", 0, True, f32),
        (1024, 4133, "u16s", 0, True, f32),
        (1088, 999, "u16", 0, True, f32),
        (1100, 999, "u16", 0, True, f32),
        (1100, 999, "f32", 0, True, f32),
    ], ops, worst, g, dev)
    prep_cases = [(n, lines, kind, 0, epi, bg) for epi in ("phase", "real")
                  for n, lines, kind, bg in ((1024, 4096, "u16s", False), (1024, 4096, "u16", False),
                                             (1024, 4096, "u16f", True), (1024, 2048, "u8", False),
                                             (1024, 2048, "f32", False), (1088, 999, "u16", False),
                                             (1100, 999, "u16", True), (1024, 4133, "u16s", False))]
    prep_ops = {(n, bg): _prep_operators(n, bg, dev) for n, bg in {(c[0], c[5]) for c in prep_cases}}
    _prep_cases(prep_cases, prep_ops, worst, g, dev)

    raw = _raw("u16", 4096, 1024, g, dev)
    x_trunc = fp._bf16_trunc(raw.to(f32)).to(torch.int16).view(torch.uint16)
    pb, p1 = parts(1024, fp.BF16), parts(1024, "default")
    _fold_controls([
        ("bf16 kernel fed truncated x", (x_trunc, *pb), (raw, *pb)),
        ("the three-part one-pass route in place of bf16", (raw, *p1), (raw, *pb)),
    ], g, floor_db=ONE_PASS_FLOOR_DB["u16"])
    wb, w1 = (fp.concat_operator(*ops[1024], r) for r in (fp.BF16, "default"))
    _concat_controls([
        ("bf16 concat kernel fed truncated x", (x_trunc, wb), (raw, wb)),
        ("the three-part one-pass concat route in place of bf16", (raw, w1), (raw, wb)),
    ], g, floor_db=ONE_PASS_FLOOR_DB["u16"])
    op, rows = prep_ops[(1024, False)]
    qb, q1 = fp._operator_parts(op, fp.BF16), fp._operator_parts(op, "default")
    for epi, epi_rows in (("phase", rows), ("real", None)):
        for name, kernel_in in ((f"bf16 {epi} kernel fed truncated x", (x_trunc, qb)),
                                (f"the three-part one-pass {epi} route in place of bf16",
                                 (raw, q1))):
            _, detail, ok = _compare_prep(*kernel_in, epi_rows, False, ref=(raw, qb))
            torch.cuda.synchronize()
            log(f"[kernels] control: {name}: {detail} -> "
                f"{'passes (BAD)' if ok else 'fails, as it must'}")
            if ok:
                raise AssertionError(f"control {name!r} passed: the prep bound does not "
                                     f"catch it")
    _bf16_long_chain_cases(dev)


#: n_in of the bf16 long-line cases: past every family's fold period
BF16_LONG_WIDTHS = (2048, 4096, 4352)


def _bf16_long_chain_cases(dev):
    """The five families at bf16 on lines longer than the one-term kernel's
    fold period (ROADMAP F1: one wgmma chain over n_in read up to 4.5e-6
    against the prep bound of 1e-6 and 5.6e-6 against the planar 3e-6):
    ``BF16_LONG_WIDTHS`` samples on 999 lines of unshifted 12-bit and 24-bit
    float32 samples, with the ``make_curves`` operators (the prep ones with
    and without background removal) and a dense random operator (n_in
    terms of random sign in every sum, a random phasor), B1 planar, B2 log
    and fast log, B5 log, B7 and B8, each against its plain version at the
    unchanged bounds (the scaled images' max against the float64 image,
    ``_compare_scale_exact``) with the route read back; on a generator of
    their own."""
    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch import curves as curves_mod
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.params import AcqParams

    f32 = torch.float32
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    for n in BF16_LONG_WIDTHS:
        acq = AcqParams(samples_per_line=n, ascans_per_bscan=8, bscans_per_buffer=1)
        cv = curves_mod.make_curves(acq, bench.bench_config(), **{
            **bench.CURVE_KW, "resample_coeffs": (0.0, n - 1.0, 20.0, -10.0)}, device=dev)
        angle = torch.rand(n, generator=g, device=dev) * 6.283185307179586
        dense = lambda cols: torch.randn((n, cols), generator=g, device=dev).div(64.0)  # noqa
        fold_ops = {"curves": (cv.depth_op_re, cv.depth_op_im),
                    "dense random": (dense(n // 2), dense(n // 2))}
        prep_ops = {"curves": _prep_operators(n, False, dev),
                    "curves, background": _prep_operators(n, True, dev),
                    "dense random": (dense(n), (torch.cos(angle), torch.sin(angle)))}
        for kind in ("u16", "f32"):
            floor = ONE_PASS_FLOOR_DB[kind]
            raw = _raw(kind, 999, n, g, dev)
            for ops, (w_re, w_im) in fold_ops.items():
                bf = tuple(fp._operator_parts(w, fp.BF16) for w in (w_re, w_im))
                wide = fp.concat_operator(w_re, w_im, fp.BF16)
                runs = [("depth", "planar",
                         lambda: _compare(raw, *bf, False, None, None, g))]
                runs += [("depth_scale", mode,
                          lambda mode=mode: _compare_scale_exact(raw, bf, mode, g, floor))
                         for mode in ("log", "fast_log")]
                runs.append(("depth_scale_concat", "log",
                             lambda: _compare_scale_exact(raw, bf, "log", g, floor, wide)))
                _long_chain_runs(runs, n, kind, ops)
            for ops, (op, rows) in prep_ops.items():
                parts = fp._operator_parts(op, fp.BF16)
                _long_chain_runs([(f"prep_{epi}", epi,
                                   lambda r=r: _compare_prep(raw, parts, r, False))
                                  for epi, r in (("phase", rows), ("real", None))], n, kind, ops)


def _compare_scale_exact(raw, bf, mode, g, floor_db, wide=None):
    """B2 (or with ``wide`` B5) at bf16 on long lines, log scaling over the
    60 dB from ``floor_db`` (fast log with ``mode`` "fast_log"): the image
    against the image of the float64 products of the same rounded operands
    (``fused_prep.depth_scale_f64``) within the scale bounds, and against
    the plain version within the RMS bound -- the plain version's own
    float32 products reach the max bound in the deepest shown voxels from
    4096 samples on.  Returns (max |err|, detail, within the bounds)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    half = bf[0][0].shape[1]
    mean2 = torch.randn((2, half), generator=g, device=raw.device) * 50.0
    a, b = fp._scale_affine(True, half, floor_db, floor_db + 60.0, 0.0, 1.0)
    kw = dict(bitshift=False, log_scaling=True, a=a, b=b)
    fast = mode == "fast_log"
    exact = fp.depth_scale_f64(raw, *bf, mean2, fast_log=fast, **kw)
    if wide is None:
        got = fp.fold_depth_scale(raw, *bf, mean2, fast_log=fast, **kw)
        want = fp.depth_scale_plain(raw, *bf, mean2, fast_log=fast, **kw)
    else:
        got = fp.fold_depth_scale_concat(raw, wide, mean2, **kw)
        want = fp.depth_scale_concat_plain(raw, wide, mean2, **kw)
    rms, worst, ok = fp.scale_error(got, exact)
    rms_p, worst_p, _ = fp.scale_error(got, want)
    return worst, (f"against the float64 image RMS {rms:.3e}, max {worst:.3e} (bound RMS "
                   f"{fp.SCALE_RMS:g}, max {fp.SCALE_MAX:g}); against the plain version RMS "
                   f"{rms_p:.3e}, max {worst_p:.3e}"), ok and rms_p <= fp.SCALE_RMS


def _long_chain_runs(runs, n, kind, ops):
    """Each (family, what, run) of ``_bf16_long_chain_cases``: the launch
    counts reset before the run, its route read back after it."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    for family, what, run in runs:
        fp.reset_launch_counts()
        _, detail, ok = run()
        torch.cuda.synchronize()
        route = _route_read_back(family, kind, bf16=True)
        log(f"[kernels] {_row(family, 0):<24} n_in={n} lines=999 {kind} {ops} {what}{route}: "
            f"{detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{_row(family, 0)} kernel disagrees with its plain version "
                                 f"at n_in={n} ({kind}, {ops}, {what})")


def _bf16_scale_edge_cases(worst, parts, ops, dev):
    """B2 and B5 at bf16 (the persistent one-term kernel of
    ``fold_bf16.cu``, 128 x 128 tiles) at the edges of its tiling, on a
    generator of their own: one line, 127 and 129 lines, a main-path buffer
    and one line more (131073), 64 bins (one box of a tile's two), 100 bins
    (the element-wise producer: a row pitch that is not a multiple of 8),
    128 and 550 bins, with every scale mode and store."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    _fold_cases([
        (1024, 1, "u16s", 0, "log", f32),
        (1024, 127, "u16s", 0, "log", f32),
        (1024, 129, "u16", 0, "log", f32),
        (1024, 131073, "u16s", 0, "log", f32),
        (128, 999, "u16s", 0, "log", f32),
        (200, 999, "u16s", 0, "log", bf16),
        (256, 999, "u8", 0, "lin", f32),
        (1100, 129, "u16", 0, "fast_log", f32),
        (200, 127, "f32", 0, "log", f32),
    ], parts, worst, g, dev)
    _concat_cases([
        (1024, 131073, "u16s", 0, True, f32),
        (128, 999, "u16s", 0, True, f32),
        (200, 999, "u16s", 0, True, f32),
        (256, 127, "u16", 0, True, bf16),
        (256, 1, "u8", 0, False, f32),
    ], ops, worst, g, dev)


def _bf16_prep_edge_cases(worst, dev):
    """B7 and B8 at bf16 (the one-term kernel of ``prep_bf16.cu``, 128 x 256
    tiles) at the edges of its tiling, on a generator of their own: one
    line, 127, 129 and 999 lines, a main-path buffer and one line more
    (131073 x 1024), 64 columns (one box of a tile's four), 100 and 1100
    (the element-wise producer: a row pitch that is not a multiple of 8),
    256 (one whole tile), 1000 (a last tile of four partly filled boxes) and
    1001 (odd: the column-by-column stores), on every input type, with and
    without background removal."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(13)
    cases = [(n, lines, kind, 0, epi, bg) for epi in ("phase", "real")
             for n, lines, kind, bg in ((1024, 1, "u16s", False), (1024, 127, "u16", True),
                                        (1024, 129, "u8", False), (1024, 131073, "u16s", False),
                                        (64, 999, "u16s", False), (100, 129, "u16", True),
                                        (256, 999, "f32", False), (1000, 127, "u16s", True),
                                        (1000, 999, "u16f", False), (1100, 999, "u16s", False),
                                        (1001, 129, "u16", False), (1001, 999, "u8", True))]
    ops = {(n, bg): _prep_operators(n, bg, dev) for n, bg in {(c[0], c[5]) for c in cases}}
    _prep_cases(cases, ops, worst, g, dev)


def _compare_concat(raw, wide, bitshift, log_scaling, odt, g, ref=None, floor_db=0.0):
    """A concat kernel on (raw, wide parts) against its plain version on
    ``ref`` (default the same inputs), log scaling over the 60 dB from
    ``floor_db`` up; at the one pass against the float64 product of the same
    float32 operator (``_scale_check``).  Returns (max |err|, detail, within
    the bounds)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    rraw, rwide = ref or (raw, wide)
    half = wide[0].shape[1] // 2
    mean2 = torch.randn((2, half), generator=g, device=raw.device) * 50.0
    lo = floor_db if log_scaling else 0.0
    a, b = fp._scale_affine(log_scaling, half, lo, lo + 60.0, 0.0, 1.0)
    kw = dict(bitshift=bitshift, log_scaling=log_scaling, a=a, b=b, out_dtype=odt)
    got = fp.fold_depth_scale_concat(raw, wide, mean2, **kw)
    want = fp.depth_scale_concat_plain(rraw, rwide, mean2, **kw)
    exact = None
    if len(rwide) == 1 and rwide[0].dtype == torch.float32:  # the one pass
        w = rwide[0]
        exact = fp.depth_scale_f64(rraw, (w[:, :half],), (w[:, half:],), mean2,
                                   bitshift=bitshift, log_scaling=log_scaling, a=a, b=b)
    return _scale_check(got, want, odt, exact)


def _concat_kernel_cases(worst, ops, g, dev):
    """The concat fold families (B5/B6) on the two-operator families' grid
    -- rungs 1/3/5 with x_lo zero and nonzero, log and lin, float32 and
    bf16 stores, uint8/uint16/float inputs, an odd line count, n_in = 1664
    --, the split rung's own ragged shapes (n_in = 1088 and 1100), then the
    controls, which must fail: the wrong rung, and the im half read one
    column early at one and at three passes (swapping re and im would not
    do: p is symmetric in them)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # (n_in, lines, input, passes, log scaling, out dtype)
        (1024, 4096, "u16s", 1, True, f32),
        (1024, 4096, "u16s", 3, True, f32),
        (1024, 4096, "u16s", 5, True, f32),
        (1024, 4096, "u16", 3, True, f32),
        (1024, 4096, "u16", 5, True, f32),
        (1024, 4096, "u16s", 1, False, f32),
        (1024, 4096, "u16", 3, False, f32),
        (1024, 4096, "u16s", 1, True, bf16),
        (1024, 4096, "u16s", 3, True, bf16),
        (1024, 4133, "u16s", 1, True, f32),
        (1024, 4133, "u16s", 3, True, f32),
        (1664, 1000, "u16s", 1, True, f32),
        (1664, 1000, "u16", 5, True, f32),
        (1024, 2048, "u8", 1, True, f32),
        (1024, 2048, "f32", 3, True, f32),
        (1024, 2048, "f32", 5, True, f32),
    ]
    _concat_cases(cases, ops, worst, g, dev)
    # The split rung on the tensor-core pipeline, which reads each wide part
    # as two views at row pitch 2 * half: 544 bins (a half-empty last 64-bin
    # tile), 550 bins (the im view not 16-byte aligned: the element-wise
    # producer), uint8, a bf16 store at 5 passes; on a generator of their
    # own, so the cases after them keep their data.
    g_split = torch.Generator(device=dev)
    g_split.manual_seed(7)
    _concat_cases([
        (1088, 999, "u16", 3, True, f32),
        (1088, 4133, "u16s", 3, True, f32),
        (1100, 999, "u16", 3, True, f32),
        (1100, 999, "u16s", 5, False, f32),
        (1024, 2048, "u8", 3, True, f32),
        (1024, 4096, "u16s", 5, True, bf16),
    ], ops, worst, g_split, dev)

    raw = _raw("u16", 4096, 1024, g, dev)
    p5, p3 = (fp.concat_operator(*ops[1024], r) for r in ("highest", "high"))
    one = fp.concat_operator(*ops[1024], "default")
    w1 = one[0]
    half = w1.shape[1] // 2

    def im_early(w):  # the im column of bin j at half - 1 + j
        return torch.cat([w[:, :half + 1], w[:, half:-1]], dim=1).contiguous()

    x_hi = fp._bf16_trunc(raw.to(torch.float32))
    controls = [
        ("3-pass concat kernel on the highest parts", (raw, p5[:2]), (raw, p5)),
        ("3-pass concat kernel without x_lo (x_hi input)", (x_hi, p3), (raw, p3)),
        ("one-pass concat kernel reading im at column half - 1 + j", (raw, (im_early(w1),)),
         (raw, (w1,))),
        ("3-pass concat kernel reading im at column half - 1 + j",
         (raw, tuple(im_early(w) for w in p3)), (raw, p3)),
    ]
    _concat_controls(controls, g)

    # The one pass beyond the main path's inputs: unshifted 12-bit and full
    # 16-bit samples (x_lo terms), 544 bins (a half-empty last tile) and 550
    # (each view's three parts read element by element), lin on 8-bit
    # values; float32 lines with three x parts -- 24- and 32-bit samples,
    # longer lines, a partial 128-line tile (999) and one more line than a
    # full buffer, 1000 samples (half = 500: the im views not 16-byte
    # aligned, so the element-wise producer writes the operator tiles and
    # the raw tile's swizzled boxes) and 1001 (rows not 16-byte aligned) --
    # on a generator of their own, with the display floor of their samples'
    # range; then the one pass's own controls against the float32 product.
    g_one = torch.Generator(device=dev)
    g_one.manual_seed(9)
    _concat_cases([
        (1024, 4096, "u16", 1, True, f32),
        (1024, 4096, "u16f", 1, True, f32),
        (1024, 4096, "u16", 1, True, bf16),
        (1088, 999, "u16", 1, True, f32),
        (1088, 4133, "u16s", 1, True, f32),
        (1100, 999, "u16", 1, True, f32),
        (1100, 999, "u16s", 1, False, f32),
        (1100, 999, "u8", 1, False, f32),
        (1024, 2048, "f32", 1, True, f32),
        (1100, 999, "f32", 1, True, f32),
        (1024, 4096, "f32w", 1, True, f32),
        (1024, 999, "f32w", 1, True, bf16),
        (2048, 999, "f32", 1, True, f32),
        (4096, 999, "f32w", 1, True, f32),
        (1024, 131073, "f32", 1, True, f32),
        (1000, 999, "f32", 1, True, f32),
        (1000, 999, "f32w", 1, True, f32),
        (1001, 999, "f32", 1, True, f32),
    ], ops, worst, g_one, dev)
    raw = _raw("u16", 4096, 1024, g_one, dev)
    two = fp.OnePass(w1, split=(*one.split[:2], torch.zeros_like(one.split[2])))
    x_hi16 = fp._bf16_trunc(raw.to(f32)).to(torch.int16).view(torch.uint16)
    _concat_controls([
        ("one-pass concat kernel on two of its three parts", (raw, two), (raw, one)),
        ("one-pass concat kernel without x_lo (x_hi input)", (x_hi16, one), (raw, one)),
    ], g_one, floor_db=ONE_PASS_FLOOR_DB["u16"])
    # float32 lines: the three-x-part concat kernel without x_lo w_0 (x cut
    # to x_hi + x_mid) must fail
    wide = _raw("f32", 4096, 1024, g_one, dev)
    _concat_controls([("three-x-part concat kernel without x_lo (x_hi + x_mid input)",
                       (_without_x_lo(wide), one), (wide, one))],
                     g_one, floor_db=ONE_PASS_FLOOR_DB["f32"])


def _concat_controls(controls, g, floor_db=0.0):
    """Each (name, kernel inputs, plain inputs) of a concat kernel: it must
    fail the scale bounds (display floor at ``floor_db``)."""
    import torch

    for name, kernel_in, plain_in in controls:
        _, detail, ok = _compare_concat(*kernel_in, False, True, torch.float32, g,
                                        ref=plain_in, floor_db=floor_db)
        torch.cuda.synchronize()
        log(f"[kernels] control: {name}: {detail} -> "
            f"{'passes (BAD)' if ok else 'fails, as it must'}")
        if ok:
            raise AssertionError(f"control {name!r} passed: the bounds do not catch it")


def _concat_cases(cases, ops, worst, g, dev):
    """Each (n_in, lines, input, passes, log scaling, out dtype) of the
    concat fold kernels against its plain version; a one-pass case's route
    is read back and must follow its input type, and its display floor
    follows its samples' range (``ONE_PASS_FLOOR_DB``)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    for n_in, lines, kind, passes, log_scaling, odt in cases:
        raw = _raw(kind, lines, n_in, g, dev)
        wide = fp.concat_operator(*ops[n_in], RUNG_OF_PASSES[passes])
        fp.reset_launch_counts()
        floor_db = ONE_PASS_FLOOR_DB.get(kind, 0.0) if passes <= 1 else 0.0
        err, detail, ok = _compare_concat(raw, wide, kind == "u16s", log_scaling, odt, g,
                                          floor_db=floor_db)
        torch.cuda.synchronize()
        family = "depth_scale_concat" + ("_split" if passes > 1 else "")
        row = _row(family, passes)
        if n_in == 1024 and kind == "u16s" and odt == torch.float32:
            worst[row] = max(worst[row], err)  # the main path's inputs
        if n_in == 1024 and kind == "f32" and passes == 1 and odt == torch.float32:
            worst[family + "_f32lines"] = max(worst[family + "_f32lines"], err)
        route = _route_read_back(family, kind, bf16=passes == 0) if passes <= 1 else ""
        log(f"[kernels] {row:<24} n_in={n_in} lines={lines} {kind} passes={passes} "
            f"{'log' if log_scaling else 'lin'} {str(odt).replace('torch.', '')}{route}: "
            f"{detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{row} kernel disagrees with its plain version")


def _compare_prep(raw, parts, rows, bitshift, ref=None):
    """A prep kernel (phase with ``rows`` = (cos, sin), real with None) on
    (raw, parts) against its plain version on ``ref`` (default the same
    inputs).  Returns (max |err|, detail, within the bound)."""
    from octproz_tpu_torch.kernels import fused_prep as fp

    rraw, rparts = ref or (raw, parts)
    if rows is None:
        got = fp.prep_real(raw, parts, bitshift=bitshift)
        want = fp.prep_real_plain(rraw, rparts, bitshift=bitshift)
    else:
        got = fp.prep_phase(raw, parts, *rows, bitshift=bitshift)
        want = fp.prep_phase_plain(rraw, rparts, *rows, bitshift=bitshift)
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"prep kernel gave {got.dtype} {tuple(got.shape)}, "
                             f"plain {want.dtype} {tuple(want.shape)}")
    err = fp.prep_error(got, want)
    worst = float((got - want).abs().max())
    return worst, (f"rel L2 {err:.3e} (bound {fp.PREP_REL_L2:g}), max|err| {worst:.3e}"
                   ), err <= fp.PREP_REL_L2


def _prep_operators(n_in, background_removal, dev):
    """The FFT path's prep operator (float32) and phasor rows at n_in."""
    from octproz_tpu_torch import bench
    from octproz_tpu_torch import curves as curves_mod
    from octproz_tpu_torch.params import AcqParams

    acq = AcqParams(samples_per_line=n_in, ascans_per_bscan=8, bscans_per_buffer=1)
    cfg = bench.fft_config(background_removal=background_removal)
    cv = curves_mod.make_curves(acq, cfg, **{
        **bench.CURVE_KW, "resample_coeffs": (0.0, n_in - 1.0, 20.0, -10.0)}, device=dev)
    return cv.prep_operator, (cv.phase.real.contiguous(), cv.phase.imag.contiguous())


def _prep_kernel_cases(worst, g, dev):
    """The prep families on the fold kernels' grid -- rungs 1/3/5, shifted
    and unshifted 12-bit, uint8 and float inputs, an odd line count,
    n_in = 1664 -- plus n_in = 1100 (ragged in n_in and n_out), 1088 (a
    half-empty last tile of the tensor-core kernels) and the operator with
    background removal folded in (denser, so more reordering); both
    kernels' one pass (uint8/uint16 lines on the tensor cores; float32
    lines there too with three x parts -- 24- and 32-bit samples, n_in up
    to 4096, 999 and 131073 lines; the route read back after each one-pass
    case); then the controls, which
    must fail -- at the split rungs a neighbouring rung, at one pass each
    kernel on two of its three parts, without x_lo and on float32 lines
    without x_lo (x_hi + x_mid), against the float32 product."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    cases = [
        # (n_in, lines, input, passes, "phase" or "real", background removal)
        (1024, 4096, "u16s", 1, "phase", False),
        (1024, 4096, "u16s", 3, "phase", False),
        (1024, 4096, "u16s", 5, "phase", False),
        (1024, 4096, "u16", 3, "phase", False),
        (1024, 4096, "u16", 5, "phase", False),
        (1024, 4096, "u16s", 1, "real", False),
        (1024, 4096, "u16s", 3, "real", False),
        (1024, 4096, "u16s", 5, "real", False),
        (1024, 4096, "u16", 3, "real", False),
        (1024, 4096, "u16", 5, "real", False),
        (1024, 4096, "u16", 1, "phase", True),
        (1024, 4096, "u16", 3, "real", True),
        (1024, 4133, "u16s", 1, "phase", False),
        (1024, 4133, "u16s", 3, "real", False),
        (1664, 1000, "u16s", 3, "phase", False),
        (1664, 1000, "u16", 5, "real", False),
        (1664, 1000, "u16s", 1, "real", False),
        (1100, 999, "u16", 3, "phase", True),
        (1100, 999, "u16s", 1, "real", False),
        (1024, 2048, "u8", 1, "phase", False),
        (1024, 2048, "f32", 5, "phase", False),
        (1024, 2048, "f32", 3, "real", False),
        # the split kernels' ragged edges: a TMA-aligned n_out whose last
        # 128-column tile is half empty (1088), 4133 lines, background
        # removal at 5 passes, uint8 input
        (1088, 999, "u16", 3, "phase", False),
        (1088, 999, "u16", 3, "real", False),
        (1088, 4133, "u16s", 3, "phase", True),
        (1024, 4133, "u16", 5, "real", True),
        (1024, 2048, "u8", 3, "phase", False),
        (1024, 2048, "u8", 3, "real", False),
    ]
    # The prep kernels' one pass beyond the cases above: unshifted 12-bit
    # and full 16-bit samples (x_lo terms), background removal, n_in = 1088
    # and 1100 (its uint16 rows not 16-byte aligned: the element-wise
    # producer), and float32 lines with three x parts; on a generator of
    # their own, so the controls keep their data.
    one_pass = [
        (1024, 4096, "u16", 1, "phase", False),
        (1024, 4096, "u16f", 1, "phase", False),
        (1024, 4096, "u16f", 1, "phase", True),
        (1088, 999, "u16", 1, "phase", False),
        (1088, 4133, "u16s", 1, "phase", True),
        (1024, 2048, "f32", 1, "phase", False),
        (1024, 4096, "u16", 1, "real", False),
        (1024, 4096, "u16f", 1, "real", False),
        (1024, 4096, "u16f", 1, "real", True),
        (1088, 999, "u16", 1, "real", False),
        (1088, 4133, "u16s", 1, "real", True),
        (1100, 999, "u16", 1, "real", True),
        (1024, 2048, "f32", 1, "real", False),
        (1100, 999, "f32", 1, "real", False),
        # both kernels on float32 lines: the tensor cores with three x
        # parts, 24- and 32-bit samples, background removal, longer lines,
        # ragged line counts, rows not 16-byte aligned (1001: the
        # element-wise producer)
        (1024, 4096, "f32", 1, "phase", False),
        (1024, 4096, "f32w", 1, "phase", True),
        (1664, 999, "f32", 1, "phase", True),
        (2048, 999, "f32w", 1, "phase", False),
        (4096, 999, "f32", 1, "phase", True),
        (1024, 131073, "f32", 1, "phase", False),
        (1001, 999, "f32", 1, "phase", True),
        (4096, 999, "f32w", 1, "real", False),
        (1024, 4096, "f32", 1, "real", False),
        (1024, 4096, "f32w", 1, "real", True),
        (1664, 999, "f32", 1, "real", True),
        (2048, 999, "f32w", 1, "real", False),
        (4096, 999, "f32", 1, "real", True),
        (1024, 131073, "f32", 1, "real", False),
        (1001, 999, "f32", 1, "real", True),
    ]
    ops = {(n, bg): _prep_operators(n, bg, dev)
           for n, bg in {(c[0], c[5]) for c in cases + one_pass}}
    _prep_cases(cases, ops, worst, g, dev)
    g_one = torch.Generator(device=dev)
    g_one.manual_seed(8)
    _prep_cases(one_pass, ops, worst, g_one, dev)

    raw = _raw("u16", 4096, 1024, g, dev)
    op, rows = ops[(1024, False)]
    p5, p3 = fp._operator_parts(op, "highest"), fp._operator_parts(op, "high")
    x_hi = fp._bf16_trunc(raw.to(torch.float32))
    controls = [
        ("3-pass kernel on the highest parts", (raw, p5[:2]), (raw, p5)),
        ("3-pass kernel without x_lo (x_hi input)", (x_hi, p3), (raw, p3)),
    ]
    for name, kernel_in, plain_in in controls:
        for epi_rows in (rows, None):
            _, detail, ok = _compare_prep(*kernel_in, epi_rows, False, ref=plain_in)
            torch.cuda.synchronize()
            log(f"[kernels] control: {name}, prep {'phase' if epi_rows else 'real'}: "
                f"{detail} -> {'passes (BAD)' if ok else 'fails, as it must'}")
            if ok:
                raise AssertionError(f"control {name!r} passed: the prep bound does "
                                     f"not separate the rungs")
    p1 = fp._operator_parts(op, "default")
    two = fp.OnePass(p1[0], split=(*p1.split[:2], torch.zeros_like(p1.split[2])))
    x_hi16 = x_hi.to(torch.int16).view(torch.uint16)
    wide = _raw("f32", 4096, 1024, g, dev)
    for epi, epi_rows in (("phase", rows), ("real", None)):
        for name, kernel_in, ref in (
                (f"one-pass {epi} kernel on two of its three parts", (raw, two), (raw, p1)),
                (f"one-pass {epi} kernel without x_lo (x_hi input)", (x_hi16, p1), (raw, p1)),
                (f"one-pass {epi} kernel on float32 lines without x_lo (x_hi + x_mid input)",
                 (_without_x_lo(wide), p1), (wide, p1))):
            _, detail, ok = _compare_prep(*kernel_in, epi_rows, False, ref=ref)
            torch.cuda.synchronize()
            log(f"[kernels] control: {name}: {detail} -> "
                f"{'passes (BAD)' if ok else 'fails, as it must'}")
            if ok:
                raise AssertionError(f"control {name!r} passed: the prep bound does not "
                                     f"catch it")


def _prep_cases(cases, ops, worst, g, dev):
    """Each (n_in, lines, input, passes, "phase" or "real", background
    removal) of the prep kernels against its plain version; a one-pass
    case's route is read back and must follow its input type."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    for n_in, lines, kind, passes, epi, bg in cases:
        op, rows = ops[(n_in, bg)]
        raw = _raw(kind, lines, n_in, g, dev)
        fp.reset_launch_counts()
        err, detail, ok = _compare_prep(raw, fp._operator_parts(op, RUNG_OF_PASSES[passes]),
                                        rows if epi == "phase" else None, kind == "u16s")
        torch.cuda.synchronize()
        family = f"prep_{epi}" + ("_split" if passes > 1 else "")
        row = _row(family, passes)
        if n_in == 1024 and kind == "u16s" and not bg:
            worst[row] = max(worst[row], err)  # the main path's inputs
        if n_in == 1024 and kind == "f32" and passes == 1 and not bg:
            worst[family + "_f32lines"] = max(worst[family + "_f32lines"], err)
        route = _route_read_back(family, kind, bf16=passes == 0) if passes <= 1 else ""
        log(f"[kernels] {row:<17} n_in={n_in} lines={lines} {kind} passes={passes}"
            f"{' bg' if bg else ''}{route}: {detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{row} kernel disagrees with its plain version")


def _run_main_path(model, host_raw, bufs, tag):
    """Buffer 0 (FPN determination) from the host, three steady buffers, a
    batched chunk of four; checks batch == per-buffer steps."""
    import torch

    acq = model.acq
    out0 = model.process_buffer(host_raw)
    if not model.fpn_state.determined:
        raise AssertionError("FPN was not determined on buffer 0")
    steady = [model.process_buffer(bufs[i]) for i in range(3)]
    chunk = model.process_chunk(bufs, strategy="batch")
    steady.append(model.process_buffer(bufs[3]))
    torch.cuda.synchronize()
    want = (acq.bscans_per_buffer, acq.ascans_per_bscan, acq.output_ascan_length)
    for out in [out0, *steady]:
        if tuple(out.shape) != want:
            raise AssertionError(f"output shape {tuple(out.shape)} != {want}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("non-finite values in the processed buffer")
    if tuple(chunk.shape) != (4, *want):
        raise AssertionError(f"chunk shape {tuple(chunk.shape)}")
    for i in range(4):
        a, b = steady[i], chunk[i]
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            raise AssertionError("batch and per-buffer finite masks differ")
        if not torch.allclose(a, b, atol=1e-5, rtol=1e-5):
            raise AssertionError(f"batch buffer {i} != per-buffer step "
                                 f"({float((a - b).abs().max()):.3e})")
    log(f"[main] {tag}: buffer 0 + 3 steady + batch of 4, shape {want}, "
        f"batch == per-buffer (atol 1e-5)")
    return steady[0], bufs[0]


def _check_steady_full_size(model, out, raw):
    """The main path's first steady buffer against its kernel's semantics on
    the same full-size input (no kernel launch).  At the split rungs that is
    the plain version (two-operator or, with fold_concat, concat), which
    sums the same pass terms.  At one pass the plain version is a float32
    product with rounding of its own, and over a full buffer's deepest
    nulls log10 amplifies it past the max bound (on the card it read 1.7e-4
    against the kernel on one stream buffer, while the kernel's three-part
    sum stays closer to the exact product): the kernel is held to the same
    bounds against the product of the same float32 operator evaluated in
    float64, and its distance to the plain version is logged beside it.
    At bf16 compute likewise, against the float64 product of the rounded
    operands (x and the operator rounded to bf16, as the kernel takes
    them)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    acq, cfg = model.acq, model.cfg
    rung = fp.operator_rung(cfg)
    a, b = fp._scale_affine(cfg.log_scaling, acq.output_ascan_length, cfg.grayscale_min,
                            cfg.grayscale_max, cfg.addend, cfg.multiplicator)
    kw = dict(bitshift=cfg.bitshift, log_scaling=cfg.log_scaling, a=a, b=b)
    raw2d = raw.reshape(-1, acq.samples_per_line)
    mean2 = model.fpn_state.mean_line
    if cfg.fold_concat:
        wide = fp.concat_operator(*model.curves.depth_parts, rung)
        plain = fp.depth_scale_concat_plain(raw2d, wide, mean2, **kw)
    else:
        plain = fp.depth_scale_plain(raw2d, *model.curves.depth_parts, mean2, **kw)
    got = out.reshape(plain.shape)
    family = ("depth_scale_concat" if cfg.fold_concat else "depth_scale") \
        + {"default": "", fp.BF16: "_bf16"}.get(rung, "_split")
    what, ref = "plain version", plain
    if rung in ("default", fp.BF16):
        rms, worst, _ = fp.scale_error(got, plain)
        log(f"[main] {family} full buffer ({rung}) vs plain version (float32 product): "
            f"above the display floor RMS {rms:.3e}, max {worst:.3e}")
        w = (model.curves.depth_op_re, model.curves.depth_op_im)
        if rung == fp.BF16:
            w = tuple(t.to(torch.bfloat16) for t in w)
        ref = fp.depth_scale_f64(raw2d, (w[0],), (w[1],), mean2, **kw)
        rms, worst, _ = fp.scale_error(plain, ref)
        log(f"[main] plain version (float32 product) vs the float64 product: above the "
            f"display floor RMS {rms:.3e}, max {worst:.3e}")
        what = "the float64 product"
    rms, worst, ok = fp.scale_error(got, ref)
    log(f"[main] {family} full buffer ({rung}) vs {what}: "
        f"above the display floor RMS {rms:.3e}, max {worst:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"full-size {family} output disagrees with {what}")
    return family, worst


def _check_output(outs, acq, tag):
    """Every output of the buffer's processed shape, with no NaN and no
    +inf.  -inf is log10(0): without dispersion the DC bin is real, and a
    line whose DC equals the FPN mean exactly has p = 0 there (the
    reference's exact path gives -inf too; such a voxel displays black), so
    it is counted and must stay rare."""
    import torch

    want = (acq.bscans_per_buffer, acq.ascans_per_bscan, acq.output_ascan_length)
    for out in outs:
        if tuple(out.shape) != want:
            raise AssertionError(f"{tag}: output shape {tuple(out.shape)} != {want}")
        if bool(torch.isnan(out).any()) or bool(torch.isposinf(out).any()):
            raise AssertionError(f"{tag}: NaN or +inf in the processed buffer")
        black = int(torch.isneginf(out).sum())
        if black > out.numel() * 1e-5:
            raise AssertionError(f"{tag}: {black} voxels at -inf (p == 0)")
        if black:
            log(f"[main] {tag}: {black} voxel(s) at -inf (p == 0 after FPN)")


def _run_handheld(model, bufs, tag, batch):
    """The handheld preset (post stages): buffer 0 (FPN determination) and
    two steady buffers; on the fold path also a batched chunk of those two,
    which must equal the per-buffer steps."""
    import torch

    out0 = model.process_buffer(bufs[0])
    steady = [model.process_buffer(bufs[i]) for i in (1, 2)]
    _check_output([out0, *steady], model.acq, tag)
    if batch:
        chunk = model.process_chunk(bufs[1:3], strategy="batch")
        for a, b in zip(steady, chunk):
            if not torch.allclose(a, b, atol=1e-5, rtol=1e-5):
                raise AssertionError(f"{tag}: batch != per-buffer step "
                                     f"({float((a - b).abs().max()):.3e})")
    log(f"[main] {tag}: buffer 0 + 2 steady{' + batch of 2 == per-buffer' if batch else ''}")


def _check_routes(launches, tag, route="tensor_core"):
    """Every one-pass launch of a path's run on uint16 lines went to
    ``route`` (the tensor cores; at bf16 compute their bf16 route):
    ``ONE_PASS_ROUTES`` against the run's launch counts (none for a family
    the path does not launch)."""
    from octproz_tpu_torch.kernels import fused_prep as fp

    routes = {k: dict(v) for k, v in fp.ONE_PASS_ROUTES.items()}
    log(f"[main] {tag} one-pass routes "
        f"{ {k: v for k, v in routes.items() if any(v.values())} }")
    want = {k: {**dict.fromkeys(v, 0), route: launches.get(k, 0)} for k, v in routes.items()}
    if routes != want:
        raise AssertionError(f"{tag}: one-pass launches by route {routes}, want {want}")


def _read_launches(families, t0, tag):
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    torch.cuda.synchronize()
    launches = {k: fp.LAUNCHES[k] for k in families}
    log(f"[main] {tag} launches {launches} ({time.perf_counter() - t0:.1f} s)")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"{tag} never launched {missing}")
    return launches


def phase_main_path(worst):
    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.models.presets import handheld_sinusoidal_config

    dev = torch.device("cuda", 0)
    acq = bench.FULL_ACQ
    host_raw = np.random.default_rng(20).integers(0, 4096, size=acq.buffer_shape,
                                                  dtype=np.uint16)
    bufs = bench.random_buffers(acq, 4, dev, seed=21)
    model = FdOctModel(acq, bench.bench_config(), **bench.CURVE_KW, device=dev)
    handheld = FdOctModel(acq, handheld_sinusoidal_config(tpu=True), **bench.CURVE_KW,
                          device=dev)
    torch.cuda.synchronize()

    fp.reset_launch_counts()
    t0 = time.perf_counter()
    for rung in ("default", "high"):
        if rung != "default":
            model.set_config(matmul_precision=rung)
            model.redetermine_fpn()
        out, raw = _run_main_path(model, host_raw, bufs, f"{rung} rung")
        family, err = _check_steady_full_size(model, out, raw)
        worst[family] = max(worst[family], err)
        del out
    _run_handheld(handheld, bufs, "fold path, handheld preset", batch=True)
    launches = _read_launches(FOLD, t0, "fold path")
    _check_routes(launches, "fold path")
    del handheld

    # Buffer 0's GEMM (the depth families) at full size on buffer 0's input,
    # after the counts were read.
    raw0 = torch.from_numpy(host_raw).to(dev).reshape(-1, acq.samples_per_line)
    for rung in ("default", "high"):
        w = tuple(fp._operator_parts(op, rung)
                  for op in (model.curves.depth_op_re, model.curves.depth_op_im))
        err, detail, ok = _compare(raw0, *w, True, None, None, None)
        family = "depth" if rung == "default" else "depth_split"
        worst[family] = max(worst[family], err)
        log(f"[main] {family} full buffer 0 ({rung}) vs plain version: {detail} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"full-size {family} output disagrees with the plain version")
    return launches


def _run_fft_path(model, host_raw, bufs, tag):
    """Buffer 0 (FPN determination) from the host, four steady buffers, and
    a scan chunk of the same four, which must equal the per-buffer steps."""
    import torch

    out0 = model.process_buffer(host_raw)
    if not model.fpn_state.determined:
        raise AssertionError("FPN was not determined on buffer 0")
    steady = [model.process_buffer(bufs[i]) for i in range(4)]
    chunk = model.process_chunk(bufs, strategy="auto")  # the FFT path scans
    torch.cuda.synchronize()
    _check_output([out0, *steady], model.acq, tag)
    if tuple(chunk.shape) != (4, *steady[0].shape):
        raise AssertionError(f"chunk shape {tuple(chunk.shape)}")
    for i in range(4):
        if not torch.equal(steady[i], chunk[i]):
            raise AssertionError(f"{tag}: scan chunk buffer {i} != per-buffer step "
                                 f"({float((steady[i] - chunk[i]).abs().max()):.3e})")
    log(f"[fft] {tag}: buffer 0 + 4 steady + scan chunk of 4, shape "
        f"{tuple(steady[0].shape)}, scan == per-buffer (exact)")


def phase_fft_path(worst):
    """The FFT path at full width: the benchmark chain (phase kernels) at
    every rung, its dispersion-free variant (real kernels) and the handheld
    preset, with the prep kernels' launch counts read around the run (and
    the split kernels' around each split rung); then each rung's full-size
    prep output against the plain versions."""
    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.models.presets import handheld_sinusoidal_config

    dev = torch.device("cuda", 0)
    acq = bench.FULL_ACQ
    host_raw = np.random.default_rng(30).integers(0, 4096, size=acq.buffer_shape,
                                                  dtype=np.uint16)
    bufs = bench.random_buffers(acq, 4, dev, seed=31)
    models = {"phase": FdOctModel(acq, bench.fft_config(), **bench.CURVE_KW, device=dev),
              "real": FdOctModel(acq, bench.fft_config(dispersion=False), **bench.CURVE_KW,
                                 device=dev)}
    handheld = FdOctModel(acq, dataclasses.replace(handheld_sinusoidal_config(tpu=False),
                                                   use_pallas_prep=True),
                          **bench.CURVE_KW, device=dev)
    torch.cuda.synchronize()

    fp.reset_launch_counts()
    t0 = time.perf_counter()
    for rung in RUNGS:
        before = dict(fp.LAUNCHES)
        for epi, model in models.items():
            if rung != "default":
                model.set_config(matmul_precision=rung)
                model.redetermine_fpn()
            _run_fft_path(model, host_raw, bufs,
                          f"{rung} rung, {'dispersion' if epi == 'phase' else 'no dispersion'}")
        if rung != "default":  # each split rung's own runs went through the split kernels
            ran = {k: fp.LAUNCHES[k] - before[k] for k in PREP if k.endswith("_split")}
            log(f"[fft] {rung} rung launches {ran}")
            if not all(ran.values()):
                raise AssertionError(f"FFT path at {rung!r} never launched a split prep "
                                     f"kernel: {ran}")
    _run_handheld(handheld, bufs, "FFT path, handheld preset", batch=False)
    launches = _read_launches(PREP, t0, "FFT path")
    _check_routes(launches, "FFT path")
    del handheld

    # Full-size prep output of each rung against the plain version, after
    # the counts were read.
    raw2d = bufs[0].reshape(-1, acq.samples_per_line)
    for rung in RUNGS:
        for epi, model in models.items():
            if model.cfg.matmul_precision != rung:
                model.set_config(matmul_precision=rung)
            cv = model.curves
            rows = (cv.phase.real.contiguous(), cv.phase.imag.contiguous()) \
                if epi == "phase" else None
            err, detail, ok = _compare_prep(raw2d, cv.prep_parts, rows, True)
            family = f"prep_{epi}" + ("_split" if rung != "default" else "")
            worst[family] = max(worst[family], err)
            log(f"[fft] {family} full buffer ({rung}) vs plain version: {detail} "
                f"-> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"full-size {family} output disagrees with the plain "
                                     f"version")
    return launches


def phase_wide_samples(worst):
    """24-bit samples in uint32 containers (``bench.WIDE_ACQ``; the wrappers
    decode them to float32 lines) through ``FdOctModel`` at full width: the
    benchmark chain on the fold path, its concat variant, and the FFT path
    with and without dispersion (``bench.wide_config``: no bitshift, the
    display range moved up by the wider samples' 96.3 dB), each run -- buffer
    0 (FPN) from the host, steady buffers and a chunk -- between a reset and
    a read of the launch counts: every family the path runs launched, every
    launch on the tensor cores with three x parts.  Then the fold paths'
    steady output at full size against the
    float64 product of their float32 operator, and the FFT paths' prep
    output against its plain version.  Returns the launches by
    ``F32_ROWS`` row."""
    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.models.fdoct import FdOctModel

    dev = torch.device("cuda", 0)
    acq = bench.WIDE_ACQ
    host_raw = np.random.default_rng(40).integers(0, 1 << 24, size=acq.buffer_shape,
                                                  dtype=np.int64).astype(np.uint32)
    bufs = bench.random_buffers(acq, 4, dev, seed=41)
    paths = (("fold path", bench.bench_config(), ("depth", "depth_scale")),
             ("concat fold path", bench.bench_config(fold_concat=True),
              ("depth", "depth_scale_concat")),
             ("FFT path", bench.fft_config(), ("prep_phase",)),
             ("FFT path without dispersion", bench.fft_config(dispersion=False),
              ("prep_real",)))
    launches = dict.fromkeys(F32_ROWS, 0)
    for tag, cfg, families in paths:
        tag = f"24-bit {tag}"
        model = FdOctModel(acq, bench.wide_config(cfg), **bench.CURVE_KW, device=dev)
        torch.cuda.synchronize()
        fp.reset_launch_counts()
        t0 = time.perf_counter()
        if cfg.fft_via_matmul:
            out, raw = _run_main_path(model, host_raw, bufs, tag)
        else:
            _run_fft_path(model, host_raw, bufs, tag)
        ran = _read_launches(families, t0, tag)
        routes = {k: dict(fp.ONE_PASS_ROUTES[k]) for k in families}
        want = {k: {**dict.fromkeys(routes[k], 0), "tensor_core": n} for k, n in ran.items()}
        log(f"[wide] {tag} one-pass routes {routes}")
        if routes != want:
            raise AssertionError(f"{tag}: one-pass launches by route {routes}, want {want}")
        for k, n in ran.items():
            launches[k + "_f32lines"] += n
        # the full-size checks, after the counts were read, on the float32
        # lines the wrappers decode
        if cfg.fft_via_matmul:
            family, err = _check_steady_full_size(model, out, fp._predecode(raw, 24, False))
            worst[family + "_f32lines"] = max(worst[family + "_f32lines"], err)
            del out
        else:
            cv = model.curves
            rows = (cv.phase.real.contiguous(), cv.phase.imag.contiguous()) \
                if cfg.dispersion else None
            lines = fp._predecode(bufs[0].reshape(-1, acq.samples_per_line), 24, False)
            err, detail, ok = _compare_prep(lines, cv.prep_parts, rows, False)
            family = families[0]
            worst[family + "_f32lines"] = max(worst[family + "_f32lines"], err)
            log(f"[wide] {family} full buffer vs plain version: {detail} "
                f"-> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"24-bit full-size {family} output disagrees with the "
                                     f"plain version")
        del model
    return launches


#: Buffers per width of ``phase_continuous_fpn``.
CONTINUOUS_BUFFERS = 4


def phase_continuous_fpn(info):
    """The fold path with continuous FPN (``FpnMode.CONTINUOUS``: the FPN
    mean line determined anew on every buffer, so every buffer runs the
    planar kernel B1 and then the torch FPN and scaling, never the
    steady-state kernel) through ``FdOctModel`` at full width: 12-bit
    samples in uint16 (``bench.FULL_ACQ``) and 24-bit samples in uint32
    (``bench.WIDE_ACQ`` with ``bench.wide_config``: float32 lines, B1 with
    three x parts).  Each width's ``CONTINUOUS_BUFFERS`` buffers run between
    a reset and a read of the launch counts: ``depth`` once per buffer, all
    on the tensor cores, and no other family; every output finite, of the
    buffer's shape, and the mean line of the last buffer not that of the
    one before.  Then, after the counts were read, the last buffer's B1
    planes against the float64 product of the float32 operators (within
    ``fused_prep.PLANAR_REL_L2``, the plain version's distance logged
    beside), and the steady ms per buffer (``bench.steady_ms_per_buffer``).
    Returns the launches by row (``depth``, ``depth_f32lines``)."""
    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.params import FpnMode

    dev = torch.device("cuda", 0)
    card = f"{info['device_name']}, power limit {info['power_limit']}"
    base = bench.bench_config(fpn_mode=FpnMode.CONTINUOUS)
    launches = {}
    for row, acq, cfg in (("depth", bench.FULL_ACQ, base),
                          ("depth_f32lines", bench.WIDE_ACQ, bench.wide_config(base))):
        tag = f"{acq.bit_depth}-bit continuous-FPN fold path"
        model = FdOctModel(acq, cfg, **bench.CURVE_KW, device=dev)
        bufs = bench.random_buffers(acq, CONTINUOUS_BUFFERS, dev, seed=60 + acq.bit_depth)
        torch.cuda.synchronize()
        fp.reset_launch_counts()
        t0 = time.perf_counter()
        outs, means = [], []
        for buf in bufs:
            outs.append(model.process_buffer(buf))
            means.append(model.fpn_state.mean_line)
        ran = _read_launches(("depth",), t0, tag)
        others = {k: v for k, v in fp.LAUNCHES.items() if k != "depth" and v}
        routes = dict(fp.ONE_PASS_ROUTES["depth"])
        log(f"[continuous] {tag}: depth launches {ran['depth']} for {len(bufs)} buffers, "
            f"routes {routes}, other families {others or 'none'}")
        if ran["depth"] != len(bufs) or others \
                or routes != {**dict.fromkeys(routes, 0), "tensor_core": len(bufs)}:
            raise AssertionError(f"{tag}: want one depth launch per buffer on the tensor cores "
                                 f"and nothing else, got {dict(fp.LAUNCHES)}, routes {routes}")
        launches[row] = ran["depth"]
        _check_output(outs, acq, tag)
        if torch.equal(means[-1], means[-2]):
            raise AssertionError(f"{tag}: the FPN mean line was not determined anew")
        # the last buffer's B1 planes, after the counts were read
        raw2d = fp._predecode(bufs[-1].reshape(-1, acq.samples_per_line), acq.bit_depth,
                              cfg.bitshift)
        got = fp.fold_depth(raw2d, *model.curves.depth_parts, bitshift=cfg.bitshift)
        x = fp._decode_block(raw2d, cfg.bitshift).double()
        exact = [x @ model.curves.depth_op_re.double(), x @ model.curves.depth_op_im.double()]
        plain = fp.depth_plain(raw2d, *model.curves.depth_parts, bitshift=cfg.bitshift)
        err, plain_err = fp.planar_error(got, exact), fp.planar_error(plain, exact)
        ok = err <= fp.PLANAR_REL_L2
        log(f"[continuous] {tag}: B1 planes of buffer {len(bufs) - 1} vs the float64 product: "
            f"rel L2 {err:.3e} (bound {fp.PLANAR_REL_L2:g}; plain version {plain_err:.3e}) "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: B1's planes disagree with the float64 product")
        del got, x, exact, plain, outs, means, model, bufs
        ms = bench.steady_ms_per_buffer(cfg, dev, acq=acq)
        log(f"[continuous] {tag} steady state (default): {ms:.3f} ms/buffer, "
            f"{acq.ascans_per_buffer / ms / 1e3:.3f} MHz ({card})")
    return launches


def _engine_launches(run, rung, need, tag):
    """``run()`` -- one ``StreamingEngine.run`` -- between a reset and a read
    of the launch counts.  The rung's concat family must have launched at
    least ``need(result)`` times (the steady buffers or chunks the run
    dispatched) and no other steady-state family at all, and every one-pass
    launch of the run (the default rung's concat kernel, the FPN buffer's
    fold kernel) must have gone to the tensor cores.  Returns the result
    and the run's concat counts."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    torch.cuda.synchronize()
    fp.reset_launch_counts()
    result = run()
    torch.cuda.synchronize()
    counts = {k: fp.LAUNCHES[k] for k in CONCAT + TWO_OPERATOR}
    family = CONCAT[0] if rung == "default" else CONCAT[1]
    want = need(result)
    if counts[family] < want or any(v for k, v in counts.items() if k != family):
        raise AssertionError(f"{tag}: engine run launched {counts}; want {family} >= "
                             f"{want} and no other steady-state family")
    _check_routes({k: fp.LAUNCHES[k] for k in fp.ONE_PASS_ROUTES}, tag)
    return result, {k: counts[k] for k in CONCAT}


def _record_stream(cfg, source, wire, chunk, directory, dev, tag):
    """Two buffers of the engine's float32 recorder stream (every buffer
    quantized and fetched as well), with the engine run's launch counts.
    For a chunked run the model's FPN is determined on buffer 0 first, so
    both recorded buffers come out of one batch kernel; per buffer, the
    run's first buffer determines the FPN and the second is steady."""
    from octproz_tpu_torch import bench
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.runtime import StreamingEngine

    acq = bench.FULL_ACQ
    model = FdOctModel(acq, cfg, **bench.CURVE_KW, device=dev)
    if chunk > 1:
        model.process_buffer(source.read_buffer(0) if wire == "uint16"
                             else model.put_packed_buffer(source.read_buffer(0)))
    eng = StreamingEngine(model, source, wire_format=wire, stream_to_host=True,
                          dispatch_chunk=chunk, chunk_strategy="batch" if chunk > 1 else "auto")
    eng.start_recording(_recording(directory, f"{wire}{chunk}", 2))
    want = max(chunk, 2)
    n, counts = _engine_launches(lambda: eng.run(max_buffers=want), cfg.matmul_precision,
                                 lambda n: n // chunk if chunk > 1 else n - 1, tag)
    if n != want:
        raise AssertionError(f"{tag}: {n} buffers, want {want}")
    return _recorded(eng, 2, acq.processed_buffer_shape, tag), counts


def phase_stream(worst, info):
    """The streaming runtime at full width on the concat path: see the
    module docstring, phase 6.  Returns the concat kernels' launch counts,
    summed over the engine runs alone."""
    import tempfile

    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.models.fdoct import FdOctModel

    dev = torch.device("cuda", 0)
    acq = bench.FULL_ACQ
    card = f"{info['device_name']}, power limit {info['power_limit']}"
    rates = {}
    launches = dict.fromkeys(CONCAT, 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sources = bench.stream_sources(tmp)
        log(f"[stream] sources: 3 buffers per wire written and read back in "
            f"{time.perf_counter() - t0:.1f} s")
        host = [sources["uint16"].read_buffer(i) for i in range(2)]
        for rung in ("default", "high"):
            cfg = bench.bench_config(fold_concat=True, matmul_precision=rung)
            ref_model = FdOctModel(acq, cfg, **bench.CURVE_KW, device=dev)
            ref = [ref_model.fetch(ref_model.process_buffer(host[0]))]   # FPN buffer
            steady = [ref_model.process_buffer(b) for b in (host[1], host[0])]
            ref += [ref_model.fetch(t) for t in steady]
            want = {1: (ref[0], ref[1]), 4: (ref[2], ref[1])}
            recorded = {}
            for wire, src in sources.items():
                for chunk in (1, 4):
                    mode = "batch chunks of 4" if chunk > 1 else "per buffer"
                    tag = f"stream {rung} {wire} {mode}"
                    got, counts = _record_stream(cfg, src, wire, chunk, tmp, dev, tag)
                    recorded[(wire, chunk)] = got
                    for i in range(2):
                        rms, err, ok = fp.scale_error(torch.from_numpy(got[i]),
                                                      torch.from_numpy(want[chunk][i]))
                        if not ok:
                            raise AssertionError(
                                f"{tag} buffer {i} differs from process_buffer: "
                                f"RMS {rms:.3e}, max {err:.3e}")
                    rate, rate_counts = _engine_launches(
                        lambda: bench.engine_rate(cfg, dev, src, wire, chunk, seconds=3.0),
                        rung, lambda r: (r["buffers"] - chunk) // chunk if chunk > 1
                        else r["buffers"] - 1, f"{tag} rate")
                    rates[(rung, wire, chunk)] = rate
                    for k in CONCAT:
                        launches[k] += counts[k] + rate_counts[k]
                    log(f"[stream] {rung} rung, {wire} wire, {mode}: recorded float32 "
                        f"stream == process_buffer within the scale bounds; engine "
                        f"launches {counts} (recorded run), {rate_counts} (rate run), "
                        f"two-operator steady-state kernels 0")
            for chunk in (1, 4):
                if not np.array_equal(recorded[("uint16", chunk)], recorded[("packed12", chunk)]):
                    raise AssertionError(f"{rung}: packed-12 wire output != uint16 wire output")
            log(f"[stream] {rung} rung: packed-12 wire output == uint16 wire output (exact)")
            family, err = _check_steady_full_size(ref_model, steady[1], torch.from_numpy(
                host[0]).to(dev))
            worst[family] = max(worst[family], err)
            del ref_model, steady, recorded
    log(f"[main] stream path launches {launches}, summed over the engine runs "
        f"({time.perf_counter() - t0:.1f} s)")
    lines = acq.ascans_per_buffer
    for rung in ("default", "high"):
        ms = bench.steady_ms_per_buffer(bench.bench_config(fold_concat=True,
                                                           matmul_precision=rung), dev)
        for (r, wire, chunk), rate in rates.items():
            if r == rung:
                spread = rate["window_mhz"]
                log(f"[stream] {rung} rung, {wire} wire, chunk {chunk}: engine "
                    f"{rate['mhz']:.3f} MHz A-scans with the upload and the quantized "
                    f"fetch ({rate['timed_buffers']} buffers in {rate['timed_s']:.3f} s after "
                    f"warm-up, {rate['wire_mb_per_s']:.0f} MB/s wire; 1 s windows "
                    f"{min(spread, default=0):.3f}-{max(spread, default=0):.3f} MHz); steady "
                    f"process_buffer {lines / ms / 1e3:.3f} MHz ({ms:.3f} ms/buffer) ({card})")
    return launches


#: The acquisition phase's plugin module, written to a temporary directory
#: on ``sys.path`` and loaded through ``plugins.load_plugin`` as a third
#: party's would be: the PhytoOCT system and three bundled extensions.
ACQ_PLUGIN = '''
from octproz_tpu_torch.extensions import (ImageStatisticsExtension, PeakDetectorExtension,
                                          SignalMonitorExtension)
from octproz_tpu_torch.io import phytooct


def octproz_plugin(ctx):
    phytooct.register(ctx.systems)
    for ext in (ImageStatisticsExtension, PeakDetectorExtension, SignalMonitorExtension):
        ctx.register_extension(ext)
'''
#: The engine's own threads, which read the source until they end.
ENGINE_THREADS = ("octproz-acquisition", "octproz-upload")
#: tests/test_phytooct.py's small device, for the stage properties.
PHYTO_SMALL = dict(samples_per_line=256, ascans_per_bscan=64, bscans_per_buffer=2,
                   buffers_per_volume=1, exposure_us=0.0, shot_noise=0.0005)


def _exact_launches(run, want, tag):
    """``run()`` between a reset and a read of the launch counts, which
    must be ``want`` exactly (or ``want(result)``), every one-pass launch
    on the tensor cores."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    torch.cuda.synchronize()
    fp.reset_launch_counts()
    result = run()
    torch.cuda.synchronize()
    launches = {k: v for k, v in fp.LAUNCHES.items() if v}
    if callable(want):
        want = want(result)
    if launches != want:
        raise AssertionError(f"{tag}: launched {launches}; want {want}")
    _check_routes(launches, tag)
    return result, launches


def _acquisition_launches(run, need, tag):
    """``run()`` -- one ``StreamingEngine`` run on the two-operator fold path
    -- between a reset and a read of the launch counts: B1 (``depth``) once,
    for the FPN buffer, B2 (``depth_scale``) ``need(result)`` times, once
    per steady buffer, no other family, every launch on the tensor cores."""
    result, launches = _exact_launches(
        run, lambda r: {"depth": 1, "depth_scale": need(r)}, tag)
    log(f"[acq] {tag}: launches {launches}, every one on the tensor cores")
    return result, launches


@contextlib.contextmanager
def _fed_ring(acq, frames, count):
    """A ``HardwareRingSource`` of four full-width slots with a producer
    thread writing ``frames`` into it in turn -- ``count`` of them, or
    until the block ends when ``count`` is None -- then finishing the
    stream (the count contract).  At exit the producer is stopped and
    joined, then the engine's threads, and only then is the ring closed:
    closing frees the slots they read."""
    import threading

    from octproz_tpu_torch.io.hwbridge import HardwareRingSource

    src = HardwareRingSource(acq, n_slots=4)
    stop = threading.Event()

    def produce():
        try:
            i = 0
            while (count is None or i < count) and not stop.is_set():
                try:
                    src.write_blocking(frames[i % len(frames)], timeout_s=1.0)
                except TimeoutError:
                    continue  # the ring is full: look at ``stop`` again
                i += 1
        finally:
            src.finish()

    producer = threading.Thread(target=produce, name="acq-producer", daemon=True)
    producer.start()
    try:
        yield src
    finally:
        stop.set()
        _join_threads((producer,), ENGINE_THREADS)
        src.close()


def _join_threads(threads, names=()):
    """Join ``threads`` and every live thread named in ``names``, or fail."""
    import threading

    for t in [*threads, *(t for t in threading.enumerate() if t.name in names)]:
        t.join(timeout=60.0)
        if t.is_alive():
            raise AssertionError(f"thread {t.name} did not end")


def _recording(directory, name, count):
    from octproz_tpu_torch.io.recorder import RecordingParams

    return RecordingParams(save_dir=directory, name=name, buffers_to_record=count,
                           save_raw=False, save_processed=True, save_as_32bit_float=True,
                           save_meta=False)


def _recorded(eng, count, shape, tag):
    """The ``count`` buffers of the engine run's float32 recording."""
    path = eng.processed_recorder.last_file
    if path is None:
        raise AssertionError(f"{tag}: no float32 recording was written")
    out = np.fromfile(path, np.float32).reshape(count, *shape)
    os.remove(path)
    return out


def _hold_to_reference(got, want, tag):
    """Each recorded buffer against ``process_buffer``'s on the same raw
    buffer, within ``fused_prep.scale_error``'s bounds."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        rms, err, ok = fp.scale_error(torch.from_numpy(g), torch.from_numpy(w))
        if not ok:
            raise AssertionError(f"{tag} buffer {i} differs from process_buffer: "
                                 f"RMS {rms:.3e}, max {err:.3e}")
        worst = max(worst, err)
    log(f"[acq] {tag}: {len(got)} streamed buffers == process_buffer within the scale "
        f"bounds (max {worst:.3e})")


def _acquisition_ring(info, dev):
    """Part 1: a producer thread fills a ``HardwareRingSource`` of four
    full-width slots; the engine runs the two-operator benchmark chain."""
    import tempfile

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.runtime import StreamingEngine

    acq, cfg = bench.FULL_ACQ, bench.bench_config()
    card = f"{info['device_name']}, power limit {info['power_limit']}"
    frames = [b.numpy() for b in bench.random_buffers(acq, 4, dev, seed=70).cpu()]
    ref_model = FdOctModel(acq, cfg, **bench.CURVE_KW, device=dev)
    want = [ref_model.fetch(ref_model.process_buffer(f)) for f in frames[:3]]
    del ref_model
    with tempfile.TemporaryDirectory() as tmp, _fed_ring(acq, frames, 3) as src:
        eng = StreamingEngine(FdOctModel(acq, cfg, **bench.CURVE_KW, device=dev), src,
                              stream_to_host=True)
        eng.start_recording(_recording(tmp, "ring", 3))
        n, totals = _acquisition_launches(eng.run, lambda n: n - 1,
                                          "hardware ring, recorded run")
        if n != 3:
            raise AssertionError(f"hardware ring: the engine processed {n} of 3 buffers")
        _hold_to_reference(_recorded(eng, 3, acq.processed_buffer_shape, "hardware ring"),
                           want, f"hardware ring (FPN buffer + 2 steady, "
                                 f"{'x'.join(map(str, acq.buffer_shape[::-1]))})")
    with _fed_ring(acq, frames, None) as src:
        rate, launches = _acquisition_launches(
            lambda: bench.engine_rate(cfg, dev, src, "uint16", seconds=3.0),
            lambda r: r["buffers"] - 1, "hardware ring, rate run")
    for k in totals:
        totals[k] += launches[k]
    replay, launches = _acquisition_launches(
        lambda: bench.engine_rate(cfg, dev, _Replay(acq, frames), "uint16", seconds=3.0),
        lambda r: r["buffers"] - 1, "the same buffers replayed from RAM, rate run")
    for k in totals:
        totals[k] += launches[k]
    stages = bench.ring_ms(acq, frames[0])
    ms = bench.steady_ms_per_buffer(cfg, dev)
    lines = acq.ascans_per_buffer
    for what, r in (("hardware ring", rate), ("RAM replay (no ring)", replay)):
        spread = r["window_mhz"]
        log(f"[acq] {what}, two-operator path (default rung), uint16: engine "
            f"{r['mhz']:.3f} MHz A-scans with the upload and the quantized fetch "
            f"({r['timed_buffers']} buffers in {r['timed_s']:.3f} s after warm-up; 1 s "
            f"windows {min(spread, default=0):.3f}-{max(spread, default=0):.3f} MHz); steady "
            f"process_buffer {lines / ms / 1e3:.3f} MHz ({ms:.3f} ms/buffer) ({card})")
    log("[acq] ring stages alone per buffer (host clock): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()) + f" ({card})")
    return totals


class _Replay:
    """The same host buffers without end, handed out as they are (no copy):
    the engine's source when the ring's copies are left out."""

    def __init__(self, acq, frames):
        self.acq, self._frames = acq, frames

    def buffers(self):
        i = 0
        while True:
            yield self._frames[i % len(self._frames)]
            i += 1


def _stage_properties(dev):
    """tests/test_phytooct.py's stage properties on the card's output: the
    k-lin + dispersion concentration, the sinusoidal residual, the flip
    alignment, each on its small device."""
    from octproz_tpu_torch.io.phytooct import PhytoDeviceConfig, PortableOctSystem
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.params import FpnMode

    def run(sys_, cfg):
        model = FdOctModel(sys_.acq, cfg, **sys_.curve_kwargs(), device=dev)
        return model.fetch(model.process_buffer(sys_.model.buffer(0)))

    def system(**kw):
        return PortableOctSystem(PhytoDeviceConfig(**PHYTO_SMALL, **kw))

    sys_ = system(bidirectional=False, surface_tilt=0.0, fpn_strength=0.0, k_warp=0.25,
                  surface_depth=0.35, n_layers=0)
    base = dataclasses.replace(sys_.recommended_config(), log_scaling=False,
                               fpn_mode=FpnMode.OFF, sinusoidal_correction=False,
                               bscan_flip=False)

    def concentration(cfg):
        ascan = run(sys_, cfg)[0].mean(axis=0)
        peak = int(np.argmax(ascan[4:]) + 4)
        return float(ascan[max(peak - 3, 0):peak + 4].sum() / ascan[4:].sum())

    sharp = concentration(base)
    blurred = concentration(dataclasses.replace(base, resampling=False, dispersion=False))
    sys_.close()
    sys_ = system(bidirectional=False, surface_tilt=0.16, n_layers=0, fpn_strength=0.0)
    cfg = dataclasses.replace(sys_.recommended_config(), fpn_mode=FpnMode.OFF,
                              bscan_flip=False)

    def surface_residual(cfg):
        depths = np.argmax(run(sys_, cfg)[0][:, 4:], axis=1).astype(np.float64)
        a = np.arange(depths.size)
        slope, icept = np.polyfit(a, depths, 1)
        return float(np.abs(depths - (slope * a + icept)).mean())

    corrected = surface_residual(cfg)
    distorted = surface_residual(dataclasses.replace(cfg, sinusoidal_correction=False))
    sys_.close()
    sys_ = system(surface_tilt=0.16, n_layers=0, fpn_strength=0.0)
    cfg = dataclasses.replace(sys_.recommended_config(), fpn_mode=FpnMode.OFF,
                              sinusoidal_correction=False)

    def surfaces(cfg):
        vol = run(sys_, cfg)
        return [np.argmax(vol[i][:, 4:], axis=1).astype(np.float64) for i in (0, 1)]

    d0, d1 = surfaces(cfg)
    d0r, _ = surfaces(dataclasses.replace(cfg, bscan_flip=False))
    sys_.close()
    flipped, unflipped = float(np.abs(d0 - d1).mean()), float(np.abs(d0r - d1).mean())
    log(f"[acq] PhytoOCT stages on the card: concentration {sharp:.4f} calibrated vs "
        f"{blurred:.4f} without k-lin and dispersion; surface residual {corrected:.3f} "
        f"vs {distorted:.3f} without the sinusoidal correction; B-scan 0 vs 1 surface "
        f"{flipped:.3f} flipped vs {unflipped:.3f} unflipped")
    if not (sharp > 1.3 * blurred and sharp > 0.8):
        raise AssertionError("k-lin + dispersion do not concentrate the reflector")
    if not corrected < 0.6 * distorted:
        raise AssertionError("the sinusoidal correction does not linearize the surface")
    if not (flipped < 2.0 and unflipped > 4.0):
        raise AssertionError("the B-scan flip does not align alternate B-scans")


def _acquisition_phytooct(dev):
    """Part 2: the PhytoOCT system registered by a plugin, at the device's
    defaults (1024 samples, 256 A-scans, 8 B-scans, 4 buffers per volume,
    two volumes), through the engine with the plugin's extensions."""
    import tempfile

    from octproz_tpu_torch.io.systems import SystemRegistry
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.plugins import ExtensionManager, PluginContext, load_plugin
    from octproz_tpu_torch.runtime import StreamingEngine

    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "smoke_phyto_plugin.py"), "w") as f:
            f.write(ACQ_PLUGIN)
        sys.path.insert(0, tmp)
        try:
            ctx = PluginContext(extensions=ExtensionManager(), systems=SystemRegistry())
            load_plugin("smoke_phyto_plugin", ctx)
        finally:
            sys.path.remove(tmp)
            sys.modules.pop("smoke_phyto_plugin", None)
        exts = ctx.extensions.extensions
        if ctx.systems.names != ["phytooct"] or len(exts) != 3:
            raise AssertionError(f"the plugin registered {ctx.systems.names}, {list(exts)}")
        seen = {}
        for name, ext in exts.items():
            ext.activate()
            method = "raw_data_received" if ext.wants_raw_data else "processed_data_received"

            def counted(*args, _feed=getattr(ext, method), _name=name):
                seen.setdefault(_name, []).append(args[-1])
                _feed(*args)

            setattr(ext, method, counted)

        system = ctx.systems.activate("phytooct", overrides={"n_volumes": 2})
        try:
            acq = system.acq
            cfg, curve_kw = system.recommended_config(), system.curve_kwargs()
            eng = StreamingEngine(FdOctModel(acq, cfg, **curve_kw, device=dev), system,
                                  extensions=ctx.extensions, stream_to_host=True)
            eng.start_recording(_recording(tmp, "phyto", system.n_buffers))
            t0 = time.perf_counter()
            n, launches = _acquisition_launches(eng.run, lambda n: n - 1,
                                                "PhytoOCT system (plugin)")
            took = time.perf_counter() - t0
            _join_threads((), ENGINE_THREADS)
        finally:
            ctx.systems.deactivate()  # joins the producer, frees the ring
        if n != system.n_buffers or n != 8:
            raise AssertionError(f"PhytoOCT: the engine processed {n} buffers, want 8")
        got = _recorded(eng, n, acq.processed_buffer_shape, "PhytoOCT")
    t0 = time.perf_counter()
    raws = [system.model.buffer(i) for i in range(n)]
    model_ms = (time.perf_counter() - t0) / n * 1e3
    ref = FdOctModel(acq, cfg, **curve_kw, device=dev)
    want = [ref.fetch(ref.process_buffer(raw)) for raw in raws]
    _hold_to_reference(got, want, f"PhytoOCT system ({acq.samples_per_line} samples x "
                                  f"{acq.ascans_per_bscan} A-scans x {acq.bscans_per_buffer} "
                                  f"B-scans, 2 volumes, paced by its camera)")
    log(f"[acq] PhytoOCT: {n} buffers in {took:.3f} s (the device's 20 us line period "
        f"paces {acq.ascans_per_buffer * 20e-6 * n:.3f} s; its numpy model makes a buffer "
        f"in {model_ms:.1f} ms on the host)")
    nrs = [i % acq.buffers_per_volume for i in range(n)]
    if any(seen.get(name) != nrs for name in exts):
        raise AssertionError(f"the extensions saw buffers {seen}, want {nrs} each")
    stats, peaks = exts["image-statistics"].last, exts["peak-detector"].last_peaks
    if stats.histogram.sum() != acq.samples_per_buffer // 2 or not peaks:
        raise AssertionError("the extensions' outputs are empty")
    log(f"[acq] extensions saw every buffer ({nrs}): image statistics mean {stats.mean:.2f} "
        f"of {stats.maximum:.0f}, {len(peaks)} peaks at A-scan (0, 0) (strongest at bin "
        f"{peaks[0].index}), raw maximum {exts['signal-monitor'].last.maximum}")
    _stage_properties(dev)
    return launches


def _timed_search(raw, acq, cfg, curves, device):
    """``estimate_dispersion_coeffs`` with its default search (41 x 41, two
    15 x 15 zooms; up to 512 lines) on ``device``, after a short warm-up
    search there (cuFFT plans): (d2, d3, metric), host seconds."""
    import torch

    from octproz_tpu_torch.extensions import estimate_dispersion_coeffs

    estimate_dispersion_coeffs(raw, acq, cfg, curves, n_grid=5, refine_iters=1, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    found = estimate_dispersion_coeffs(raw, acq, cfg, curves, device=device)
    return found, time.perf_counter() - t0


def _acquisition_dispersion(info, dev):
    """Part 3: the dispersion estimator on the card -- on
    tests/test_extensions.py's chirped interferogram (d2 = 35, d3 = -25),
    which it must recover within 5, and at full width on a PhytoOCT buffer
    at the device's geometry (512 lines of 1024 samples, 32 candidates --
    128 MB of complex64 -- per inverse FFT), held to the same search on the
    host CPU: the sharpness landscape is flat there, so the card and the CPU
    must reach the same best metric (relative 1e-4) and their d2 and d3 are
    logged side by side."""
    import torch

    from octproz_tpu_torch import curves as cv
    from octproz_tpu_torch.io.phytooct import PhytoDeviceConfig, PortableOctSystem
    from octproz_tpu_torch.params import AcqParams, ProcConfig, WindowType

    card = f"{info['device_name']}, power limit {info['power_limit']}"
    candidates = 41 * 41 + 2 * 225
    acq = AcqParams(samples_per_line=256, ascans_per_bscan=32, bscans_per_buffer=1,
                    buffers_per_volume=1, bit_depth=12)
    n, d2_true, d3_true = acq.samples_per_line, 35.0, -25.0
    phi = np.asarray(cv.polynomial_curve(cv.normalize_poly_coeffs(0.0, 0.0, d2_true, d3_true,
                                                                  n), n))
    line = 2000 + 1000 * np.cos(2 * np.pi * 40.0 * np.arange(n) / n + phi)
    raw = np.clip(np.tile(line, (1, acq.ascans_per_bscan, 1)), 0, 4095).astype(np.uint16)
    cfg = ProcConfig(windowing=True, dispersion=True)
    curves = cv.make_curves(acq, cfg, window_type=WindowType.HANNING, device=dev)
    (d2, d3, metric), took = _timed_search(raw, acq, cfg, curves, dev)
    log(f"[acq] dispersion estimator on the card: d2 {d2:.3f}, d3 {d3:.3f} (true 35, -25), "
        f"metric {metric:.6f}, {candidates} candidates of {acq.ascans_per_bscan} x {n} in "
        f"{took:.3f} s ({card})")
    if abs(d2 - d2_true) >= 5.0 or abs(d3 - d3_true) >= 5.0:
        raise AssertionError(f"the estimator found d2 {d2}, d3 {d3}; want 35, -25 within 5")

    system = PortableOctSystem(PhytoDeviceConfig())
    try:
        acq, cfg = system.acq, system.recommended_config()
        raw = system.model.buffer(0)
        found = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            curves = cv.make_curves(acq, cfg, custom_resample_curve=system.model.klin_curve(),
                                    device=device)
            found[where] = _timed_search(raw, acq, cfg, curves, device)
    finally:
        system.close()
    (d2, d3, metric), took = found["card"]
    (cd2, cd3, cmetric), ctook = found["cpu"]
    log(f"[acq] dispersion estimator at full width (PhytoOCT buffer, 512 lines x "
        f"{acq.samples_per_line} samples): card d2 {d2:.3f}, d3 {d3:.3f}, metric {metric:.6e} "
        f"in {took:.3f} s ({card}); host CPU d2 {cd2:.3f}, d3 {cd3:.3f}, metric {cmetric:.6e} "
        f"in {ctook:.3f} s")
    if abs(metric - cmetric) > 1e-4 * abs(cmetric):
        raise AssertionError("the card's full-width search disagrees with the CPU's")


def phase_acquisition(info):
    """The acquisition back ends at full width: see the module docstring,
    phase 7.  Returns B1's and B2's launch counts, summed over the phase's
    engine runs."""
    import torch

    from octproz_tpu_torch import native

    if not native.native_available():
        raise AssertionError("the native host library is not available")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    launches = _acquisition_ring(info, dev)
    for k, v in _acquisition_phytooct(dev).items():
        launches[k] += v
    _acquisition_dispersion(info, dev)
    log(f"[main] acquisition launches {launches}, summed over the engine runs "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches


#: Raycaster agreement, card against CPU (tests/test_torch_viz.py's bounds
#: against the JAX package): each pixel's largest channel difference within
#: RENDER_ATOL; the continuous modes (MIP, DMIP) on every pixel, the modes
#: that threshold each sample on all but RENDER_FLIP_SHARE of the pixels.
RENDER_ATOL = 5e-5
RENDER_FLIP_SHARE = 0.005
RENDER_CONTINUOUS = ("mip", "depth_mip")
#: The dispersion coefficients the application phase's retune sets.
RETUNED_DISPERSION = (0.0, 0.0, 25.0, 0.0)


def _cli_args(dev):
    """The CLI's ``--device`` and the benchmark chain's flags: the preset
    (``models/presets.benchmark_config()``, the two-operator fold path),
    ``bench.FULL_ACQ``'s geometry (the preset's own) and ``bench.CURVE_KW``'s
    curves."""
    from octproz_tpu_torch import bench

    kw, acq = bench.CURVE_KW, bench.FULL_ACQ
    geometry = {"--samples": acq.samples_per_line, "--ascans": acq.ascans_per_bscan,
                "--bscans": acq.bscans_per_buffer,
                "--buffers-per-volume": acq.buffers_per_volume, "--bit-depth": acq.bit_depth}
    return (["--device", "cuda" if dev.type == "cuda" else str(dev)],
            ["--preset", "benchmark", *(str(x) for kv in geometry.items() for x in kv),
             "--klin-coeffs", *map(str, kw["resample_coeffs"]),
             "--disp-coeffs", *map(str, kw["dispersion_coeffs"]),
             "--window-type", kw["window_type"].value])


def _application_cli(dev, tmp):
    """Part 1: ``cli.main([... "process" ...])`` on a raw file of two full
    buffers, against ``process_buffer`` (max difference 0) and the port's
    projections of that volume; ``python -m octproz_tpu_torch info`` in a
    subprocess.  Returns the launches and the processed host volume."""
    import subprocess

    import torch

    from octproz_tpu_torch import bench, cli
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.ops.projections import bscan_frame, enface_frame
    from octproz_tpu_torch.viz.image import decode_png, to_uint8

    acq = bench.FULL_ACQ
    frames = bench.random_buffers(acq, 2, dev, seed=80).cpu().numpy()
    raw = os.path.join(tmp, "two_buffers.raw")
    frames.tofile(raw)
    ref = FdOctModel(acq, bench.bench_config(), **bench.CURVE_KW, device=dev)
    want = np.concatenate([ref.fetch(ref.process_buffer(f)) for f in frames])
    del ref
    out, bpng, epng = (os.path.join(tmp, name) for name in ("cli.raw", "b.png", "e.png"))
    frame_nr, depth_nr = acq.bscans_per_buffer + 7, acq.output_ascan_length // 5
    device, chain = _cli_args(dev)
    argv = [*device, "process", raw, *chain, "--output", out, "--bscan-png", bpng,
            "--frame", str(frame_nr), "--enface-png", epng, "--depth", str(depth_nr)]
    t0 = time.perf_counter()
    rc, launches = _acquisition_launches(lambda: cli.main(argv), lambda rc: 1,
                                         "CLI process (FPN buffer + 1 steady)")
    took = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli process returned {rc}")
    got = np.fromfile(out, np.float32).reshape(want.shape)
    os.remove(raw)
    os.remove(out)
    if not np.array_equal(got, np.clip(want, 0.0, 1.0), equal_nan=True):
        raise AssertionError("cli process output differs from process_buffer: max "
                             f"{np.nanmax(np.abs(got - np.clip(want, 0.0, 1.0)))}")
    on_card = torch.from_numpy(want).to(dev)
    for path, frame in ((bpng, bscan_frame(on_card, frame_nr).T),
                        (epng, enface_frame(on_card, depth_nr))):
        with open(path, "rb") as f:
            pixels = decode_png(f.read())
        expect = to_uint8(np.clip(frame.cpu().numpy(), 0.0, 1.0))
        if not np.array_equal(pixels, expect):
            raise AssertionError(f"{path}: PNG differs from the port's projection")
    del on_card
    log(f"[app] cli process, {'x'.join(map(str, acq.buffer_shape[::-1]))} x 2 buffers: "
        f"output == process_buffer (max difference 0), B-scan {frame_nr} and en-face depth "
        f"{depth_nr} PNGs == the projections on the card; {took:.1f} s with the file I/O")
    proc = subprocess.run([sys.executable, "-m", "octproz_tpu_torch", *device, "info",
                           "--no-entry-point-plugins"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0 or f"CUDA available: {dev.type == 'cuda'}" not in proc.stdout:
        raise AssertionError(f"python -m octproz_tpu_torch info: rc {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr}")
    log("[app] python -m octproz_tpu_torch info: " + " | ".join(proc.stdout.splitlines()[:3]))
    return launches, want[:acq.bscans_per_buffer]


def _render_ms(params, volume, dev):
    """One raycast at 512 x 512 on ``dev`` after a warm-up: (image, CUDA-event
    ms on the render stream, host ms)."""
    import torch

    from octproz_tpu_torch.viz.render import render_volume

    stream = torch.cuda.Stream(dev)
    render_volume(volume, params, yaw=0.5, pitch=0.4, device=dev, stream=stream)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record(stream)
    img = render_volume(volume, params, yaw=0.5, pitch=0.4, device=dev, stream=stream)
    stop.record(stream)
    stop.synchronize()
    return img, start.elapsed_time(stop), (time.perf_counter() - t0) * 1e3


def _application_render(info, volume, dev):
    """Part 2: the seven render modes at 512 x 512 on the full processed
    buffer, timed; each on a cut volume on the card against the CPU."""
    import torch

    from octproz_tpu_torch.viz.render import RenderMode, RenderParams, render_volume

    card = f"{info['device_name']}, power limit {info['power_limit']}"
    on_card = torch.from_numpy(np.ascontiguousarray(volume)).to(dev)
    cut = np.ascontiguousarray(volume[::8, ::8, ::8])
    for mode in RenderMode:
        params = RenderParams(mode=mode)
        img, ms, host_ms = _render_ms(params, on_card, dev)
        if (img.shape != (512, 512, 3) or not np.isfinite(img).all() or img.min() < 0
                or img.max() > 1 or img.max() <= 0.05):
            raise AssertionError(f"render {mode.value}: shape {img.shape}, range "
                                 f"[{img.min()}, {img.max()}] (all background?)")
        got = render_volume(cut, params, yaw=2.2, pitch=-0.8, out_shape=(96, 96), device=dev)
        want = render_volume(cut, params, yaw=2.2, pitch=-0.8, out_shape=(96, 96),
                             device="cpu")
        diff = np.abs(got - want).max(axis=-1)
        share = float(np.mean(diff > RENDER_ATOL))
        limit = 0.0 if mode.value in RENDER_CONTINUOUS else RENDER_FLIP_SHARE
        if share > limit:
            raise AssertionError(f"render {mode.value} on the card vs the CPU: {share:.4f} of "
                                 f"the pixels differ by more than {RENDER_ATOL} (max "
                                 f"{diff.max():.3e})")
        log(f"[app] render {mode.value:<14} {'x'.join(map(str, volume.shape))} -> 512x512, "
            f"step 0.01 ({max(int(3 ** 0.5 / 0.01), 2)} steps): {ms:.3f} ms (CUDA events), "
            f"{host_ms:.3f} ms host; cut {'x'.join(map(str, cut.shape))} card vs CPU: max "
            f"{diff.max():.3e}, {share:.4f} of pixels above {RENDER_ATOL} ({card})")


class _GatedReplay:
    """``frames`` in turn: ``before`` buffers, then a wait for ``gate`` (a
    retune lands meanwhile), then ``after`` more."""

    def __init__(self, acq, frames, before, after, gate):
        self.acq = acq
        self._frames, self._before, self._after, self._gate = frames, before, after, gate

    def buffers(self):
        for i in range(self._before + self._after):
            if i == self._before and not self._gate.wait(60):
                raise TimeoutError("the retune never came")
            yield self._frames[i % len(self._frames)]


def _http(url, body=None):
    import urllib.request

    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def _application_viewer(info, dev, tmp):
    """Part 3: ``StreamingEngine`` with a ``LiveView`` (volume rendering on)
    and a camera on localhost, the two-operator path: a ``POST /control``
    dispersion change mid-stream, every buffer after it equal to a fresh
    model on the new coefficients (the FPN state of the run), every
    endpoint read back."""
    import threading

    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.extensions.camera import CallableCamera, CameraExtension
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.runtime import StreamingEngine
    from octproz_tpu_torch.viz.image import png_size
    from octproz_tpu_torch.viz.live import LiveView

    acq, cfg = bench.FULL_ACQ, bench.bench_config()
    card = f"{info['device_name']}, power limit {info['power_limit']}"
    frames = list(bench.random_buffers(acq, 3, dev, seed=90).cpu().numpy())
    old = FdOctModel(acq, cfg, **bench.CURVE_KW, device=dev)
    first = old.fetch(old.process_buffer(frames[0]))  # the FPN buffer
    new = FdOctModel(acq, cfg, **dict(bench.CURVE_KW, dispersion_coeffs=RETUNED_DISPERSION),
                     device=dev)
    new.fpn_state = old.fpn_state
    refs = {"old": [old.fetch(old.process_buffer(f)) for f in frames],
            "new": [new.fetch(new.process_buffer(f)) for f in frames]}
    del old, new
    gate = threading.Event()
    n_buffers = 8
    eng = StreamingEngine(FdOctModel(acq, cfg, **bench.CURVE_KW, device=dev),
                          _GatedReplay(acq, frames, 3, n_buffers - 3, gate), stream_to_host=True)
    live = LiveView(port=0, volume_render=True, volume_throttle_s=0.0, device=dev)
    camera_frame = np.random.default_rng(91).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    cam = CameraExtension(CallableCamera(lambda: camera_frame))
    eng.extensions.add(cam)
    cam.activate()
    live.attach(eng)
    live.attach_camera(cam)
    eng.start_recording(_recording(tmp, "viewer", n_buffers))
    replies = []

    def retune():
        try:
            while eng.meter.total_buffers < 2 and not gate.is_set():
                time.sleep(0.01)
            replies.append(_http(live.url + "control", {
                "command": "set_dispersion_coeffs",
                **{f"d{i}": v for i, v in enumerate(RETUNED_DISPERSION)}}))
        finally:
            gate.set()

    client = threading.Thread(target=retune, name="smoke-retune")
    client.start()
    try:
        n, launches = _acquisition_launches(eng.run, lambda n: n - 1,
                                            "engine + live viewer + camera, retuned")
        _join_threads((client,), ENGINE_THREADS)
        if n != n_buffers or replies != [(200, b'{"reply": "ok"}')]:
            raise AssertionError(f"viewer run: {n} buffers, control replies {replies}")
        got = _recorded(eng, n, acq.processed_buffer_shape, "viewer run")
        kinds = ["first" if np.array_equal(got[0], first, equal_nan=True) else "?"]
        for i in range(1, n):
            match = [k for k in ("old", "new")
                     if np.array_equal(got[i], refs[k][i % len(frames)], equal_nan=True)]
            kinds.append(match[0] if len(match) == 1 else "?")
        if ("?" in kinds or kinds[1:] != sorted(kinds[1:], key=lambda k: k == "new")
                or kinds.count("new") < 4):
            raise AssertionError(f"streamed buffers against the old/new coefficients: {kinds}")
        log(f"[app] POST /control set_dispersion_coeffs {RETUNED_DISPERSION} mid-stream: "
            f"buffers {kinds} -- each equal (max difference 0) to a fresh model on the "
            f"coefficients it names, with the run's FPN state; never a mix")
        url = live.url
        sizes = {}
        for name in ("bscan.png", "enface.png", "volume.png", "camera.png"):
            status, body = _http(url + name)
            sizes[name] = png_size(body)
        want_sizes = {"bscan.png": (acq.ascans_per_bscan, acq.output_ascan_length),
                      "enface.png": (acq.ascans_per_bscan, acq.bscans_per_buffer),
                      "volume.png": (live.volume_size, live.volume_size),
                      "camera.png": (640, 480)}
        if sizes != want_sizes:
            raise AssertionError(f"PNG endpoints: {sizes}, want {want_sizes}")
        doc = {name: json.loads(_http(url + name)[1]) for name in (
            "ascan.json", "stats.json", "params.json", "render.json",
            "extension.json?name=camera", "display.json")}
        if (len(doc["ascan.json"]["values"]) != acq.output_ascan_length
                or doc["stats.json"].get("volume_renders", 0) < 1
                or doc["stats.json"]["camera"] is not True
                or doc["params.json"]["dispersion_coeffs"] != list(RETUNED_DISPERSION)
                or len(doc["render.json"]["modes"]) != 7
                or doc["extension.json?name=camera"]["name"] != "camera"):
            raise AssertionError(f"JSON endpoints: {doc}")
        before = _http(url + "volume.png")[1]
        t0 = time.perf_counter()
        status, reply = _http(url + "render", {"mode": "xray", "yaw": 1.4})
        refresh_ms = (time.perf_counter() - t0) * 1e3
        if status != 200 or _http(url + "volume.png")[1] == before:
            raise AssertionError(f"POST /render: {status} {reply[:200]}")
        host_volume = eng.assembler.volume
        t0 = time.perf_counter()
        for _ in range(3):
            torch.as_tensor(host_volume, device=dev)
            torch.cuda.synchronize(dev)
        upload_ms = (time.perf_counter() - t0) / 3 * 1e3
        log(f"[app] endpoints: {sizes}; ascan {len(doc['ascan.json']['values'])} values, "
            f"stats {doc['stats.json']['buffers']} buffers / "
            f"{doc['stats.json']['volume_renders']} volume renders, params, 7 render modes, "
            f"camera pane")
        log(f"[app] viewer /volume.png refresh (POST /render xray, "
            f"{'x'.join(map(str, host_volume.shape))} assembled host volume -> "
            f"{live.volume_size}x{live.volume_size}, step 0.02): {refresh_ms:.1f} ms round trip, "
            f"{live.last_render_ms:.1f} ms in the raycast call; the volume's copy to the card "
            f"alone {upload_ms:.1f} ms ({host_volume.nbytes / 1e6:.0f} MB, pageable) ({card})")
    finally:
        gate.set()
        live.close()
    return launches


def _application_rates(info, dev):
    """Part 4: the engine's rate on the two-operator path from RAM, without
    and with a live viewer (volume rendering on, default throttles)."""
    from octproz_tpu_torch import bench
    from octproz_tpu_torch.viz.live import LiveView

    acq, cfg = bench.FULL_ACQ, bench.bench_config()
    card = f"{info['device_name']}, power limit {info['power_limit']}"
    frames = list(bench.random_buffers(acq, 3, dev, seed=95).cpu().numpy())
    totals, rates, views = {"depth": 0, "depth_scale": 0}, {}, []

    def with_viewer(eng):
        views.append(LiveView(port=0, volume_render=True, device=dev))
        views[-1].attach(eng)

    for tag, attach in (("without the viewer", None), ("with the viewer", with_viewer)):
        try:
            rates[tag], launches = _acquisition_launches(
                lambda: bench.engine_rate(cfg, dev, _Replay(acq, frames), "uint16",
                                          seconds=3.0, attach=attach),
                lambda r: r["buffers"] - 1, f"engine rate {tag}")
        finally:
            for view in views:
                view.close()
        _join_threads((), ENGINE_THREADS)
        for k in totals:
            totals[k] += launches[k]
    view = views[0]
    log("[app] engine, two-operator path (default rung), uint16 from RAM: "
        + "; ".join(f"{tag} {r['mhz']:.3f} MHz ({r['timed_buffers']} buffers in "
                    f"{r['timed_s']:.3f} s)" for tag, r in rates.items())
        + f"; viewer {view.frames_rendered} frames, {view.volume_renders} volume renders "
          f"({card})")
    log("[app] the viewer's work per buffer on the engine's drain thread, host clock: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in _viewer_stages(view).items()) + f" ({card})")
    return totals


def _viewer_stages(view):
    """The host stages an attached viewer adds to a full buffer of 12-bit
    codes, each timed alone: the assembler's dequantize and its copy into
    the volume (every buffer), the 2-D frames' update with their PNGs (at
    most every 80 ms) and the volume pane's raycast with the volume's copy
    to the device (at most every second)."""
    from octproz_tpu_torch.ops.quantize import dequantize

    codes = np.random.default_rng(96).integers(0, 4096, view._assembler.volume.shape,
                                               dtype=np.uint16)
    out, t0 = {}, time.perf_counter()
    deq = dequantize(codes, 12)
    out["dequantize"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    view._assembler.add(deq, 0)
    out["assembler copy"] = (time.perf_counter() - t0) * 1e3
    view.throttle_s, view.volume_throttle_s, view._last_render = 0.0, float("inf"), 0.0
    t0 = time.perf_counter()
    view.update(codes, 0)
    out["2-D frames + PNGs"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    view._render_assembled_volume()
    out["volume raycast with its copy to the device"] = (time.perf_counter() - t0) * 1e3
    return out


def _application_screenshots(dev, tmp):
    """Part 5: a recording with ``save_screenshots=True`` leaves B-scan,
    en-face and render PNGs that decode to their sizes."""
    import glob

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.io.recorder import RecordingParams
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.runtime import StreamingEngine
    from octproz_tpu_torch.viz.image import decode_png

    acq = bench.FULL_ACQ
    frames = list(bench.random_buffers(acq, 2, dev, seed=97).cpu().numpy())
    messages = []
    eng = StreamingEngine(FdOctModel(acq, bench.bench_config(), **bench.CURVE_KW, device=dev),
                          _Replay(acq, frames), stream_to_host=True, on_info=messages.append)
    directory = os.path.join(tmp, "shots")
    eng.start_recording(RecordingParams(save_dir=directory, name="shot", buffers_to_record=1,
                                        save_raw=False, save_processed=True, save_meta=False,
                                        save_screenshots=True))
    _, launches = _acquisition_launches(lambda: eng.run(max_buffers=3), lambda n: 2,
                                        "recording with screenshots")
    _join_threads((), ENGINE_THREADS)
    shapes = {}
    for kind in ("bscan", "enface", "volume"):
        paths = glob.glob(os.path.join(directory, f"*shot*_{kind}.png"))
        if len(paths) != 1:
            raise AssertionError(f"screenshots: {paths} for {kind}; messages {messages}")
        with open(paths[0], "rb") as f:
            shapes[kind] = decode_png(f.read()).shape
    want = {"bscan": (acq.output_ascan_length, acq.ascans_per_bscan),
            "enface": (acq.bscans_per_buffer, acq.ascans_per_bscan), "volume": (256, 256, 3)}
    if shapes != want:
        raise AssertionError(f"screenshots decode to {shapes}, want {want}")
    log(f"[app] recording screenshots: {shapes} decoded; {messages[-1]!r}")
    return launches


#: Buffers ``replay --live`` streams in the application phase (the file's
#: two buffers, replayed in turn).
REPLAY_BUFFERS = 12


def _application_replay_live(dev, tmp):
    """Part 5: ``cli.main``'s ``replay`` with ``--live --live-volume`` on a
    raw file of two full buffers (the benchmark chain's flags), in a thread:
    ``/render.json`` and ``/volume.png`` fetched from its viewer while it
    streams, then its return code 0, the viewer's port closed and the
    thread, the engine's and the viewer's threads joined.  Returns the
    launches (B1 once, B2 once per steady buffer)."""
    import socket
    import threading

    from octproz_tpu_torch import bench, cli
    from octproz_tpu_torch.viz.image import png_size

    acq = bench.FULL_ACQ
    raw = os.path.join(tmp, "replay.raw")
    bench.random_buffers(acq, 2, dev, seed=97).cpu().numpy().tofile(raw)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}/"
    device, chain = _cli_args(dev)
    argv = [*device, "replay", raw, *chain, "--live", "--live-port", str(port),
            "--live-volume", "--max-buffers", str(REPLAY_BUFFERS), "--wait-us", "20000"]

    def run():
        result = {}
        thread = threading.Thread(target=lambda: result.update(rc=cli.main(argv)),
                                  name="octproz-replay-live")
        t0 = time.perf_counter()
        thread.start()
        while thread.is_alive() and "png" not in result:
            try:
                result["render"] = json.loads(_http(url + "render.json")[1])
                png = _http(url + "volume.png")[1]
                if png.startswith(b"\x89PNG\r\n\x1a\n"):
                    result["png"] = png
            except OSError:
                pass  # the viewer is not up yet
            time.sleep(0.1)
        _join_threads((thread,), (*ENGINE_THREADS, "octproz-liveview"))
        result["s"] = time.perf_counter() - t0
        return result

    result, launches = _acquisition_launches(run, lambda r: REPLAY_BUFFERS - 1,
                                             "replay --live")
    os.remove(raw)
    if result.get("rc") != 0:
        raise AssertionError(f"replay --live returned {result.get('rc')}")
    if "png" not in result or len(result["render"].get("modes", ())) != 7:
        raise AssertionError(f"replay --live: /render.json {result.get('render')} and no "
                             f"/volume.png while it streamed")
    try:
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
    except OSError:
        pass
    else:
        raise AssertionError(f"replay --live left its viewer's port {port} open")
    log(f"[app] cli replay --live --live-volume, {REPLAY_BUFFERS} full buffers: /render.json "
        f"({len(result['render']['modes'])} modes) and /volume.png "
        f"({'x'.join(map(str, png_size(result['png'])))}) read while it streamed; rc 0, the "
        f"viewer closed, its threads joined ({result['s']:.1f} s)")
    return launches


def phase_application(info, dev=None):
    """The host application at full width: see the module docstring, phase
    8.  Returns B1's and B2's launch counts, summed over the phase's runs."""
    import tempfile

    import torch

    dev = torch.device("cuda", 0) if dev is None else dev
    t0 = time.perf_counter()
    totals = {"depth": 0, "depth_scale": 0}
    with tempfile.TemporaryDirectory() as tmp:
        launches, volume = _application_cli(dev, tmp)
        _application_render(info, volume, dev)
        del volume
        for part in (_application_viewer(info, dev, tmp), _application_rates(info, dev),
                     _application_screenshots(dev, tmp), _application_replay_live(dev, tmp)):
            for k in totals:
                totals[k] += part[k]
    for k in totals:
        totals[k] += launches[k]
    log(f"[main] application launches {totals}, summed over the phase's runs "
        f"({time.perf_counter() - t0:.1f} s)")
    return totals


#: Wall-clock limit of the mesh phase's rank processes (all three together).
MESH_PROCESS_TIMEOUT_S = 420.0


def _max_diff(got, want, tag):
    """Max |got - want| over the finite voxels; fails on other finite masks
    or outside rtol = atol = 2e-4 (tests/test_sharding.py's bound)."""
    import torch

    from octproz_tpu_torch.scaling import max_abs_diff

    diff = max_abs_diff(got, want)
    if diff == float("inf"):
        raise AssertionError(f"{tag}: finite masks differ")
    if not torch.allclose(got, want, rtol=2e-4, atol=2e-4):
        raise AssertionError(f"{tag}: sharded output != single-device output "
                             f"(max difference {diff:.3e})")
    return diff


def _mean_line_witness(sharded, single, raw, tag):
    """The two mean lines of an FPN buffer against its exact segment means.

    The noise lines' depth profiles (B1 on ``raw``, the buffer both models
    determined their FPN state on) are summed per segment in float64: the
    exact means of the float32 summands.  Any order of float32 summation
    (the single device's whole segment, or a mesh's partial sums added)
    followed by the scaling by 1/w stays within gamma_(w+2) * sum|x| / w of
    them (w lines per segment, gamma_n = n u / (1 - n u), u = 2^-24); a line
    dropped, doubled or put in the wrong segment moves a mean by about
    |x| / w, far outside.  Per component and bin of the selected segment:
    the bound and the exact mean, and where each line lies.  Returns
    (sharded bins out of the bound, single-device bins out of it, per-bin
    tensors for the log)."""
    import torch

    from octproz_tpu_torch.ops import fpn
    from octproz_tpu_torch.params import FPN_SEGMENTS
    from octproz_tpu_torch.parallel import sharding

    acq, cfg = single.acq, single.cfg
    half = acq.output_ascan_length
    w = min(cfg.bscans_for_noise, acq.bscans_per_buffer) * acq.ascans_per_bscan // FPN_SEGMENTS
    z_re, z_im = sharding._core_local(torch.as_tensor(raw).to(single.device), single.curves,
                                      acq, cfg)
    re, im = (z.reshape(-1, half)[:FPN_SEGMENTS * w] for z in (z_re, z_im))
    del z_re, z_im
    # the segment each bin selects, from the single-device order's statistics
    s_re, s_im, s_sq, _ = fpn.segment_sums_planar(re, im)
    f = torch.tensor(1.0 / w, dtype=torch.float32)
    m_re, m_im = s_re * f, s_im * f
    best = fpn._banded_argmin(s_sq * f - (m_re * m_re + m_im * m_im),
                              torch.mean(s_sq * f, dim=0))[None, :]
    exact, scale = [], []
    for x in (re, im):
        seg = x.reshape(FPN_SEGMENTS, w, half).to(torch.float64)
        exact.append(torch.gather(seg.sum(dim=1) / w, 0, best)[0])
        scale.append(torch.gather(seg.abs().sum(dim=1) / w, 0, best)[0])
    exact, scale = torch.stack(exact), torch.stack(scale)
    n_u = (w + 2) * 2.0 ** -24
    bound = n_u / (1.0 - n_u) * scale
    got = sharded.fpn_state.mean_line.to(torch.float64)
    want = single.fpn_state.mean_line.to(torch.float64)
    out_m = int(((got - exact).abs() > bound).sum())
    out_s = int(((want - exact).abs() > bound).sum())
    # which segments the mesh cuts: lines of one segment in several blocks
    bs, as_ = sharding._block_sizes(acq.buffer_shape, sharded.mesh)
    line = torch.arange(FPN_SEGMENTS * w)
    block = (line // acq.ascans_per_bscan // bs) * 1_000_000 + (line % acq.ascans_per_bscan) // as_
    cut = [len(torch.unique(b)) > 1 for b in block.reshape(FPN_SEGMENTS, w)]
    log(f"[mesh] {tag}: mean-line witness: {w} lines per segment, segments cut by the mesh "
        f"{[k for k, c in enumerate(cut) if c]}; bins out of the float32 summation bound of "
        f"the float64 segment mean: mesh {out_m}, single device {out_s}; worst |line - exact| "
        f"/ bound: mesh {float(((got - exact).abs() / bound).max()):.3f}, single device "
        f"{float(((want - exact).abs() / bound).max()):.3f}")
    return out_m, out_s, dict(exact=exact, bound=bound, best=best[0].cpu(), cut=cut)


def _mesh_parity(sharded, single, bufs, want, tag, witness=False):
    """The sharded model over ``bufs`` (launches read around it), then the
    single-device model on the same buffers: every output within 2e-4, the
    mean line within 1e-4/1e-5 elementwise.  ``witness`` (for a mesh that
    cuts FPN segments, whose partial sums add in another order): where the
    elementwise limit does not hold, the bins are logged and both lines must
    lie within the float32 summation bound of the exact segment means
    (:func:`_mean_line_witness`) at every bin.  Returns the launches and the
    max differences."""
    import torch

    from octproz_tpu_torch.parallel.sharding import row_blocks

    dev = single.device
    outs, launches = _exact_launches(lambda: [sharded.process_buffer(b) for b in bufs],
                                     want, tag)
    diff = max(_max_diff(torch.cat([t.to(dev) for _, t in row_blocks(o)]),
                         single.process_buffer(b), tag) for o, b in zip(outs, bufs))
    del outs
    a, b = sharded.fpn_state.mean_line, single.fpn_state.mean_line
    limit = 1e-5 + 1e-4 * b.abs()
    over = (a - b).abs() > limit
    if witness:
        out_m, out_s, w = _mean_line_witness(sharded, single, bufs[0], tag)
        half = b.shape[1]
        ranked = sorted(torch.nonzero(over.flatten()).flatten().tolist(),
                        key=lambda k: -float(((a - b).abs() / limit).flatten()[k]))
        for k in ranked[:4]:
            c, n = divmod(k, half)
            seg = int(w["best"][n])
            log(f"[mesh] {tag}: mean line misses 1e-4/1e-5 at {('re', 'im')[c]} bin {n} "
                f"(segment {seg}, {'cut' if w['cut'][seg] else 'not cut'} by the mesh): "
                f"single {float(b[c, n])!r}, mesh {float(a[c, n])!r}, difference "
                f"{float((a - b).abs()[c, n]):.3e} > limit {float(limit[c, n]):.3e}; exact "
                f"{float(w['exact'][c, n])!r}, float32 summation bound "
                f"{float(w['bound'][c, n]):.3e}")
        log(f"[mesh] {tag}: mean line max difference {float((a - b).abs().max()):.3e}; "
            f"elementwise 1e-4/1e-5 misses {int(over.sum())} of {over.numel()} bins")
        ok = out_m == 0 and out_s == 0
        why = f"; out of the float32 summation bound: mesh {out_m}, single device {out_s}"
    else:
        ok, why = not bool(over.any()), ""
    if not ok:
        raise AssertionError(f"{tag}: mean line differs ({float((a - b).abs().max()):.3e}, "
                             f"{int(over.sum())} bins over 1e-4/1e-5{why})")
    return launches, diff, float((a - b).abs().max())


def _mesh_bscan(dev):
    """Part 1: the benchmark chain on make_mesh(4, 1, [cuda:0] * 4)."""
    from octproz_tpu_torch import bench
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.params import FpnMode
    from octproz_tpu_torch.parallel import make_mesh, traffic

    acq = bench.FULL_ACQ
    mesh = make_mesh(4, 1, devices=[dev] * 4)
    bufs = list(bench.random_buffers(acq, 5, dev, seed=110))
    totals = {"depth": 0, "depth_scale": 0}
    for changes, what in (({}, "noise lines on shard 0"),
                          ({"bscans_for_noise": 96}, "noise lines over 96 B-scans, shards 0-1")):
        cfg = bench.bench_config(**changes)
        sharded = FdOctModel(acq, cfg, **bench.CURVE_KW, mesh=mesh)
        single = FdOctModel(acq, cfg, **bench.CURVE_KW, device=dev)
        tag = f"mesh (4, 1) benchmark chain, {what}"
        launches, diff, mean_diff = _mesh_parity(sharded, single, bufs,
                                                 {"depth": 4, "depth_scale": 16}, tag)
        tally = sharded._exec[2].tally.summary()
        if tally["by_op"] != {"all_reduce": traffic.expected_fpn_psum_bytes(acq)}:
            raise AssertionError(f"{tag}: transfers {tally['by_op']}")
        log(f"[mesh] {tag}: FPN buffer + 4 steady, launches {launches} (B1 once and B2 once "
            f"per steady buffer on each of 4 shards, on the tensor cores); max difference to "
            f"the single-device model {diff:.3e} (bound 2e-4), mean line {mean_diff:.3e} "
            f"(1e-4/1e-5); transfers {tally['by_op']} bytes")
        for k in totals:
            totals[k] += launches.get(k, 0)
    cfg = bench.bench_config(fpn_mode=FpnMode.OFF)
    sharded = FdOctModel(acq, cfg, **bench.CURVE_KW, mesh=mesh)
    single = FdOctModel(acq, cfg, **bench.CURVE_KW, device=dev)
    tag = "mesh (4, 1) benchmark chain, FPN off"
    launches, diff, _ = _mesh_parity(sharded, single, bufs[:2], {"depth_scale": 8}, tag)
    log(f"[mesh] {tag}: 2 buffers, launches {launches}; max difference to the single-device "
        f"model {diff!r} (each line's work is the single-device work); transfers "
        f"{sharded._exec[2].tally.summary()['total_bytes']} bytes")
    totals["depth_scale"] += launches["depth_scale"]
    return totals


def _mesh_handheld(dev):
    """Part 2: the handheld preset (flip, sinusoidal correction) with post
    background removal on make_mesh(2, 2, [cuda:0] * 4): whole-row gathers."""
    from octproz_tpu_torch import bench
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.models.presets import handheld_sinusoidal_config
    from octproz_tpu_torch.parallel import make_mesh

    acq = bench.FULL_ACQ
    cfg = dataclasses.replace(handheld_sinusoidal_config(tpu=True), post_background_removal=True)
    kw = dict(bench.CURVE_KW, post_background=np.linspace(
        0.0, 0.05, acq.output_ascan_length, dtype=np.float32))
    bufs = list(bench.random_buffers(acq, 3, dev, seed=120))
    sharded = FdOctModel(acq, cfg, **kw, mesh=make_mesh(2, 2, devices=[dev] * 4))
    single = FdOctModel(acq, cfg, **kw, device=dev)
    tag = "mesh (2, 2) handheld preset + post background"
    launches, diff, mean_diff = _mesh_parity(sharded, single, bufs,
                                             {"depth": 4, "depth_scale": 8}, tag,
                                             witness=True)
    by_op = sharded._exec[2].tally.summary()["by_op"]
    row = (acq.bscans_per_buffer // 2) * (acq.ascans_per_bscan // 2) * acq.output_ascan_length * 4
    want = {"all_reduce": 55296, "row_gather": 3 * 2 * row, "row_scatter": 3 * 2 * row}
    if by_op != want:
        raise AssertionError(f"{tag}: transfers {by_op}, want {want}")
    log(f"[mesh] {tag}: FPN buffer + 2 steady, launches {launches}; max difference to the "
        f"single-device model {diff:.3e}, mean line {mean_diff:.3e}; transfers {by_op} bytes "
        f"(each row's second block to its first and back, per buffer)")
    return launches


def _mesh_engine(info, dev, tmp):
    """Part 3: StreamingEngine over FdOctModel(mesh=...) from RAM on both
    wires: the recorded float32 stream == process_buffer on the mesh,
    packed-12 == uint16 (exact); the engine's rate beside the
    single-device engine's (information only)."""
    from octproz_tpu_torch import bench
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.parallel import make_mesh
    from octproz_tpu_torch.runtime import StreamingEngine

    acq, cfg = bench.FULL_ACQ, bench.bench_config()
    card = f"{info['device_name']}, power limit {info['power_limit']}"
    mesh = make_mesh(4, 1, devices=[dev] * 4)
    sources = bench.stream_sources(tmp)
    ref = FdOctModel(acq, cfg, **bench.CURVE_KW, mesh=mesh)
    want = np.stack([ref.fetch(ref.process_buffer(sources["uint16"].read_buffer(i)))
                     for i in range(2)])
    del ref
    totals, recorded, rates = {"depth": 0, "depth_scale": 0}, {}, {}
    for wire, src in sources.items():
        tag = f"mesh (4, 1) engine, {wire} wire"
        eng = StreamingEngine(FdOctModel(acq, cfg, **bench.CURVE_KW, mesh=mesh), src,
                              wire_format=wire, stream_to_host=True)
        eng.start_recording(_recording(tmp, f"mesh{wire}", 2))
        _, launches = _exact_launches(lambda: eng.run(max_buffers=2),
                                     {"depth": 4, "depth_scale": 4}, tag)
        recorded[wire] = _recorded(eng, 2, acq.processed_buffer_shape, tag)
        if not np.array_equal(recorded[wire], want):
            raise AssertionError(f"{tag}: recorded float32 stream != process_buffer on the "
                                 f"mesh (max {np.nanmax(np.abs(recorded[wire] - want)):.3e})")
        for k in totals:
            totals[k] += launches[k]
        for shards, m in ((4, mesh), (1, None)):
            rate, launches = _exact_launches(
                lambda: bench.engine_rate(cfg, dev, src, wire, seconds=3.0, mesh=m),
                lambda r: {"depth": shards, "depth_scale": shards * (r["buffers"] - 1)},
                f"{tag} rate, {shards} shard(s)")
            rates[(wire, shards)] = rate
            for k in totals:
                totals[k] += launches[k]
    if not np.array_equal(recorded["packed12"], recorded["uint16"]):
        raise AssertionError("mesh engine: packed-12 wire output != uint16 wire output")
    log("[mesh] engine on (4, 1): recorded float32 stream == process_buffer on the mesh "
        "(exact) on both wires; packed-12 == uint16 (exact)")
    for (wire, shards), r in rates.items():
        log(f"[mesh] engine, {wire} wire, {'(4, 1) mesh' if shards == 4 else 'single device'}: "
            f"{r['mhz']:.3f} MHz A-scans ({r['timed_buffers']} buffers in {r['timed_s']:.3f} s "
            f"after warm-up) ({card})")
    return totals


def _mesh_processes(tmp):
    """Parts 4 and 5: ``python -m octproz_tpu_torch.parallel.multihost
    --selftest --full`` as two ranks of a gloo world on cuda:0 (NCCL
    refuses two ranks on one GPU) and as the one rank of an NCCL world,
    all three fresh processes started together (CUDA and fork do not mix;
    each loads the kernels built above from their cache).  Each rank feeds
    its B-scan block of three buffers, holds its fetched block to a
    single-device model and reports its readings as a JSON line; the wait
    has a deadline, after which every rank is killed and the phase fails
    (``scaling.launch_ranks``)."""
    from octproz_tpu_torch.scaling import launch_ranks

    runs = [("gloo", 2, 0), ("gloo", 2, 1), ("nccl", 1, 0)]
    outs = launch_ranks(
        [(["octproz_tpu_torch.parallel.multihost", "--selftest", "--full", "--rank", str(rank),
           "--world", str(world), "--init", f"file://{tmp}/rendezvous-{name}"], rank, world)
         for name, world, rank in runs], MESH_PROCESS_TIMEOUT_S, "mesh ranks")
    totals = {"depth": 0, "depth_scale": 0}
    for (name, world, rank), out in zip(runs, outs):
        tag = f"{name} world of {world}, rank {rank}"
        result = json.loads([l for l in out.splitlines() if l.startswith("{")][-1])
        want = {"depth": 1, "depth_scale": 2}
        if (result["via"] != name or result["all_reduce_bytes"] != 55296
                or result["launches"] != want
                or any(set(r) != {"tensor_core"} for r in result["routes"].values())):
            raise AssertionError(f"{tag}: {result}; want via {name}, all_reduce 55296 B, "
                                 f"launches {want} on the tensor cores")
        log(f"[mesh] {tag} ({name}, one process each): B-scans {result['bscans']}, FPN buffer "
            f"+ 2 steady == single-device model (max difference {result['max_abs_diff']:.3e}); "
            f"all_reduce {result['all_reduce_bytes']} B via {result['via']}; launches "
            f"{result['launches']} routes {result['routes']}")
        for k in totals:
            totals[k] += result["launches"][k]
    return totals


def _mesh_times(info, dev):
    """Part 6: CUDA-event ms per steady buffer of the sharded step beside
    the single-device step, both in this call, and the host's time to
    enqueue one (ten calls on the host clock, no sync between them)."""
    import itertools

    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.models.presets import handheld_sinusoidal_config
    from octproz_tpu_torch.parallel import make_mesh

    acq = bench.FULL_ACQ
    card = f"{info['device_name']}, power limit {info['power_limit']}"
    bufs = list(bench.random_buffers(acq, 4, dev, seed=130))
    for what, cfg, shape in (("benchmark chain", bench.bench_config(), (4, 1)),
                             ("handheld preset", handheld_sinusoidal_config(tpu=True), (2, 2))):
        times, host = {}, {}
        for label, mesh in ((f"{shape} mesh", make_mesh(*shape, devices=[dev] * 4)),
                            ("single device", None)):
            model = FdOctModel(acq, cfg, **bench.CURVE_KW, device=dev, mesh=mesh)
            model.process_buffer(bufs[0])  # FPN determination
            turn = itertools.count()
            times[label] = bench.cuda_ms(lambda: model.process_buffer(bufs[next(turn) % 4]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(10):
                model.process_buffer(bufs[i % 4])
            host[label] = (time.perf_counter() - t0) * 100.0
            torch.cuda.synchronize()
            del model
        log(f"[mesh] {what} steady state: "
            + ", ".join(f"{k} {v:.3f} ms/buffer ({acq.ascans_per_buffer / v / 1e3:.3f} MHz; "
                        f"host enqueue {host[k]:.3f} ms)" for k, v in times.items())
            + f" ({card})")


def phase_mesh(info, dev=None):
    """The sharded step at full width on one card: see the module
    docstring, phase 9.  Returns B1's and B2's launch counts, summed over
    the phase's runs (the rank processes' sharded models included)."""
    import tempfile

    import torch

    dev = torch.device("cuda", 0) if dev is None else dev
    t0 = time.perf_counter()
    totals = _mesh_bscan(dev)
    for k, v in _mesh_handheld(dev).items():
        totals[k] += v
    with tempfile.TemporaryDirectory() as tmp:
        for part in (_mesh_engine(info, dev, tmp), _mesh_processes(tmp)):
            for k in totals:
                totals[k] += part[k]
    _mesh_times(info, dev)
    log(f"[main] mesh launches {totals}, summed over the phase's runs "
        f"({time.perf_counter() - t0:.1f} s)")
    return totals


#: Launches of the bf16 main path (phase_bf16_path): per path buffer 0
#: (FPN determination; the fold paths' planar kernel), then on the fold
#: paths three steady buffers, a batch chunk of four (one launch) and one
#: more buffer, on the FFT paths four steady buffers and a scan chunk of
#: four (a launch per buffer).
BF16_MAIN_LAUNCHES = {"depth": 2, "depth_scale": 5, "depth_scale_concat": 5,
                      "prep_phase": 9, "prep_real": 9}


def phase_bf16_path(worst):
    """``default_full_config()`` at ``compute_dtype="bfloat16"`` on full
    1024 x 512 x 256 buffers through ``FdOctModel``: the fold path, the
    concat path and the FFT path with dispersion (phase kernel) and without
    (real kernel), between one reset and one read of the launch counts.
    Every launch of the five families must be on the bf16 route, none on
    the three-part one-pass route or a split rung,
    as many as the runs dispatch (``BF16_MAIN_LAUNCHES``).  Then each
    steady output and buffer 0's planar GEMM at full size: the scaled ones
    against the float64 product of the rounded operands, the others
    against their plain versions."""
    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.models.fdoct import FdOctModel

    dev = torch.device("cuda", 0)
    acq = bench.FULL_ACQ
    host_raw = np.random.default_rng(50).integers(0, 4096, size=acq.buffer_shape,
                                                  dtype=np.uint16)
    bufs = bench.random_buffers(acq, 4, dev, seed=51)
    bf16 = dict(compute_dtype="bfloat16")
    models = {"fold": FdOctModel(acq, bench.bench_config(**bf16), **bench.CURVE_KW, device=dev),
              "concat": FdOctModel(acq, bench.bench_config(fold_concat=True, **bf16),
                                   **bench.CURVE_KW, device=dev),
              "FFT, dispersion": FdOctModel(acq, bench.fft_config(**bf16), **bench.CURVE_KW,
                                            device=dev),
              "FFT, no dispersion": FdOctModel(acq, bench.fft_config(dispersion=False, **bf16),
                                               **bench.CURVE_KW, device=dev)}
    torch.cuda.synchronize()

    fp.reset_launch_counts()
    t0 = time.perf_counter()
    steady = {}
    for name, model in models.items():
        if model.cfg.fft_via_matmul:
            steady[name] = _run_main_path(model, host_raw, bufs, f"bf16 {name} path")
        else:
            _run_fft_path(model, host_raw, bufs, f"bf16 {name}")
    launches = _read_launches(tuple(BF16_ROWS), t0, "bf16 path")
    others = {k: v for k, v in fp.LAUNCHES.items() if v and k not in BF16_ROWS}
    if launches != BF16_MAIN_LAUNCHES or others:
        raise AssertionError(f"bf16 path launched {launches} and {others}; want "
                             f"{BF16_MAIN_LAUNCHES} and nothing else")
    _check_routes(launches, "bf16 path", route="tensor_core_bf16")

    for name, (out, raw) in steady.items():
        family, err = _check_steady_full_size(models[name], out, raw)
        worst[family] = max(worst[family], err)
    del steady
    cv = models["fold"].curves
    raw0 = torch.from_numpy(host_raw).to(dev).reshape(-1, acq.samples_per_line)
    err, detail, ok = _compare(raw0, *cv.depth_parts, True, None, None, None)
    worst["depth_bf16"] = max(worst["depth_bf16"], err)
    log(f"[bf16] depth full buffer 0 (bf16) vs plain version: {detail} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("full-size bf16 depth output disagrees with the plain version")
    raw2d = bufs[0].reshape(-1, acq.samples_per_line)
    for name, epi in (("FFT, dispersion", "phase"), ("FFT, no dispersion", "real")):
        cv = models[name].curves
        rows = (cv.phase.real.contiguous(), cv.phase.imag.contiguous()) \
            if epi == "phase" else None
        err, detail, ok = _compare_prep(raw2d, cv.prep_parts, rows, True)
        worst[f"prep_{epi}_bf16"] = max(worst[f"prep_{epi}_bf16"], err)
        log(f"[bf16] prep_{epi} full buffer (bf16) vs plain version: {detail} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"full-size bf16 prep_{epi} output disagrees with the "
                                 f"plain version")
    return launches


#: B-scans per buffer of the configuration matrix (``phase_configurations``):
#: full-width lines, 512 A-scans of 1024 samples, 4096 lines a buffer.
CONFIG_BSCANS = 8
#: The card's output against the port's on the CPU, as the CPU tests hold
#: the port to the JAX package (tests/test_torch_pipeline.py: SCALE_ATOL,
#: ``_same_fpn``): |card - CPU| <= 1e-4 display units over the shown
#: voxels, one bf16 step (``fused_prep.BF16_STEP`` |CPU|) more on a bf16
#: store; FPN mean lines within rtol 1e-5 and an absolute 1e-5 of the
#: line's largest value.
#:
#: The port's one rule for an output against the float64 products, at any
#: size (``config_near_exact`` against ``image_f64``; the CPU tests hold
#: every configuration by it, tests/test_torch_exact_rule.py, and this
#: script holds the card's outputs by it at 4096 lines and at full depth):
#: every shown voxel within ``CONFIG_ATOL``, one bf16 step more on a bf16
#: store, except at most a ``CONFIG_DEEP_SHARE`` share of the shown voxels,
#: each of which within ``CONFIG_ATOL`` plus Higham's float32 bound of its
#: depth sum.
CONFIG_ATOL = 1e-4
CONFIG_FPN_RTOL = 1e-5
#: The share of the shown voxels the rule lets past ``CONFIG_ATOL`` (the
#: share ``_check_output`` allows voxels at -inf).  A share, not a count or
#: a per-voxel maximum: whether a voxel meets ``CONFIG_ATOL`` depends on
#: that voxel's float32 condition -- the sum of its terms' magnitudes over
#: its value, large only in the deepest nulls --, not on how many voxels a
#: check compares; so the voxels past it grow with the voxels compared
#: (none of most outputs' 2^17-2^18 on the CPU tests' buffers, a few of
#: 2^21-2^22 on the card's), and a bound on their share and on each one's
#: float32 error decides the same at every size.
CONFIG_DEEP_SHARE = 1e-5
#: Seed of the matrix's buffers (numpy), one more per configuration.
CONFIG_SEED = 2000


def slice_configs():
    """``SLICE_CONFIGS`` of tests/test_torch_pipeline.py, name for name and
    change for change: the configurations the CPU tests hold against the
    JAX package.  The phase keeps its own copy (it imports nothing from
    tests/); tests/test_torch_card_configs.py holds the two equal.  Each is
    ``default_full_config()`` with bitshift and FPN from the first two
    B-scans, then its changes; "bit_depth" is the samples' width, "window"
    (type, center, fill factor) replaces the Hann window."""
    from octproz_tpu_torch.params import FpnMode, Interpolation, WindowType

    return {
        "once-default": {},
        "once-high": dict(matmul_precision="high"),
        "once-highest": dict(matmul_precision="highest"),
        "fpn-off": dict(fpn_mode=FpnMode.OFF),
        "fpn-continuous": dict(fpn_mode=FpnMode.CONTINUOUS),
        "fold-xla": dict(fold_backend="xla"),
        "unfused-scale": dict(fused_scale=False),
        "bf16-store": dict(output_dtype="bfloat16"),
        "fast-log": dict(fast_log=True),
        "lin-scale": dict(log_scaling=False),
        "fold-bscan-flip": dict(bscan_flip=True),
        "fold-sinusoidal": dict(sinusoidal_correction=True),
        "fold-post-background": dict(post_background_removal=True,
                                     post_background_weight=0.8, post_background_offset=0.05),
        "fold-post-stages-bf16": dict(bscan_flip=True, sinusoidal_correction=True,
                                      post_background_removal=True, output_dtype="bfloat16"),
        "fold-ignores-use-pallas-prep": dict(use_pallas_prep=True),
        "fold-concat": dict(fold_concat=True),
        "fold-concat-high": dict(fold_concat=True, matmul_precision="high"),
        "fold-concat-highest": dict(fold_concat=True, matmul_precision="highest"),
        "fold-concat-lin-bf16": dict(fold_concat=True, log_scaling=False,
                                     output_dtype="bfloat16"),
        "fold-concat-fpn-off": dict(fold_concat=True, fpn_mode=FpnMode.OFF),
        "fold-concat-post-stages": dict(fold_concat=True, bscan_flip=True,
                                        sinusoidal_correction=True),
        "fft-prep-default": dict(fft_via_matmul=False, use_pallas_prep=True),
        "fft-prep-high": dict(fft_via_matmul=False, use_pallas_prep=True,
                              matmul_precision="high"),
        "fft-prep-highest": dict(fft_via_matmul=False, use_pallas_prep=True,
                                 matmul_precision="highest"),
        "fft-prep-real-default": dict(fft_via_matmul=False, use_pallas_prep=True,
                                      dispersion=False),
        "fft-prep-real-high": dict(fft_via_matmul=False, use_pallas_prep=True,
                                   dispersion=False, matmul_precision="high"),
        "fft-prep-background": dict(fft_via_matmul=False, use_pallas_prep=True,
                                    background_removal=True, rolling_average_window=8),
        "fft-matmul": dict(fft_via_matmul=False),
        "fft-matmul-high": dict(fft_via_matmul=False, matmul_precision="high"),
        "fft-gather-cubic": dict(fft_via_matmul=False, resample_via_matmul=False),
        "fft-gather-lanczos": dict(fft_via_matmul=False, resample_via_matmul=False,
                                   interpolation=Interpolation.LANCZOS),
        "fft-background": dict(fft_via_matmul=False, background_removal=True),
        "fft-fpn-off": dict(fft_via_matmul=False, use_pallas_prep=True, fpn_mode=FpnMode.OFF),
        "fft-fpn-continuous": dict(fft_via_matmul=False, use_pallas_prep=True,
                                   fpn_mode=FpnMode.CONTINUOUS),
        "fft-lin-scale": dict(fft_via_matmul=False, use_pallas_prep=True, log_scaling=False),
        "fft-bf16-store": dict(fft_via_matmul=False, output_dtype="bfloat16"),
        "fft-post-stages-bf16": dict(fft_via_matmul=False, use_pallas_prep=True,
                                     bscan_flip=True, sinusoidal_correction=True,
                                     post_background_removal=True, output_dtype="bfloat16"),
        "fold-8bit": dict(bit_depth=8, bitshift=False),
        "fold-8bit-shift": dict(bit_depth=8),
        "fold-10bit": dict(bit_depth=10, bitshift=False),
        "fold-10bit-shift": dict(bit_depth=10),
        "fold-16bit": dict(bit_depth=16, bitshift=False),
        "fold-16bit-shift": dict(bit_depth=16),
        "fold-24bit": dict(bit_depth=24, bitshift=False),
        "fold-24bit-shift": dict(bit_depth=24, grayscale_min=-120.0, grayscale_max=40.0),
        "fold-32bit": dict(bit_depth=32, bitshift=False),
        "fold-32bit-shift": dict(bit_depth=32, grayscale_min=-120.0, grayscale_max=40.0),
        "fold-16bit-high": dict(bit_depth=16, bitshift=False, matmul_precision="high"),
        "fold-16bit-fast-log": dict(bit_depth=16, bitshift=False, fast_log=True),
        "fold-background": dict(background_removal=True, rolling_average_window=8),
        "fold-background-high": dict(background_removal=True, rolling_average_window=8,
                                     matmul_precision="high"),
        "fold-linear": dict(interpolation=Interpolation.LINEAR),
        "fold-quadratic": dict(interpolation=Interpolation.QUADRATIC),
        "fold-lanczos": dict(interpolation=Interpolation.LANCZOS),
        "fold-no-resampling": dict(resampling=False),
        "fold-gauss-window": dict(window=(WindowType.GAUSS, 0.5, 0.8)),
        "fold-taylor-window": dict(window=(WindowType.TAYLOR, 0.45, 0.9)),
        "fold-highest-continuous": dict(matmul_precision="highest",
                                        fpn_mode=FpnMode.CONTINUOUS),
        "fold-24bit-continuous": dict(bit_depth=24, bitshift=False,
                                      fpn_mode=FpnMode.CONTINUOUS),
        "fold-32bit-continuous": dict(bit_depth=32, bitshift=False,
                                      fpn_mode=FpnMode.CONTINUOUS),
        "fft-prep-8bit": dict(fft_via_matmul=False, use_pallas_prep=True, bit_depth=8,
                              bitshift=False),
        "fft-prep-16bit-high": dict(fft_via_matmul=False, use_pallas_prep=True, bit_depth=16,
                                    bitshift=False, matmul_precision="high"),
        "fft-gather-linear-16bit": dict(fft_via_matmul=False, resample_via_matmul=False,
                                        interpolation=Interpolation.LINEAR, bit_depth=16,
                                        bitshift=False),
        "bf16-fold": dict(compute_dtype="bfloat16"),
        "bf16-fold-high-ignored": dict(compute_dtype="bfloat16", matmul_precision="high"),
        "bf16-fold-xla": dict(compute_dtype="bfloat16", fold_backend="xla"),
        "bf16-fold-concat": dict(compute_dtype="bfloat16", fold_concat=True),
        "bf16-fold-concat-bf16-store": dict(compute_dtype="bfloat16", fold_concat=True,
                                            output_dtype="bfloat16"),
        "bf16-fold-fast-log": dict(compute_dtype="bfloat16", fast_log=True),
        "bf16-fold-16bit": dict(compute_dtype="bfloat16", bit_depth=16, bitshift=False),
        "bf16-fold-24bit": dict(compute_dtype="bfloat16", bit_depth=24, bitshift=False),
        "bf16-fold-post-stages": dict(compute_dtype="bfloat16", bscan_flip=True,
                                      sinusoidal_correction=True, post_background_removal=True),
        "bf16-fft-prep": dict(compute_dtype="bfloat16", fft_via_matmul=False,
                              use_pallas_prep=True),
        "bf16-fft-prep-real": dict(compute_dtype="bfloat16", fft_via_matmul=False,
                                   use_pallas_prep=True, dispersion=False),
        "bf16-fft-prep-8bit": dict(compute_dtype="bfloat16", fft_via_matmul=False,
                                   use_pallas_prep=True, bit_depth=8, bitshift=False),
        "bf16-fft-matmul": dict(compute_dtype="bfloat16", fft_via_matmul=False),
    }


#: Names of ``slice_configs()`` the configurations phase does not run, each
#: with its reason.  None: a configuration the CPU tests gain later runs on
#: the card, or is named here with the reason.
CONFIGS_LEFT_OUT = {}
#: The configurations the CPU tests also run as one chunk with strategy
#: "scan" from a fresh FPN state (tests/test_torch_pipeline.py,
#: ``test_scan_chunk_matches_jax``).
SCAN_CONFIGS = ("once-default", "once-high", "fpn-continuous", "fft-prep-default", "fft-matmul",
                "fft-fpn-continuous", "bf16-fold", "bf16-fft-prep")


#: Configurations the phase runs beyond ``slice_configs()``: ``fold_k_split``
#: (a TPU overlap knob, accepted and without effect on the output) on the
#: default rung's scaled kernel with fast log and a bf16 store.
CARD_ONLY_CONFIGS = {"fold-k-split-fast-log-bf16-store": dict(fold_k_split=4, fast_log=True,
                                                              output_dtype="bfloat16")}
#: The configurations with outputs that had voxels past ``CONFIG_ATOL``
#: from the float64 products on the card (ROADMAP Queue 3, F2): the phase
#: holds every output of their "auto" run by ``config_near_exact`` and
#: prints what the rule saw.
F2_CONFIGS = ("bf16-fold-24bit", "fft-prep-16bit-high", "fold-xla", "fold-24bit-continuous")


def config_model(changes, device, ascans=None, bscans=CONFIG_BSCANS):
    """``FdOctModel`` of one configuration of ``slice_configs()`` on
    ``device``, built as the CPU tests build theirs, at full width: 1024
    samples, ``ascans`` A-scans (default ``bench.FULL_ACQ``'s 512) and
    ``bscans`` B-scans per buffer, ``bench.CURVE_KW``'s curves, a post
    background line (made from a seed) where the configuration removes
    one."""
    from octproz_tpu_torch import bench
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.params import default_full_config

    changes = dict(changes)
    bit_depth = changes.pop("bit_depth", 12)
    window = changes.pop("window", None)
    cfg = dataclasses.replace(default_full_config(), bitshift=True, bscans_for_noise=2)
    cfg = dataclasses.replace(cfg, **changes)
    acq = dataclasses.replace(bench.FULL_ACQ, bit_depth=bit_depth, bscans_per_buffer=bscans,
                              ascans_per_bscan=ascans or bench.FULL_ACQ.ascans_per_bscan)
    kw = dict(bench.CURVE_KW)
    if window is not None:
        kind, center, fill = window
        kw.update(window_type=kind, window_center=center, window_fill_factor=fill)
    if cfg.post_background_removal:
        kw["post_background"] = np.random.default_rng(5).uniform(
            0.0, 0.3, size=acq.output_ascan_length).astype(np.float32)
    return FdOctModel(acq, cfg, **kw, device=device)


def config_buffers(acq, count, seed):
    """``count`` host buffers of ``acq.bit_depth``-bit samples in their
    container type, made from ``seed`` with numpy (as the CPU tests make
    theirs)."""
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if acq.bit_depth <= 8 else np.uint16 if acq.bit_depth <= 16 else np.uint32
    return [rng.integers(0, 1 << acq.bit_depth, size=acq.buffer_shape).astype(dtype)
            for _ in range(count)]


def run_config(model, raws, strategy="auto"):
    """The CPU tests' calls on ``model``: with ``strategy`` "auto", buffer 0
    (FPN determination) and two steady buffers through ``process_buffer``,
    then the other buffers as one chunk with strategy "auto"; with "scan",
    all of ``raws`` as one chunk with strategy "scan" from the fresh FPN
    state.  Returns the outputs and the FPN state after each call."""
    if strategy == "scan":
        out = model.process_chunk(np.stack(raws), strategy="scan")
        return [out], [model.fpn_state]
    outs, states = [], []
    for raw in raws[:3]:
        outs.append(model.process_buffer(raw))
        states.append(model.fpn_state)
    outs.append(model.process_chunk(np.stack(raws[3:]), strategy="auto"))
    states.append(model.fpn_state)
    return outs, states


def config_close(got, want):
    """``got`` (an output on the card) against ``want`` (the port's on the
    CPU) as the CPU tests hold the port to the JAX package (``_close``):
    the same shape, no NaN or +inf, the same finite mask (so the same -inf
    voxels: p = 0, which a real DC bin gives without dispersion), more than
    half of the voxels shown in ``want`` (finite, at or above the display
    floor), and over those |got - want| <= ``CONFIG_ATOL``, one bf16 step
    more on a bf16 store.  Returns (max |err| over the shown voxels, within
    the bound, -inf voxels); raises on the rest."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    g, w = got.detach().to(want.device).double(), want.detach().double()
    if g.shape != w.shape:
        raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    for side, t in (("card", g), ("CPU", w)):
        if bool(torch.isnan(t).any()) or bool(torch.isposinf(t).any()):
            raise AssertionError(f"NaN or +inf in the {side}'s output")
    finite = torch.isfinite(g)
    if not torch.equal(finite, torch.isfinite(w)):
        raise AssertionError(f"finite masks differ: -inf at {int((~finite).sum())} voxels on "
                             f"the card, {int((~torch.isfinite(w)).sum())} on the CPU")
    shown = torch.isfinite(w) & (w >= 0)
    if float(shown.double().mean()) <= 0.5:
        raise AssertionError("most voxels lie below the display floor")
    err = (g - w)[shown].abs()
    limit = CONFIG_ATOL + (fp.BF16_STEP * w[shown].abs() if got.dtype == torch.bfloat16
                           else 0.0)
    return float(err.max()), bool((err <= limit).all()), int((~finite).sum())


def config_same_fpn(got, want):
    """Two FPN states as the CPU tests compare the port's with JAX's
    (``_same_fpn``): the same ``determined`` flag and mean lines within
    rtol ``CONFIG_FPN_RTOL`` and an absolute ``CONFIG_FPN_RTOL`` of the
    line's largest value (at least 1).  Returns (max |difference|, within
    the bound)."""
    if got.determined != want.determined:
        raise AssertionError(f"FPN determined {got.determined} on the card, "
                             f"{want.determined} on the CPU")
    g, w = (s.mean_line.detach().cpu().double() for s in (got, want))
    tol = CONFIG_FPN_RTOL * (w.abs() + max(float(w.abs().max()), 1.0))
    diff = (g - w).abs()
    return float(diff.max()), bool((diff <= tol).all())


def hold_config(tag, got, want, got_states, want_states, exact=None):
    """Every output and FPN state of one configuration's run on the card
    against the CPU's (``config_close``, ``config_same_fpn``).  Where an
    output misses against the CPU's, each side is held against the image of
    the float64 products, its FPN mean lines determined in float64 from the
    segments that side's steps picked (``exact(side)``, "card" or "cpu",
    called once each: ``run_config_f64``), as
    ``_check_steady_full_size`` holds the steady-state kernel: the card's
    output within the bound of ``config_near_exact``, the CPU's distance
    printed beside it; the mean lines themselves are held to each other.
    Returns (max |err| against the CPU's, max FPN mean-line difference,
    -inf voxels); raises where an output or a mean line misses its bound."""
    worst, fpn_worst, black, images = 0.0, 0.0, 0, {}
    for k, (g, w) in enumerate(zip(got, want)):
        err, ok, neg = config_close(g, w)
        worst, black = max(worst, err), black + neg
        if ok:
            continue
        if exact is None:
            raise AssertionError(f"{tag}: output {k} is {err:.3e} off the CPU's (bound "
                                 f"{CONFIG_ATOL:g} display units, one bf16 step more on a "
                                 f"bf16 store)")
        for side in ("card", "cpu"):
            images[side] = images.get(side) or exact(side)
        card, ok, past, ratio = config_near_exact(g, images["card"][k])
        cpu, _, cpu_past, _ = config_near_exact(w, images["cpu"][k])
        log(f"[configs] {tag}: output {k} is {err:.3e} off the CPU's; against the float64 "
            f"products the card's {card:.3e}, {past} voxel(s) past {CONFIG_ATOL:g} (at most "
            f"{CONFIG_DEEP_SHARE:g} of {g.numel()}, each within its float32 bound: largest "
            f"share of it {ratio:.3f}), the CPU's {cpu:.3e}, {cpu_past} past it "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: output {k} is {card:.3e} off the float64 products, "
                                 f"{past} voxel(s) past {CONFIG_ATOL:g} display units, the "
                                 f"largest at {ratio:.3f} of its float32 bound")
    for k, (g, w) in enumerate(zip(got_states, want_states)):
        diff, ok = config_same_fpn(g, w)
        if not ok:
            raise AssertionError(f"{tag}: FPN mean line after call {k} is {diff:.3e} off the "
                                 f"CPU's (rtol {CONFIG_FPN_RTOL:g})")
        fpn_worst = max(fpn_worst, diff)
    return worst, fpn_worst, black


#: Unit roundoff of the card's float32 sums, taken as one ulp, 2^-23: the
#: tensor cores truncate their accumulation (round to nearest is half of it).
F32_ULP = 2.0 ** -23


def _depth_f64(model, x, absolute=False):
    """The depth profiles (re, im) of the decoded lines ``x`` of ``model``'s
    configuration with every product in float64 (see ``image_f64``).  With
    ``absolute`` the same chain on |x| and the operators' magnitudes: for
    each depth sample the sum of the magnitudes of the terms its float32
    sum adds (on the FFT path every bin of a line sums the line's whole prep
    output), and 0 for im."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.ops import background, resample

    cfg, acq, cv = model.cfg, model.acq, model.curves
    rung = fp.operator_rung(cfg)
    f64 = torch.float64
    mag = torch.abs if absolute else (lambda t: t)

    def product(x, w):
        """x @ w as the rung takes its operands, summed in float64."""
        if rung == fp.BF16:
            return mag(x.to(torch.bfloat16).to(f64)) @ mag(w.to(torch.bfloat16).to(f64))
        parts = fp._SPLIT_PARTS.get(rung)
        if parts is None:
            return mag(x.to(f64)) @ mag(w.to(f64))
        x_hi = fp._bf16_trunc(x)
        x_lo = (x - x_hi).to(torch.bfloat16).to(f64)
        w_parts = [mag(p.to(f64)) for p in fp._split_bf16(w.to(torch.float32), parts)]
        return mag(x_hi.to(f64)) @ sum(w_parts) + mag(x_lo) @ sum(w_parts[:-1])

    half = acq.output_ascan_length
    if cfg.fft_via_matmul:
        return product(x, cv.depth_op_re), product(x, cv.depth_op_im)
    if cfg.use_pallas_prep:
        y = product(x, cv.prep_operator)
    else:
        if cfg.background_removal:
            x = background.remove_background(x, cfg.rolling_average_window)
        if cfg.resampling and (cfg.resample_via_matmul or absolute):
            r = cv.resample_matrix
            if r is None:  # the gather resampler's taps as a matrix
                r = torch.from_numpy(resample.build_resample_matrix(
                    cv.resample_curve.cpu().numpy(), cfg.interpolation)).to(x.device)
            y = product(x, r.T)
        elif cfg.resampling:
            y = resample.apply_gather(x, cv.resample_curve, cfg.interpolation).to(f64)
        else:
            y = mag(x.to(f64))
        if cfg.windowing:
            y = y * mag(cv.window.to(f64))
    if absolute:
        return y.sum(-1, keepdim=True).expand(-1, half), torch.zeros_like(y[:, :half])
    if cfg.dispersion:
        y = y * cv.phase.to(torch.complex128)
    z = torch.fft.ifft(y.to(torch.complex128), dim=-1, norm="forward")[..., :half]
    return z.real, z.imag


def _fpn_f64(re, im, lines, picked):
    """The FPN mean line of float64 depth profiles (re, im): per bin the
    mean of the segment -- ``FPN_SEGMENTS`` segments of the first ``lines``
    lines, as ``ops.fpn`` cuts them -- nearest ``picked``, the float32 mean
    line the step determined, so that rounding cannot pick another segment
    of the tie band here."""
    import torch

    from octproz_tpu_torch.params import FPN_SEGMENTS

    seg = max(lines // FPN_SEGMENTS, 1)
    means = [t[:FPN_SEGMENTS * seg].reshape(FPN_SEGMENTS, seg, -1).mean(1) for t in (re, im)]
    picked = picked.to(re.device, torch.float64)
    nearest = ((means[0] - picked[0]) ** 2 + (means[1] - picked[1]) ** 2).argmin(0, keepdim=True)
    return torch.stack([m.gather(0, nearest)[0] for m in means])


def image_f64(model, raw, fused, mean=None, picked=None):
    """The image of one buffer of ``model``'s configuration with its
    products in float64: the samples as the port decodes them and its
    float32 elementwise stages (background removal, the gather resampler),
    then each product of the chain -- the depth operators, the prep
    operator, the resampling matrix, the window and phasor, the inverse
    FFT -- in float64 on the port's float32 operators, on the operands as
    the configuration's rung takes them (at ``compute_dtype="bfloat16"`` x
    and the operator rounded to bf16; at a split rung the sum of its pass
    terms, x_hi and x_lo against the operator's bf16 parts); the FPN mean
    line determined here in float64 where the step determined one
    (``picked``, its float32 mean line, names the segments: ``_fpn_f64``),
    else the float64 ``mean`` carried from the buffer that did (None: FPN
    off) subtracted; p rounded once to float32, then the port's scaling
    (the steady-state kernel's epilogue where ``fused``: fast log with
    ``fast_log``) and post stages.  Returns (the image, the float32 bound
    of each voxel in display units -- Higham's bound gamma_n * sum |terms|
    on any float32 evaluation of its depth sum, n the samples (on the FFT
    path plus log2 n for the transform) at ``F32_ULP``, carried through the
    scaling and the post stages --, the float64 mean line)."""
    import math

    import torch

    from octproz_tpu_torch import pipeline
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.ops import convert

    cfg, acq, cv = model.cfg, model.acq, model.curves
    raw = torch.as_tensor(raw).to(model.device)
    x = convert.decode(raw, acq.bit_depth, cfg.bitshift).reshape(-1, acq.samples_per_line)
    re, im = _depth_f64(model, x)
    if picked is not None:
        lines = min(cfg.bscans_for_noise, acq.bscans_per_buffer) * acq.ascans_per_bscan
        mean = _fpn_f64(re, im, lines, picked)
    if mean is not None:
        re, im = re - mean[0], im - mean[1]
    p = re * re + im * im
    a, b = fp._scale_affine(cfg.log_scaling, acq.output_ascan_length, cfg.grayscale_min,
                            cfg.grayscale_max, cfg.addend, cfg.multiplicator)
    image = fp._scale_epilogue(p.to(torch.float32), log_scaling=cfg.log_scaling, a=a, b=b,
                               fast_log=fused and cfg.fast_log)
    s_re, s_im = _depth_f64(model, x, absolute=True)
    n = acq.samples_per_line + (0 if cfg.fft_via_matmul else math.ceil(math.log2(x.shape[-1])))
    e = n * F32_ULP / (1.0 - n * F32_ULP) * torch.sqrt(s_re * s_re + s_im * s_im)
    if cfg.log_scaling:
        ratio = e / torch.sqrt(p)
        bound = abs(a) / math.log(10.0) * (2.0 * ratio + ratio * ratio)
    else:
        bound = abs(a) * e
    shape = (acq.bscans_per_buffer, acq.ascans_per_bscan, acq.output_ascan_length)
    moved = dataclasses.replace(cfg, post_background_removal=False)  # a clamp: no growth
    return (pipeline.postprocess_volume(image.reshape(shape), cv, cfg),
            pipeline.postprocess_volume(bound.to(torch.float32).reshape(shape), cv, moved),
            mean)


def config_steps(model, raws):
    """What each of ``raws``' steps did on ``model``'s device, replayed
    through ``process_buffer`` from a fresh FPN state (a chunk, batched or
    scanned, runs its buffers' steps): (the steady-state kernel computed
    it, the FPN mean line it determined or None) per buffer."""
    from octproz_tpu_torch import pipeline
    from octproz_tpu_torch.params import FpnMode

    model.redetermine_fpn()
    steps = []
    for raw in raws:
        cfg, state = model.cfg, model.fpn_state
        determines = cfg.fpn_mode != FpnMode.OFF and (cfg.fpn_mode == FpnMode.CONTINUOUS
                                                      or not state.determined)
        model.process_buffer(raw)
        steps.append((pipeline.fused_ready(cfg, state),
                      model.fpn_state.mean_line if determines else None))
    return steps


def images_f64(model, raws, steps):
    """``image_f64`` of each of ``raws`` in turn with ``steps``
    (``config_steps`` of the side held to them), the float64 FPN mean line
    carried from the buffer that determined it: (image, float32 bound) per
    buffer."""
    mean, out = None, []
    for raw, (fused, picked) in zip(raws, steps):
        image, bound, mean = image_f64(model, raw, fused, mean=mean, picked=picked)
        out.append((image, bound))
    return out


def run_config_f64(model, raws, steps, strategy="auto"):
    """``run_config``'s outputs computed by ``images_f64`` on ``model``'s
    device: (image, float32 bound) per output."""
    import torch

    pairs = images_f64(model, raws, steps)
    if strategy == "scan":
        groups = [pairs]
    else:
        groups = [*([pair] for pair in pairs[:3]), pairs[3:]]
    return [tuple(torch.stack(t) if len(group) > 1 else t[0] for t in zip(*group))
            for group in groups]


def config_near_exact(got, exact):
    """The port's one rule (see ``CONFIG_ATOL``): ``got`` against ``exact``
    = (the image of the float64 products, the float32 bound of each voxel)
    from ``image_f64``: the same finite mask; over the shown voxels (finite,
    at or above the display floor in the image) |got - image| <=
    ``CONFIG_ATOL`` (one bf16 step more on a bf16 store), but for at most a
    ``CONFIG_DEEP_SHARE`` share of them, each of which within that bound
    plus its float32 bound -- the deepest nulls, where any float32
    evaluation order moves the log by more (the port's own float32 output
    on the CPU lies past 1e-4 from these products at a few voxels of many of
    the matrix's outputs).  Returns (max |err|, within, voxels past
    ``CONFIG_ATOL``, the largest ratio of such a voxel's error to its
    limit)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    image, bound = exact
    g, w = got.detach().to(image.device).double(), image.double()
    if not torch.equal(torch.isfinite(g), torch.isfinite(w)):
        raise AssertionError("finite masks differ from the float64 products'")
    shown = torch.isfinite(w) & (w >= 0)
    err = (g - w)[shown].abs()
    limit = CONFIG_ATOL + (fp.BF16_STEP * w[shown].abs() if got.dtype == torch.bfloat16
                           else 0.0)
    past = err > limit
    count = int(past.sum())
    allowed = limit + bound.to(image.device).double()[shown]
    ratio = float((err[past] / allowed[past]).max()) if count else 0.0
    ok = count <= CONFIG_DEEP_SHARE * err.numel() and ratio <= 1.0
    return float(err.max()), ok, count, ratio


def default_chains():
    """The configurations users get without a preset or from the FFT-path
    preset, run at full depth by ``phase_configurations``: (name, the
    configuration, the configuration whose kernel route computes the same
    function on the card, or None).  ``ProcConfig()``'s FFT path -- the
    CLI's chain without ``--preset`` -- through torch ops (decode, resampling
    matrix, window, dispersion) and cuFFT, against the prep kernel;
    ``benchmark_config(tpu=False)`` with the gather resampler, against the
    prep kernel (the same taps as the matrix); that torch-ops chain at
    ``compute_dtype="bfloat16"`` (the prep kernel rounds its folded operator
    to bf16, the torch ops the resampling matrix: not the same function);
    the fold path on the "xla" backend (plain matmuls) and with
    ``fused_scale`` off (B1 and the torch FPN and scaling on every buffer),
    each against the steady-state kernel."""
    from octproz_tpu_torch import bench
    from octproz_tpu_torch.models.presets import benchmark_config
    from octproz_tpu_torch.params import FpnMode, ProcConfig

    chain = ProcConfig(resampling=True, windowing=True, dispersion=True, fpn_mode=FpnMode.ONCE)
    fft = benchmark_config(tpu=False)
    return (
        ("torch-ops FFT chain", chain, dataclasses.replace(chain, use_pallas_prep=True)),
        ("benchmark_config(tpu=False), gather resampler",
         dataclasses.replace(fft, resample_via_matmul=False),
         dataclasses.replace(fft, use_pallas_prep=True)),
        ("torch-ops FFT chain at bf16", dataclasses.replace(chain, compute_dtype="bfloat16"),
         None),
        ("fold path, xla backend", bench.bench_config(fold_backend="xla"), bench.bench_config()),
        ("fold path, fused_scale off", bench.bench_config(fused_scale=False),
         bench.bench_config()),
    )


def _hold_full(tag, got, want, exact):
    """One full buffer's output on the card against ``want`` (the kernel
    route's on the card) as ``config_close`` holds it; where it misses,
    each against the image of the float64 products with the FPN mean line
    determined in float64 from the segments it picked (``exact(side)``,
    "chain" or "route") -- the output within the
    bound, the kernel route's distance printed beside.  Returns the max
    |err| held."""
    err, ok, _ = config_close(got, want)
    if ok:
        log(f"[configs] {tag}: steady output vs the kernel route on the card: max {err:.3e} "
            f"-> ok")
        return err
    card, ok, past, ratio = config_near_exact(got, exact("chain"))
    route, _, route_past, _ = config_near_exact(want, exact("route"))
    log(f"[configs] {tag}: steady output {err:.3e} off the kernel route's; against the float64 "
        f"products {card:.3e}, {past} voxel(s) past {CONFIG_ATOL:g} (at most "
        f"{CONFIG_DEEP_SHARE:g} of {got.numel()}, each within its float32 bound: largest share "
        f"of it {ratio:.3f}), the kernel route {route:.3e}, {route_past} past it "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: full-size output {card:.3e} off the float64 products, "
                             f"{past} voxel(s) past {CONFIG_ATOL:g}, the largest at {ratio:.3f} "
                             f"of its float32 bound")
    return card


def _default_chain(info, dev, name, cfg, twin, raws):
    """One chain of ``default_chains()`` on full buffers (see
    ``phase_configurations``).  Returns its launches by ``kernels`` row."""
    import torch

    from octproz_tpu_torch import bench, pipeline
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.models.fdoct import FdOctModel

    acq, card = bench.FULL_ACQ, f"{info['device_name']}, power limit {info['power_limit']}"
    model = FdOctModel(acq, cfg, **bench.CURVE_KW, device=dev)
    torch.cuda.synchronize()
    fp.reset_launch_counts()
    out0 = model.process_buffer(raws[0])
    state = model.fpn_state
    steady = [model.process_buffer(raw) for raw in raws[1:]]
    volume = model.process_volume(np.stack(raws[1:]))
    ran = _config_launches(name, cfg, acq)
    _check_output([out0, *steady], acq, name)
    if not torch.equal(volume, torch.cat(steady)):
        raise AssertionError(f"{name}: process_volume != the steady process_buffer calls")
    del volume
    log(f"[configs] {name}: buffer 0 + {len(steady)} steady + process_volume of "
        f"{len(steady)} (== the steady calls); launches {ran or 'none'}")
    # against the kernel route on the card, full buffer
    if twin is not None:
        other = FdOctModel(acq, twin, **bench.CURVE_KW, device=dev)
        torch.cuda.synchronize()
        fp.reset_launch_counts()
        other.process_buffer(raws[0])
        want = other.process_buffer(raws[1])
        for row, n in _config_launches(f"{name}, kernel route", twin, acq).items():
            ran[row] = ran.get(row, 0) + n
        sides = {"chain": (model, state), "route": (other, other.fpn_state)}
        _hold_full(name, steady[0], want, lambda side: images_f64(
            sides[side][0], raws[:2], [(False, sides[side][1].mean_line),
                                       (pipeline.fused_ready(sides[side][0].cfg,
                                                             sides[side][1]), None)])[1])
        del other, want, sides
    # against the port on the CPU, the first CONFIG_BSCANS B-scans (FPN from
    # the first bscans_for_noise of them: every stage reads only these)
    cut = [raw[:CONFIG_BSCANS] for raw in raws[:2]]
    cpu = FdOctModel(dataclasses.replace(acq, bscans_per_buffer=CONFIG_BSCANS), cfg,
                     **bench.CURVE_KW, device="cpu")
    want, want_states = [], []
    for raw in cut:
        want.append(cpu.process_buffer(raw))
        want_states.append(cpu.fpn_state)
    got = [out0[:CONFIG_BSCANS], steady[0][:CONFIG_BSCANS]]
    picked = {"card": state.mean_line, "cpu": want_states[0].mean_line}
    worst, fpn_worst, black = hold_config(
        f"{name}, first {CONFIG_BSCANS} B-scans", got, want, [state, model.fpn_state],
        want_states, exact=lambda side: images_f64(
            cpu, cut, [(False, picked[side]), (pipeline.fused_ready(cfg, state), None)]))
    log(f"[configs] {name}: first {CONFIG_BSCANS} B-scans vs the port on the CPU: max "
        f"{worst:.3e}, FPN mean line max difference {fpn_worst:.3e}, -inf voxels {black} on "
        f"each side -> ok")
    del out0, steady, cpu
    ms = bench.steady_ms_per_buffer(cfg, dev)
    fpn_ms = bench.fpn_buffer_ms(cfg, dev)
    line = (f"[configs] {name}: steady {ms:.3f} ms/buffer ({acq.ascans_per_buffer / ms / 1e3:.3f} "
            f"MHz), FPN-determination buffer {fpn_ms:.3f} ms")
    if not cfg.fft_via_matmul:
        line += "; stages " + ", ".join(f"{k} {v:.4f} ms"
                                        for k, v in bench.fft_stage_ms(cfg, dev).items())
    if twin is not None:
        ms, fpn_ms = bench.steady_ms_per_buffer(twin, dev), bench.fpn_buffer_ms(twin, dev)
        line += (f"; its kernel route steady {ms:.3f} ms/buffer, FPN-determination buffer "
                 f"{fpn_ms:.3f} ms")
    log(f"{line} ({card})")
    return ran


def _full_depth_chains(info, dev):
    """``default_chains()`` on full 1024 x 512 x 256 buffers of 12-bit
    samples made with numpy from a seed: buffer 0 (FPN determination), two
    steady buffers and one ``process_volume`` call of those two (equal to
    them), between a reset and a read of the launch counts; the first
    steady output against the kernel route computing the same function on
    the card (``_hold_full``), the first ``CONFIG_BSCANS`` B-scans of buffer
    0 and of the first steady buffer against the port on the CPU
    (``hold_config``); the steady ms per buffer, the FPN-determination
    buffer's ms and on the FFT path the stages (CUDA events), and the
    kernel route's steady and FPN-determination ms; then the post stages'
    ms on a full buffer.  Returns the launches by ``kernels``
    row."""
    from octproz_tpu_torch import bench

    acq = bench.FULL_ACQ
    rng = np.random.default_rng(CONFIG_SEED - 1)
    raws = [rng.integers(0, 1 << acq.bit_depth, size=acq.buffer_shape, dtype=np.uint16)
            for _ in range(3)]
    launches = {}
    for name, cfg, twin in default_chains():
        _add(launches, _default_chain(info, dev, name, cfg, twin, raws))
    stages = bench.post_stage_ms(dev)
    log("[configs] post stages on one full buffer: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in stages.items())
        + f" ({info['device_name']}, power limit {info['power_limit']})")
    return launches


def config_families(cfg):
    """The kernel families a configuration's run launches on the card: on
    the fold path with ``fold_backend="pallas"`` the planar kernel
    ("depth") on every buffer the steady-state kernel does not compute --
    the FPN-determination buffer at ``FpnMode.ONCE``, every buffer at
    ``CONTINUOUS`` or with ``fused_scale`` off -- and the steady-state
    kernel ("depth_scale", "depth_scale_concat" with ``fold_concat``) on
    the others; on the FFT path with the prep kernels "prep_phase" (with
    dispersion) or "prep_real"; at float32 compute and a split rung each as
    its "_split" family.  None on the "xla" fold backend or the torch-ops
    FFT path."""
    from octproz_tpu_torch.params import FpnMode

    split = "_split" if cfg.compute_dtype == "float32" and cfg.matmul_precision != "default" \
        else ""
    if not cfg.fft_via_matmul:
        if not cfg.use_pallas_prep:
            return set()
        return {("prep_phase" if cfg.dispersion else "prep_real") + split}
    if cfg.fold_backend == "xla":
        return set()
    fused = cfg.fused_scale and cfg.fpn_mode != FpnMode.CONTINUOUS
    families = set()
    if not fused or cfg.fpn_mode == FpnMode.ONCE:
        families.add("depth" + split)
    if fused:
        families.add(("depth_scale_concat" if cfg.fold_concat else "depth_scale") + split)
    return families


def config_row(family, cfg, acq):
    """The ``kernels`` line's row of a launch of ``family``: its bf16 row at
    ``compute_dtype="bfloat16"``, its float32-line row for a one-pass
    family on samples above 16 bits, else the family's own."""
    if family.endswith("_split"):
        return family
    if cfg.compute_dtype == "bfloat16":
        return family + "_bf16"
    return family + ("_f32lines" if acq.bit_depth > 16 else "")


def _config_launches(tag, cfg, acq, want=None):
    """The launch counts of one configuration's run on the card, read after
    it: the families launched must be ``want`` (by default
    ``config_families(cfg)``), every one-pass launch on the route of its
    compute dtype.  Returns them by ``kernels`` row."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    torch.cuda.synchronize()
    ran = {k: v for k, v in fp.LAUNCHES.items() if v}
    want = config_families(cfg) if want is None else want
    if set(ran) != want:
        raise AssertionError(f"{tag}: launched {ran}, want the families {sorted(want)}")
    route = "tensor_core_bf16" if cfg.compute_dtype == "bfloat16" else "tensor_core"
    for k, n in ran.items():
        routes = fp.ONE_PASS_ROUTES.get(k)
        if routes is not None and routes != {**dict.fromkeys(routes, 0), route: n}:
            raise AssertionError(f"{tag}: {k} launched on the routes {routes}, want {route}")
    return {config_row(k, cfg, acq): n for k, n in ran.items()}


def _add(total, counts):
    """Sum launch counts by ``kernels`` row into ``total``."""
    for row, n in counts.items():
        total[row] = total.get(row, 0) + n


def _hold_f2(info, tag, got, exact):
    """Every output of an ``F2_CONFIGS`` run on the card held by the rule
    (``config_near_exact`` against ``exact``, its float64 images), whether
    or not it missed against the CPU's: the voxels past ``CONFIG_ATOL`` and
    the largest ratio of such a voxel's error to its limit, printed with the
    card's name and power limit."""
    for k, (g, image) in enumerate(zip(got, exact)):
        err, ok, past, ratio = config_near_exact(g, image)
        log(f"[configs] F2 {tag} output {k}: {past} voxel(s) past {CONFIG_ATOL:g} of "
            f"{g.numel()} (at most {CONFIG_DEEP_SHARE:g} of them), largest ratio to the "
            f"float32 bound {ratio:.3g}, max |err| {err:.3e} against the float64 products "
            f"({info['device_name']}, power limit {info['power_limit']}) "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: output {k} misses the rule against the float64 "
                                 f"products: {past} voxel(s) past {CONFIG_ATOL:g}, the "
                                 f"largest at {ratio:.3g} of its float32 bound")


def phase_configurations(info, dev=None):
    """The configuration matrix: every configuration of ``slice_configs()``
    (and ``CARD_ONLY_CONFIGS``) through ``FdOctModel`` on the card and on
    the CPU, on the same ``CONFIG_BSCANS``-B-scan buffers of full-width
    lines made with numpy from a seed -- buffer 0 (FPN determination), two
    steady buffers, a chunk of two with strategy "auto", and for
    ``SCAN_CONFIGS`` a chunk of three with strategy "scan" from a fresh FPN
    state.  Each card run between a reset and a read of the launch counts
    (``_config_launches``); every output and FPN state held to the CPU's
    (``hold_config``), and every output of an ``F2_CONFIGS`` entry's "auto"
    run by the rule against the float64 products (``_hold_f2``).  Then the user-facing chains of ``default_chains()``
    at full depth (``_full_depth_chains``).  Returns the launches by
    ``kernels`` row."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    dev = torch.device("cuda", 0) if dev is None else dev
    t_phase = time.perf_counter()
    log(f"[configs] float32 matmuls: TF32 {torch.backends.cuda.matmul.allow_tf32} "
        f"(precision {torch.get_float32_matmul_precision()!r}); cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}")
    configs = {**{n: c for n, c in slice_configs().items() if n not in CONFIGS_LEFT_OUT},
               **CARD_ONLY_CONFIGS}
    launches = {}
    for i, (name, changes) in enumerate(configs.items()):
        for strategy, count in (("auto", 5), *((("scan", 3),) if name in SCAN_CONFIGS else ())):
            t0 = time.perf_counter()
            tag = f"{name} ({strategy})"
            card = config_model(changes, dev)
            raws = config_buffers(card.acq, count, CONFIG_SEED + i)
            torch.cuda.synchronize()
            fp.reset_launch_counts()
            got, got_states = run_config(card, raws, strategy)
            ran = _config_launches(tag, card.cfg, card.acq)
            t_card = time.perf_counter() - t0
            cpu = config_model(changes, "cpu")
            want, want_states = run_config(cpu, raws, strategy)
            models, images = {"card": card, "cpu": cpu}, {}

            def exact(side):
                if side not in images:
                    images[side] = run_config_f64(cpu, raws, config_steps(models[side], raws),
                                                  strategy)
                return images[side]

            worst, fpn_worst, black = hold_config(tag, got, want, got_states, want_states,
                                                  exact=exact)
            if name in F2_CONFIGS and strategy == "auto":
                _hold_f2(info, tag, got, exact("card"))
            _add(launches, ran)
            log(f"[configs] {tag}: max |card - CPU| {worst:.3e}, FPN mean line max "
                f"difference {fpn_worst:.3e}, -inf voxels {black} on each side; launches "
                f"{ran or 'none'} ({t_card:.1f} s card, {time.perf_counter() - t0:.1f} s "
                f"with the CPU) -> ok")
            del card, cpu, got, want, got_states, want_states
    log(f"[configs] {len(configs)} configurations ({len(SCAN_CONFIGS)} also as a scan chunk) "
        f"held to the CPU in {time.perf_counter() - t_phase:.1f} s")
    _add(launches, _full_depth_chains(info, dev))
    log(f"[configs] phase wall time {time.perf_counter() - t_phase:.1f} s; launches {launches} "
        f"({info['device_name']}, power limit {info['power_limit']})")
    return launches


def phase_fidelity():
    import torch

    from octproz_tpu_torch import bench

    dev = torch.device("cuda", 0)
    paths = {"fold path": ({}, None),
             "FFT path": (dict(fft_via_matmul=False, use_pallas_prep=True), bench.fft_config())}
    # the concat path's golden pair: the buffer again once its FPN is
    # determined, so the steady-state concat kernel makes the output
    goldens = [(path, changes) for path, (changes, _) in paths.items()]
    goldens.append(("concat fold path, steady", dict(fold_concat=True, steady=True)))
    for path, changes in goldens:
        for rung in ("default", "high"):
            res = bench.golden_pair(dev, matmul_precision=rung, **changes)
            log(f"[fidelity] {path} golden pair ({rung}): PSNR {res.psnr_db:.2f} dB, "
                f"min B-scan {res.min_bscan_psnr_db:.2f} dB, SSIM {res.mean_ssim:.5f}")
            if not (res.psnr_db >= 60.0 and res.min_bscan_psnr_db >= 55.0
                    and res.mean_ssim >= 0.99):
                raise AssertionError(f"{path} golden pair below its gates: {res}")
        # bf16 compute misses the 60 dB golden gate by design, in the JAX
        # package too (docs/performance.md): recorded, not gated
        res = bench.golden_pair(dev, compute_dtype="bfloat16", **changes)
        log(f"[fidelity] {path} golden pair (bfloat16, not gated): PSNR {res.psnr_db:.2f} dB, "
            f"min B-scan {res.min_bscan_psnr_db:.2f} dB, SSIM {res.mean_ssim:.5f}")
    # the concat path at bf16: with FPN off its kernel (B5) makes buffer 0
    concat = bench.bench_config(fold_concat=True)
    psnr = bench.oracle_psnr(("default", "bfloat16"), dev, concat)
    log(f"[fidelity] concat fold path oracle PSNR (FPN off, 1024x512x8): "
        + ", ".join(f"{k} {v:.2f} dB" for k, v in psnr.items()))
    _check_bf16_rung("concat fold path", psnr)
    for path, (changes, cfg) in paths.items():
        psnr = bench.oracle_psnr(tuple(bench.ORACLE_GATE_DB), dev, cfg)
        log(f"[fidelity] {path} oracle PSNR (FPN off, 1024x512x8): "
            + ", ".join(f"{k} {v:.2f} dB" for k, v in psnr.items()))
        for rung, gate in bench.ORACLE_GATE_DB.items():
            if psnr[rung] < gate:
                raise AssertionError(f"{path} oracle PSNR {rung} {psnr[rung]:.2f} < {gate}")
        _check_bf16_rung(path, psnr)
        if psnr["high"] < bench.IN_BOUND_SNR_DB:
            raise AssertionError(f"{path}: high rung below the {bench.IN_BOUND_SNR_DB} dB "
                                 f"SNR bound")
        if psnr["highest"] < psnr["high"] + RUNG_GAP_DB:
            raise AssertionError(f"{path}: highest rung not {RUNG_GAP_DB} dB above high: "
                                 f"{psnr}")
    for epi in ("phase", "real"):
        snr = _prep_snr_db(dev, epi)
        log(f"[fidelity] FFT path prep output SNR vs float64, {epi} kernels (1024x512x8, "
            f"before the FFT): " + ", ".join(f"{k} {v:.2f} dB" for k, v in snr.items()))
        if min(snr["default"], snr["highest"]) < snr["high"] + RUNG_GAP_DB:
            raise AssertionError(f"prep output of the {epi} kernels: default/highest not "
                                 f"{RUNG_GAP_DB} dB above high: {snr}")


def _check_bf16_rung(path, psnr):
    """The bf16 rung clears its gate and sits at least BF16_GAP_DB below the
    default rung: a bf16 run that took a float32-grade route would not."""
    from octproz_tpu_torch import bench

    if psnr["bfloat16"] < bench.ORACLE_GATE_DB["bfloat16"] \
            or psnr["bfloat16"] > psnr["default"] - BF16_GAP_DB:
        raise AssertionError(f"{path}: bf16 oracle PSNR {psnr['bfloat16']:.2f} dB not in "
                             f"[{bench.ORACLE_GATE_DB['bfloat16']}, default "
                             f"{psnr['default']:.2f} - {BF16_GAP_DB}]")


def _prep_snr_db(dev, epi):
    """Each rung's prep spectra (the phase or the real kernels) on the
    oracle's input, against a float64 product of the same float32 operator
    (and phasor): 10 log10(||ref||^2 / ||got - ref||^2).  On the FFT path
    the float32 FFT caps the end-to-end oracle PSNR near the default rung's
    (about 135 dB on an H100), so "highest" reads barely above "default"
    there; before the FFT the rungs keep their own error budgets (~2^-24
    against ~2^-16 for "high")."""
    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch import curves as curves_mod
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.ops.convert import decode

    acq = dataclasses.replace(bench.FULL_ACQ, bscans_per_buffer=8)
    cfg = bench.fft_config()
    cv = curves_mod.make_curves(acq, cfg, **bench.CURVE_KW, device=dev)
    raw = np.random.default_rng(7).integers(0, 4096, size=acq.buffer_shape).astype(np.uint16)
    raw2d = torch.from_numpy(raw).to(dev).reshape(-1, acq.samples_per_line)
    x = decode(raw2d, acq.bit_depth, cfg.bitshift).double()
    ref = x @ cv.prep_operator.double()
    rows = (cv.phase.real.contiguous(), cv.phase.imag.contiguous())
    if epi == "phase":
        ref = ref * cv.phase.to(torch.complex128)
    out = {}
    for rung in ("default", "high", "highest"):
        parts = fp._operator_parts(cv.prep_operator, rung)
        got = (fp.prep_phase(raw2d, parts, *rows, bitshift=cfg.bitshift) if epi == "phase"
               else fp.prep_real(raw2d, parts, bitshift=cfg.bitshift)).to(torch.complex128)
        err = float((got - ref).abs().square().sum())
        out[rung] = 10.0 * np.log10(float(ref.abs().square().sum()) / max(err, 1e-300))
    return out


#: Trace event categories (torch.profiler's Chrome trace): what the device
#: ran, and what the host did around it.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


def _merge(spans):
    """The union of (start, end) spans, sorted and merged."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def trace_summary(events, top=6, gaps=5):
    """From a trace's events (microseconds): the traced window (first to
    last device event), the device's busy time (the union of its kernel,
    copy and memset intervals over every stream), its idle share of the
    window, the device operations by total time, and the longest idle gaps,
    each with the device operations on either side of it and the host
    operations (name, thread) that overlap it most."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not dev:
        raise AssertionError("the trace holds no CUDA kernel or copy on the card")
    busy = _merge((e["ts"], e["ts"] + e["dur"]) for e in dev)
    t0, t1 = busy[0][0], busy[-1][1]
    busy_us = sum(e - s for s, e in busy)
    totals = {}
    for e in dev:
        name = e["name"]
        n, t = totals.get(name, (0, 0.0))
        totals[name] = (n + 1, t + e["dur"])
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e]
    holes = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])), reverse=True)
    ends = sorted(dev, key=lambda e: e["ts"] + e["dur"])
    starts = sorted(dev, key=lambda e: e["ts"])
    longest = []
    for dur, s, e in holes[:gaps]:
        before = max((d for d in ends if d["ts"] + d["dur"] <= s), key=lambda d: d["ts"] + d["dur"])
        after = min((d for d in starts if d["ts"] >= e), key=lambda d: d["ts"])
        over = {}
        for h in host:
            o = min(e, h["ts"] + h["dur"]) - max(s, h["ts"])
            if o > 0:
                key = (h["name"], h.get("tid"))
                over[key] = over.get(key, 0.0) + o
        longest.append({"at_ms": (s - t0) / 1e3, "ms": dur / 1e3,
                        "before": before["name"], "after": after["name"],
                        "host": [(name, tid, round(o / 1e3, 3)) for (name, tid), o in
                                 sorted(over.items(), key=lambda kv: -kv[1])[:4]]})
    return {"window_ms": (t1 - t0) / 1e3, "busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / (t1 - t0), "device_events": len(dev),
            "top": sorted(((name, n, t / 1e3) for name, (n, t) in totals.items()),
                          key=lambda r: -r[2])[:top],
            "gaps": longest}


def phase_trace(info):
    """A ``utils.profiling.trace`` of ``StreamingEngine.run`` on each wire
    (uint16, then packed-12): the concat path at the default rung, buffers
    replayed from RAM, quantized and fetched, after a warm-up run of the
    same model on that wire (FPN determined, kernels built, memory pools
    filled).  Each traced run stops about 3 s after its first buffer
    arrives.  Returns the summaries by wire."""
    import tempfile

    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.runtime import StreamingEngine
    from octproz_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    card = f"{info['device_name']}, power limit {info['power_limit']}"
    lines = bench.FULL_ACQ.ascans_per_buffer
    summaries = {}
    with tempfile.TemporaryDirectory() as tmp:
        sources = bench.stream_sources(tmp)
        model = FdOctModel(bench.FULL_ACQ, bench.bench_config(fold_concat=True),
                           **bench.CURVE_KW, device=dev)
        for wire in ("uint16", "packed12"):
            kw = dict(wire_format=wire, stream_to_host=True)
            StreamingEngine(model, sources[wire], **kw).run(max_buffers=8)
            torch.cuda.synchronize()
            arrived = []

            def on_processed(_host, _buffer_nr, arrived=arrived):
                arrived.append(time.perf_counter())
                if arrived[-1] - arrived[0] >= 3.0:
                    eng.stop()

            eng = StreamingEngine(model, sources[wire], on_processed=on_processed, **kw)
            with profiling.trace(os.path.join(tmp, "trace")) as path:
                n = eng.run(max_buffers=1000)
                torch.cuda.synchronize()
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            size_mb = os.path.getsize(path) / 1e6
            os.remove(path)
            s = summaries[wire] = trace_summary(events)
            del events
            log(f"[trace] engine run ({wire} wire): {n} buffers, traced window "
                f"{s['window_ms']:.3f} ms ({size_mb:.1f} MB of trace), {s['device_events']} "
                f"device events, device busy {s['busy_ms']:.3f} ms -> idle share "
                f"{100 * s['idle_share']:.2f} % ({n * lines / s['window_ms'] / 1e3:.3f} MHz over "
                f"the window) ({card})")
            for name, count, ms in s["top"]:
                log(f"[trace] {wire} device op {ms:10.3f} ms in {count:5d} calls: {name[:100]}")
            for gap in s["gaps"]:
                log(f"[trace] {wire} idle gap {gap['ms']:.3f} ms at {gap['at_ms']:.3f} ms, after "
                    f"{gap['before'][:50]}, before {gap['after'][:50]}; host ops over it: "
                    + "; ".join(f"{name[:60]} (thread {tid}) {o} ms"
                                for name, tid, o in gap["host"]))
    return summaries


def phase_times(info):
    import torch

    from octproz_tpu_torch import bench

    dev = torch.device("cuda", 0)
    lines = bench.FULL_ACQ.ascans_per_buffer
    card = f"{info['device_name']}, power limit {info['power_limit']}"
    for rung in bench.TIMED_RUNGS:
        ms = bench.steady_ms_per_buffer(bench.at_rung(bench.bench_config(), rung), dev)
        log(f"[times] fold path steady state ({rung}): {ms:.3f} ms/buffer, "
            f"{lines / ms / 1e3:.3f} MHz ({card})")
    for rung in ("default", "bfloat16"):
        ms = bench.steady_ms_per_buffer(bench.at_rung(bench.bench_config(fold_concat=True),
                                                      rung), dev)
        log(f"[times] concat fold path steady state ({rung}): {ms:.3f} ms/buffer, "
            f"{lines / ms / 1e3:.3f} MHz ({card})")
    for rung in bench.TIMED_RUNGS:
        cfg = bench.at_rung(bench.fft_config(), rung)
        ms = bench.steady_ms_per_buffer(cfg, dev)
        stages = bench.fft_stage_ms(cfg, dev)
        log(f"[times] FFT path steady state ({rung}): {ms:.3f} ms/buffer, "
            f"{lines / ms / 1e3:.3f} MHz; stages "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in stages.items()) + f" ({card})")
    for path, cfg in (("fold", bench.bench_config()), ("FFT", bench.fft_config())):
        ms = bench.steady_ms_per_buffer(bench.wide_config(cfg), dev, acq=bench.WIDE_ACQ)
        log(f"[times] {path} path steady state (default) on 24-bit samples: {ms:.3f} "
            f"ms/buffer, {lines / ms / 1e3:.3f} MHz ({card})")
    times = bench.kernel_times(dev, tuple(KERNELS) + bench.F32_LINE_KERNELS)
    for name, t in times.items():
        log(f"[times] {name:<27} kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
            f"library {t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}; kernel at {100 * t['bound_ms'] / t['ms']:.1f} % of it) ({card})")
    from octproz_tpu_torch.kernels import fused_prep as fp

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fp.fold_bf16_schedule(lines, bench.FULL_ACQ.output_ascan_length, 2, sms)
    log(f"[times] fold_bf16 at the main path's shape: {plan['tiles']} tiles of 128 x 128 on "
        f"{plan['grid']} blocks ({plan['tiles'] / plan['grid']:.2f} tiles a block), "
        f"{plan['stages']} stages, {plan['smem']} bytes of shared memory a block, tile "
        f"{plan['tile']!r}")
    plan = fp.prep_bf16_schedule(lines, bench.FULL_ACQ.samples_per_line, 2, sms)
    log(f"[times] prep_bf16 (phase) at the main path's shape: {plan['tiles']} tiles of 128 x 256 "
        f"on {plan['grid']} blocks ({plan['tiles'] / plan['grid']:.2f} tiles a block), "
        f"{plan['stages']} stages, {plan['smem']} bytes of shared memory a block (phasor rows "
        f"{'in shared memory' if plan['phasor_in_smem'] else 'in device memory'}), tile "
        f"{plan['tile']!r}")
    return times


#: Phase 15's soak: the window of each upload-only and engine run (s), and
#: the cycles of the soak chain on each wire (the other chains run one).
SOAK_WINDOW_S = 3.0
SOAK_CYCLES = 2
#: The anchor's gates: its derived bound within this of
#: ``bench.IN_BOUND_SNR_DB``; "default" and "highest" this far above it.
BOUND_MATCH_DB = 0.1
FLOAT32_MARGIN_DB = 10.0


def first_buffer_families(cfg):
    """The kernel families of one buffer from a fresh FPN state: with FPN
    once the FPN buffer's planar kernel, else the steady-state kernel."""
    from octproz_tpu_torch.params import FpnMode

    once = cfg.fpn_mode == FpnMode.ONCE
    return {f for f in config_families(cfg) if f.startswith("depth_scale") != once}


def _anchor_watch(acq, launches):
    """A ``watch`` for ``fullgeom_fidelity``: each rung's run between a
    reset and a read of the launch counts, which must be the rung's family
    (``first_buffer_families``) on its route; summed into ``launches`` by
    ``kernels`` row."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    @contextlib.contextmanager
    def watch(rung, cfg):
        torch.cuda.synchronize()
        fp.reset_launch_counts()
        yield
        tag = f"anchor {rung}, FPN {cfg.fpn_mode.value}"
        ran = _config_launches(tag, cfg, acq, first_buffer_families(cfg))
        log(f"[harness] {tag}: launches {ran}")
        _add(launches, ran)

    return watch


def _harness_anchor(info, dev, tmp):
    """The full-geometry fidelity anchor (``fullgeom_fidelity.run`` at
    1024 x 512 x 256): the derived SNR bound, each rung's PSNR with FPN off
    and on, and the ``cli compare`` gate, each held to its gate."""
    from octproz_tpu_torch import bench
    from octproz_tpu_torch import fullgeom_fidelity as fg

    acq = bench.FULL_ACQ
    launches = {}
    t0 = time.perf_counter()
    report = fg.run(acq.samples_per_line, acq.ascans_per_bscan, acq.bscans_per_buffer,
                    save_pair_dir=tmp, device=dev, watch=_anchor_watch(acq, launches),
                    log=lambda msg: log(f"[harness] anchor: {msg}"))
    card = f"{info['device_name']}, power limit {info['power_limit']}"
    bound = report["snr_bound_db"]
    log(f"[harness] anchor at {acq.bscans_per_buffer}x{acq.ascans_per_bscan}x"
        f"{acq.samples_per_line}: SNR bound {bound:.4f} dB (bench.IN_BOUND_SNR_DB "
        f"{bench.IN_BOUND_SNR_DB}) ({time.perf_counter() - t0:.1f} s) ({card})")
    failed = []
    if abs(bound - bench.IN_BOUND_SNR_DB) > BOUND_MATCH_DB:
        failed.append(f"bound {bound:.4f} dB not within {BOUND_MATCH_DB} dB of "
                      f"{bench.IN_BOUND_SNR_DB}")
    gates = {"default": bound + FLOAT32_MARGIN_DB, "highest": bound + FLOAT32_MARGIN_DB,
             "high": bound}
    for key, fpn in (("rungs", "off"), ("rungs_fpn_on", "on")):
        for rung, r in report[key].items():
            log(f"[harness] anchor FPN {fpn}, {rung}: PSNR {r['psnr_db']:.4f} dB vs the float64 "
                f"oracle, within the bound {r['within_reference_snr_bound']} "
                f"({r['seconds']:.1f} s) ({card})")
            if rung == "bfloat16":
                if r["within_reference_snr_bound"]:
                    failed.append(f"FPN {fpn}: bf16 claims the bound ({r['psnr_db']:.4f} dB)")
            elif r["psnr_db"] < gates[rung]:
                failed.append(f"FPN {fpn}: {rung} {r['psnr_db']:.4f} dB < {gates[rung]:.4f}")
    gate = report["cli_compare"]
    log(f"[harness] anchor cli compare (highest vs the saved oracle volume, --min-psnr "
        f"{gate['argv'][-1]}): rc {gate['returncode']}, passed {gate['passed']}")
    if not gate["passed"]:
        failed.append("the cli compare gate failed")
    if failed:
        raise AssertionError("anchor: " + "; ".join(failed))
    return launches


def _soak_stream_check(model, ring, wire, chunk, tag, tmp):
    """The engine's float32 recorder stream of its first two buffers (one
    chunk) against ``process_buffer`` on the same buffers, on the same model
    (FPN determined): within ``fused_prep.scale_error``'s bounds, a bf16
    step more on a bf16 store."""
    import torch

    from octproz_tpu_torch import soak
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.runtime import StreamingEngine

    eng = StreamingEngine(model, soak.HostRing(model.acq, ring), wire_format=wire,
                          dispatch_chunk=chunk, chunk_strategy="auto")
    eng.start_recording(_recording(tmp, f"soak{wire}{chunk}", 2))
    eng.run(max_buffers=max(chunk, 2))
    soak.join_engine_threads()
    got = _recorded(eng, 2, model.acq.processed_buffer_shape, tag)
    put = model.put_packed_buffer if wire == "packed12" else model.put_buffer
    worst = 0.0
    for i in range(2):
        want = model.fetch(model.process_buffer(put(ring[i])))
        g = torch.from_numpy(got[i])
        if model.cfg.output_dtype == "bfloat16":
            g = g.to(torch.bfloat16)  # the recorded float32 of a bf16 store: exact
        rms, err, ok = fp.scale_error(g, torch.from_numpy(want))
        if not ok:
            raise AssertionError(f"{tag}: streamed buffer {i} differs from process_buffer: "
                                 f"RMS {rms:.3e}, max {err:.3e}")
        worst = max(worst, err)
    log(f"[harness] {tag}: 2 streamed buffers == process_buffer within the scale bounds "
        f"(max {worst:.3e}{', bf16 store' if model.cfg.output_dtype == 'bfloat16' else ''})")


def _soak_engine_window(model, ring, wire, chunk, family, tag):
    """The engine window of a soak cycle (``soak.engine_window``) between a
    reset and a read of the launch counts (``_config_launches``): ``family``
    once per chunk the engine began and nothing else (no kernel at all for
    ``family`` None: a torch-ops chain).  Returns the window, its launches
    by ``kernels`` row and the launches per chunk as text."""
    import torch

    from octproz_tpu_torch import soak
    from octproz_tpu_torch.kernels import fused_prep as fp

    torch.cuda.synchronize()
    fp.reset_launch_counts()
    eng = soak.engine_window(model, ring, wire, chunk, SOAK_WINDOW_S)
    ran = _config_launches(tag, model.cfg, model.acq, {family} if family else set())
    n, chunks = sum(ran.values()), -(-eng["buffers"] // chunk)
    if eng["buffers"] < chunk or (family and not chunks <= n <= chunks + 1):
        raise AssertionError(f"{tag}: {eng['buffers']} buffers, launches {ran}; want "
                             f"{family} once per chunk and nothing else")
    return eng, ran, f"{n} for {chunks} chunks of {chunk} ({n / max(chunks, 1):.3f} a chunk)"


def _soak_chain(info, tag, model, wire, chunk, cycles, family, tmp):
    """``cycles`` soak cycles of ``model`` on ``wire``, each upload-only,
    engine (``_soak_engine_window``), upload-only, built from ``soak``'s
    windows, with no pinned host block allocated after the warm-up (every
    window's feeder takes its slots from the cache); then the stream
    check.  Returns the engine windows' launches by ``kernels`` row."""
    import torch

    from octproz_tpu_torch import soak

    card = f"{info['device_name']}, power limit {info['power_limit']}"
    ring = soak.host_ring(model.acq, wire)
    records, launches = [], {}
    for c in range(cycles):
        soak.warm_up(model, ring, wire, chunk)
        pinned = torch.cuda.host_memory_stats()["num_host_alloc"]
        before = soak.upload_window(model, ring, wire, chunk, SOAK_WINDOW_S)
        eng, ran, per_chunk = _soak_engine_window(model, ring, wire, chunk, family,
                                                  f"soak {tag}, cycle {c}")
        after = soak.upload_window(model, ring, wire, chunk, SOAK_WINDOW_S)
        pinned = torch.cuda.host_memory_stats()["num_host_alloc"] - pinned
        if pinned:
            raise AssertionError(f"soak {tag}, cycle {c}: {pinned} pinned host blocks "
                                 f"allocated in the timed windows")
        rec = soak.cycle_record(wire, chunk, SOAK_WINDOW_S, before, eng, after)
        log(f"[harness] soak {tag}, cycle {c}: engine {rec['engine_mhz']:.4f} MHz "
            f"({rec['engine_buffers']} buffers in {rec['engine_seconds']:.3f} s), upload-only "
            f"{rec['upload_before_mhz']:.4f} / {rec['upload_after_mhz']:.4f} MHz "
            f"({rec['upload_buffers']} buffers), ratio {rec['ratio']:.4f}; launches "
            f"{ran or 'none'}" + (f", {family} {per_chunk}" if family else "") + f" ({card})")
        _add(launches, ran)
        records.append(rec)
    summary = soak.summarize(records, wire, chunk, SOAK_WINDOW_S)
    log(f"[harness] soak {tag}: {summary['cycles']} cycles, ratio median "
        f"{summary['ratio_median']:.4f}, p10 {summary['ratio_p10']:.4f}, upload-only "
        f"{summary['upload_mhz_range'][0]:.4f}-{summary['upload_mhz_range'][1]:.4f} MHz ({card})")
    _soak_stream_check(model, ring, wire, chunk, f"soak {tag}", tmp)
    return launches


def phase_harnesses(info, dev=None):
    """Phase 15: the fidelity anchor at full geometry and the soak of the
    engine against upload-only windows on three chains (see the module
    docstring).  Returns the launches by ``kernels`` row."""
    import tempfile

    import torch

    from octproz_tpu_torch import bench, soak
    from octproz_tpu_torch.models.fdoct import FdOctModel

    dev = torch.device("cuda", 0) if dev is None else dev
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        _add(launches, _harness_anchor(info, dev, tmp))
    with tempfile.TemporaryDirectory() as tmp:
        model = soak.soak_model(bench.FULL_ACQ, dev)
        for wire in ("packed12", "uint16"):
            _add(launches, _soak_chain(info, f"bf16 chain, {wire} wire, chunk 8", model, wire,
                                       8, SOAK_CYCLES, "depth_scale", tmp))
        del model
        chains = (("FFT path (prep kernel), uint16 wire", bench.FULL_ACQ, bench.fft_config(),
                   "prep_phase"),
                  ("FFT path (torch ops, ProcConfig()), uint16 wire", bench.FULL_ACQ,
                   default_chains()[0][1], None),
                  ("24-bit fold path, uint32 buffers", bench.WIDE_ACQ,
                   bench.wide_config(bench.bench_config()), "depth_scale"))
        for tag, acq, cfg, family in chains:
            model = FdOctModel(acq, cfg, **bench.CURVE_KW, device=dev)
            _add(launches, _soak_chain(info, tag, model, "uint16", 1, 1, family, tmp))
            del model
    log(f"[harness] phase wall time {time.perf_counter() - t_phase:.1f} s; launches {launches} "
        f"({info['device_name']}, power limit {info['power_limit']})")
    return launches


#: Phase 16: timed buffers of each latency run (the JAX harness's --n).
LATENCY_N = 60
#: The chunks beside the bench's attempts (``bench.CHUNK_ATTEMPTS``): with
#: them, scan and batch at 4, 8, 16 and 32 at bf16; the batches held buffer
#: by buffer against the per-buffer step.
CHUNK_EXTRA = (("scan", 4, "bfloat16", "float32"), ("batch", 4, "bfloat16", "float32"),
               ("batch", 8, "bfloat16", "float32"), ("batch", 32, "bfloat16", "float32"))
CHUNK_HELD = (16, 32)
CHUNK_ITERS = 3
#: Repeats of cuda:0 in the scaling sweep, and its timed steps per mesh.
SCALING_REPEATS = (1, 2, 4)
SCALING_ITERS = 20
SCALING_WARMUP = 2
#: The sweep's bound against the single device (phase 9's, from
#: tests/test_sharding.py).
MESH_ATOL = 2e-4
#: The gloo anchor's pair: timed steps per leg, and each leg's deadline.
GLOO_ITERS = 100
GLOO_TIMEOUT_S = 300.0


def _held_launches(run, cfg, want, tag):
    """``run()`` between a reset and a read of the launch counts, which by
    ``kernels`` row must be ``want`` (family -> count) exactly, every
    one-pass launch on the route of ``cfg``'s compute dtype
    (``_config_launches``).  Returns (the result, the launches by row)."""
    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.kernels import fused_prep as fp

    torch.cuda.synchronize()
    fp.reset_launch_counts()
    result = run()
    ran = _config_launches(tag, cfg, bench.FULL_ACQ, set(want))
    rows = {config_row(k, cfg, bench.FULL_ACQ): n for k, n in want.items()}
    if ran != rows:
        raise AssertionError(f"{tag}: launched {ran}; want {rows}")
    return result, ran


def _rate_latency(info, dev):
    """Part 1: ``latency.measure`` on the JAX harness's chain at full width,
    at bf16 (its default) and at the default rung: the percentiles, the
    mean and the pipelined companion, ``LATENCY_N`` buffers timed, B1 once
    (the FPN buffer) and B2 once per buffer."""
    from octproz_tpu_torch import bench, latency

    card = f"{info['device_name']}, power limit {info['power_limit']}"
    launches = {}
    for dtype, rung in (("bfloat16", "bf16"), ("float32", "default")):
        cfg = latency.latency_config("pallas", dtype)
        tag = f"latency, {rung}"
        t0 = time.perf_counter()
        rec, ran = _held_launches(
            lambda: latency.measure(bench.FULL_ACQ, cfg, dev, LATENCY_N), cfg,
            {"depth": 1, "depth_scale": LATENCY_N + latency.pipelined_count(LATENCY_N)}, tag)
        if rec["n"] != LATENCY_N:
            raise AssertionError(f"{tag}: {rec['n']} buffers timed, want {LATENCY_N}")
        log(f"[rates] {tag}: n {rec['n']}, p50 {rec['p50']:.4f}, p90 {rec['p90']:.4f}, p99 "
            f"{rec['p99']:.4f}, max {rec['max']:.4f}, mean {rec['mean']:.4f} ms per buffer "
            f"(one call and one sync each); pipelined {rec['amortized_pipelined_ms']:.4f} ms "
            f"per buffer; launches {ran} ({time.perf_counter() - t0:.1f} s) ({card})")
        _add(launches, ran)
    return launches


def _rate_batch_held(cfg, dev, chunk, tag):
    """Every buffer of a batch of ``chunk`` against the per-buffer step on
    the same model, one buffer at a time (finite masks equal, atol = rtol =
    1e-5, as the main path's batch of four).  Returns the max difference."""
    import torch

    from octproz_tpu_torch import bench

    model, stack = bench.chunk_model(cfg, dev, chunk)
    out = model.process_chunk(stack, "batch")
    worst = 0.0
    for i in range(chunk):
        a, b = model.process_buffer(stack[i]), out[i]
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            raise AssertionError(f"{tag}: buffer {i}: batch and per-buffer finite masks differ")
        if not torch.allclose(a.float(), b.float(), atol=1e-5, rtol=1e-5):
            raise AssertionError(f"{tag}: batch buffer {i} != per-buffer step "
                                 f"({float((a.float() - b.float()).abs().max()):.3e})")
        fin = torch.isfinite(a)
        worst = max(worst, float((a.float()[fin] - b.float()[fin]).abs().max()))
    return worst


def _rate_chunks(info, dev):
    """Part 2: ``bench.chunk_attempt`` of ``bench.CHUNK_ATTEMPTS`` and of
    ``CHUNK_EXTRA`` -- scan and batch at 4, 8, 16 and 32 on
    ``bench.bench_config()`` at bf16, the batch of 32 also with a bf16
    store, both at 8 at the default rung -- each beside the per-buffer
    steady ms of its configuration (and for a scan its ``torch.stack`` copy
    alone); one launch per chunk for the batch, one per buffer for the
    scan; every buffer of the batches of ``CHUNK_HELD`` against the
    per-buffer step."""
    from octproz_tpu_torch import bench

    card = f"{info['device_name']}, power limit {info['power_limit']}"
    launches, steady = {}, {}
    for strategy, chunk, rung, store in bench.CHUNK_ATTEMPTS + CHUNK_EXTRA:
        cfg = bench.at_rung(bench.bench_config(output_dtype=store), rung)
        tag = f"{strategy} of {chunk}, {rung}, {store} store"
        # the steady ms once per configuration: cuda_ms's 2 warm-up calls and
        # steady_ms_per_buffer's 12, after its FPN buffer
        fresh = (rung, store) not in steady
        t0 = time.perf_counter()
        rec, ran = _held_launches(
            lambda: bench.chunk_attempt(dev, strategy, chunk, rung, store, steady,
                                        iters=CHUNK_ITERS), cfg,
            {"depth": 1 + fresh, "depth_scale": (CHUNK_ITERS + 1)
             * (chunk if strategy == "scan" else 1) + 14 * fresh}, tag)
        _add(launches, ran)
        ms = rec["ms_per_buffer"]
        copy = ""
        if strategy == "scan":
            copy = f"; its torch.stack alone {rec['stack_ms_per_buffer']:.4f} ms per buffer"
        held = ""
        if strategy == "batch" and chunk in CHUNK_HELD:
            worst, ran = _held_launches(lambda: _rate_batch_held(cfg, dev, chunk, tag), cfg,
                                        {"depth": 1, "depth_scale": 1 + chunk}, tag)
            _add(launches, ran)
            held = f"; all {chunk} buffers == per-buffer step (atol 1e-5, max {worst:.3e})"
        log(f"[rates] {tag}: {ms:.4f} ms per buffer "
            f"({bench.FULL_ACQ.ascans_per_buffer / ms / 1e3:.3f} MHz) against the per-buffer "
            f"steady {rec['steady_ms_per_buffer']:.4f}{copy}{held}; launches {ran} "
            f"({time.perf_counter() - t0:.1f} s) ({card})")
    return launches


def _rate_scaling(info, dev):
    """Part 3: ``scaling.run_scaling`` over ``SCALING_REPEATS`` repeats of
    cuda:0 at full width (each mesh's last steady output within
    ``MESH_ATOL`` of the single-device step's), the traffic report on three
    meshes of 8 repeats (the FPN reduction exactly
    ``traffic.expected_fpn_psum_bytes``, 55 296 B) with the compute time
    measured here, and one gloo-anchor pair (a process with a 2-position
    mesh, then two processes of one position each, all on cuda:0)."""
    from octproz_tpu_torch import bench, scaling
    from octproz_tpu_torch.parallel import make_mesh, traffic

    card = f"{info['device_name']}, power limit {info['power_limit']}"
    acq, cfg = bench.FULL_ACQ, scaling.scaling_config()
    launches = {}
    builders = [({"mesh": f"{n}x1"}, lambda n=n: make_mesh(n, 1, devices=[dev] * n))
                for n in SCALING_REPEATS]
    steps = SCALING_WARMUP - 1 + SCALING_ITERS
    t0 = time.perf_counter()
    rows, ran = _held_launches(
        lambda: scaling.run_scaling(builders, acq, cfg, n_iters=SCALING_ITERS,
                                    warmup=SCALING_WARMUP, shared_device=True), cfg,
        {"depth": 1 + sum(SCALING_REPEATS), "depth_scale": 1 + steps * sum(SCALING_REPEATS)},
        "scaling sweep")
    _add(launches, ran)
    for r in rows:
        log(f"[rates] scaling {r['mesh']} on {dev} (shared device): {r['ms_per_buffer']:.4f} ms "
            f"per buffer, {r['ascans_per_s'] / 1e6:.3f} MHz, efficiency "
            f"{r['scaling_efficiency']:.4f} (partition overhead, not scaling); max difference "
            f"to the single device {r['max_abs_diff']:.3e} ({card})")
        if not r["max_abs_diff"] <= MESH_ATOL:
            raise AssertionError(f"scaling {r['mesh']}: output {r['max_abs_diff']:.3e} from "
                                 f"the single device (bound {MESH_ATOL})")
    log(f"[rates] scaling sweep: launches {ran} ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    compute_ms, ran = _held_launches(
        lambda: bench.steady_ms_per_buffer(cfg, dev, acq=acq), cfg,
        {"depth": 1, "depth_scale": 2 + 12}, "traffic report's compute time")
    _add(launches, ran)
    report, ran = _held_launches(
        lambda: scaling.run_traffic_report(
            acq, cfg, compute_ms / 1e3, None, [dev] * 8,
            compute_source=f"measured in this call: single-device steady ms per buffer ({card})"),
        cfg, {"depth": 3 * 8}, "traffic report")
    _add(launches, ran)
    want = traffic.expected_fpn_psum_bytes(acq)
    if want != 55296 or any(m["by_op"] != {"all_reduce": want}
                            for m in report["meshes"].values()):
        raise AssertionError(f"traffic report: {report['meshes']}, want all_reduce {want} B "
                             f"(55296) on every mesh")
    log(f"[rates] traffic report: every mesh's transfers {{'all_reduce': {want}}} B; compute "
        f"{compute_ms:.4f} ms per buffer; predicted 2-host efficiency "
        f"{report['predicted_efficiency']} (links published, not measured) "
        f"({time.perf_counter() - t0:.1f} s) ({card})")

    t0 = time.perf_counter()
    anchor = scaling.run_gloo_anchor(acq, cfg, None, iters=GLOO_ITERS, pairs=1,
                                     timeout=GLOO_TIMEOUT_S, device=dev.type)
    pair = anchor["pairs"][0]
    one, two = pair["one_process_2dev"], pair["two_process_gloo"]
    if not ((one["hosts"], one["devices"], two["hosts"], two["devices"]) == (1, 2, 2, 2)
            and anchor["measured_protocol_ratio"] > 0):
        raise AssertionError(f"gloo anchor: {anchor}")
    log(f"[rates] gloo anchor at full width, {GLOO_ITERS} steps: one process, 2 positions "
        f"{one['ms_per_buffer']:.4f} ms per buffer via {one['via']}; two processes "
        f"{[round(r['ms_per_buffer'], 4) for r in pair['two_process_ranks']]} via {two['via']} "
        f"(the slowest rank's counts); ratio {anchor['measured_protocol_ratio']:.4f} "
        f"({time.perf_counter() - t0:.1f} s) ({card})")
    return launches


def phase_rate_harnesses(info, dev=None):
    """Phase 16: the per-buffer latency, the chunked dispatch and the
    scaling harness at full width (see the module docstring).  Returns the
    launches by ``kernels`` row."""
    import torch

    dev = torch.device("cuda", 0) if dev is None else dev
    t0 = time.perf_counter()
    launches = {}
    for part in (_rate_latency, _rate_chunks, _rate_scaling):
        _add(launches, part(info, dev))
    log(f"[rates] phase wall time {time.perf_counter() - t0:.1f} s; launches {launches} "
        f"({info['device_name']}, power limit {info['power_limit']})")
    return launches


def main() -> None:
    info = phase_device()
    phase_build()
    worst = phase_kernels()
    launches = {**phase_main_path(worst), **phase_fft_path(worst)}
    launches.update(phase_wide_samples(worst))
    for k, v in phase_continuous_fpn(info).items():
        launches[k] += v
    launches.update(phase_stream(worst, info))
    for k, v in phase_acquisition(info).items():
        launches[k] += v
    for k, v in phase_application(info).items():
        launches[k] += v
    for k, v in phase_mesh(info).items():
        launches[k] += v
    launches.update({BF16_ROWS[k]: v for k, v in phase_bf16_path(worst).items()})
    phase_fidelity()
    phase_trace(info)
    times = phase_times(info)
    for k, v in phase_configurations(info).items():
        launches[k] += v
    for k, v in phase_harnesses(info).items():
        launches[k] += v
    for k, v in phase_rate_harnesses(info).items():
        launches[k] += v
    kernels = [{"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": PALLAS + str(line), "launches": launches[name],
                "max_abs_err": worst[name],
                **{k: times[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")}}
               for name, (source, line) in {**KERNELS, **F32_ROWS}.items()]
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
