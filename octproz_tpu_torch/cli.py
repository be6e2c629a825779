"""Command-line interface: process / replay / render / bench / info.

Counterpart of ``octproz_tpu/cli.py``: the same commands, flags and
settings-file handling, so a settings file or a command line carries over.
``--device`` (default ``cuda``: the first CUDA device) says where the
pipeline and the renderer run; without a CUDA device the default fails
with an error instead of running on the CPU, and ``--device cpu`` asks for
the CPU.  ``--fold-backend pallas`` selects the hand-written CUDA kernels
and ``xla`` their plain torch versions (the names carry over from the JAX
package); ``--fold-ksplit`` and ``--pallas-tile`` are accepted and leave
the output unchanged; ``--mesh B[,A]`` shards the step over a mesh of
``--device``'s devices (the local CUDA devices, too few being an error; on
the CPU, B*A copies of the CPU device).  ``python -m octproz_tpu_torch ...``
runs it.

The headless app-shell of the framework -- the role OCTproZMainWindow +
Sidebar + OCTproZApp play in the reference (octproz_project/octproz/src/
octprozapp.cpp slot_start/slot_record orchestration, sidebar.cpp:319-359
parameter mapping), with an INI settings file replacing the GUI state
(settingsfilemanager, sidebar.h:44-96 keys).  The reference has no CLI
(docs list none).

Commands:
  process  one-shot: read a raw volume file, run the pipeline, write
           processed output / B-scan / en-face PNGs and volume renders
  replay   streaming: replay a file through the runtime engine at a given
           rate with live throughput metrics (Virtual OCT System analog)
  render   render a processed volume file with one of the 7 3D modes
  compare  PSNR/SSIM fidelity harness vs a reference volume
  settings show / save the full INI settings surface (sidebar.h:44-96 keys)
  bench    the port's benchmark (python -m octproz_tpu_torch.bench)
  info     device + version report (GpuInfo analog)

Flag resolution: built-in defaults < --settings file values < explicit CLI
flags (argparse.SUPPRESS defaults make "explicitly passed" exact).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


#: CLI flag -> AcqParams field (geometry may come from the flags OR from a
#: settings file's [acquisition] group; flags win)
_ACQ_FLAGS = {
    "samples": "samples_per_line",
    "ascans": "ascans_per_bscan",
    "bscans": "bscans_per_buffer",
    "buffers_per_volume": "buffers_per_volume",
    "bit_depth": "bit_depth",
}

#: CLI flag -> ProcConfig field, value taken as-is
_CFG_FLAGS = {
    "bitshift": "bitshift",
    "background_removal": "background_removal",
    "rolling_window": "rolling_average_window",
    "grayscale_min": "grayscale_min",
    "grayscale_max": "grayscale_max",
    "scale_coeff": "multiplicator",
    "scale_addend": "addend",
    "fpn_bscans": "bscans_for_noise",
    "bscan_flip": "bscan_flip",
    "sinusoidal_correction": "sinusoidal_correction",
    "post_background_removal": "post_background_removal",
    "post_bg_weight": "post_background_weight",
    "post_bg_offset": "post_background_offset",
    "fused_prep": "use_pallas_prep",
    "fft_matmul": "fft_via_matmul",
    "fold_backend": "fold_backend",
    "fold_concat": "fold_concat",
    "fold_ksplit": "fold_k_split",
    "fast_log": "fast_log",
    "pallas_tile": "pallas_tile",
    "compute_dtype": "compute_dtype",
    "matmul_precision": "matmul_precision",
    "output_dtype": "output_dtype",
}

#: negated CLI flag -> ProcConfig field it disables
_CFG_INVERT = {
    "no_resampling": "resampling",
    "no_windowing": "windowing",
    "no_dispersion": "dispersion",
    "lin_scaling": "log_scaling",
    "no_fused_scale": "fused_scale",
}

_S = argparse.SUPPRESS  # absent attr == "user did not pass the flag"


def _add_acq_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group(
        "acquisition geometry (flags override a --settings file)")
    g.add_argument("--preset", default=_S,
                   choices=["benchmark", "minimal", "handheld"],
                   help="named base setup (models/presets.py): geometry + "
                        "chain of the published benchmark / bare "
                        "reconstruction / resonant-scanner handheld; "
                        "settings-file values and explicit flags overlay it")
    g.add_argument("--samples", type=int, default=_S,
                   help="samples per A-scan (raw line length)")
    g.add_argument("--ascans", type=int, default=_S, help="A-scans per B-scan")
    g.add_argument("--bscans", type=int, default=_S, help="B-scans per buffer")
    g.add_argument("--buffers-per-volume", type=int, default=_S)
    g.add_argument("--bit-depth", type=int, default=_S)
    g.add_argument("--packed-12bit", action="store_true", default=_S,
                   help="input file holds 12-bit packed samples (2 per 3 bytes)")
    g.add_argument("--big-endian", action="store_true", default=_S,
                   help="input samples are big-endian (byte-swapped on load)")
    g.add_argument("--stream-from-disk", action="store_true", default=_S,
                   help="do not preload the file into RAM (huge files)")


def _add_proc_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group(
        "processing (sidebar.cpp:319-337 analog; flags override a "
        "--settings file, whose values override the built-in defaults)")
    g.add_argument("--bitshift", action="store_true", default=_S,
                   help="right-shift 16-bit containers by 4 (12-in-16 digitizers)")
    g.add_argument("--background-removal", action="store_true", default=_S)
    g.add_argument("--rolling-window", type=int, default=_S)
    g.add_argument("--no-resampling", action="store_true", default=_S)
    g.add_argument("--interpolation",
                   choices=["linear", "quadratic", "cubic", "lanczos"],
                   default=_S)
    g.add_argument("--klin-coeffs", type=float, nargs=4, default=_S,
                   metavar=("C0", "C1", "C2", "C3"),
                   help="resampling polynomial; default identity (0, N-1, 0, 0)")
    g.add_argument("--klin-curve-csv", default=_S,
                   help="custom resampling curve CSV (index;value), e.g. from "
                        "extensions.extract_klin_curve")
    g.add_argument("--no-windowing", action="store_true", default=_S)
    g.add_argument("--window-type", choices=["hanning", "gauss", "sine",
                                             "lanczos", "rectangular",
                                             "flattop", "taylor"],
                   default=_S)
    g.add_argument("--window-center", type=float, default=_S)
    g.add_argument("--window-fill", type=float, default=_S)
    g.add_argument("--no-dispersion", action="store_true", default=_S)
    g.add_argument("--disp-coeffs", type=float, nargs=4, default=_S,
                   metavar=("D0", "D1", "D2", "D3"))
    g.add_argument("--fpn", choices=["off", "once", "continuous"], default=_S)
    g.add_argument("--fpn-bscans", type=int, default=_S, metavar="N",
                   help="B-scans used for fixed-pattern-noise determination")
    g.add_argument("--lin-scaling", action="store_true", default=_S,
                   help="linear instead of logarithmic dynamic-range scaling")
    g.add_argument("--grayscale-min", type=float, default=_S)
    g.add_argument("--grayscale-max", type=float, default=_S)
    g.add_argument("--scale-coeff", type=float, default=_S,
                   help="dynamic-range multiplicator (PROC_COEFF)")
    g.add_argument("--scale-addend", type=float, default=_S,
                   help="dynamic-range addend (PROC_ADDEND)")
    g.add_argument("--bscan-flip", action="store_true", default=_S)
    g.add_argument("--sinusoidal-correction", action="store_true", default=_S)
    g.add_argument("--post-background-removal", action="store_true", default=_S,
                   help="subtract the post-process background curve "
                        "(cuda_code.cu:757-767); record it live with "
                        "'replay --record-background N'")
    g.add_argument("--post-bg-weight", type=float, default=_S)
    g.add_argument("--post-bg-offset", type=float, default=_S)
    g.add_argument("--fused-prep", action="store_true", default=_S,
                   help="stages 1-3 in the fused prep kernel (FFT path)")
    g.add_argument("--fft-matmul", action="store_true", default=_S,
                   help="fold the whole pre-FPN chain incl. IFFT into one "
                        "complex GEMM (the fold kernels)")
    g.add_argument("--fold-backend", choices=["pallas", "xla"], default=_S,
                   help="executor of the folded GEMM (with --fft-matmul): "
                        "'pallas' = the hand-written CUDA kernels, 'xla' = "
                        "their plain torch versions (names kept from the "
                        "JAX package so settings carry over)")
    g.add_argument("--no-fused-scale", action="store_true", default=_S,
                   help="disable the FPN+log epilogue fusion into the fold "
                        "kernel (diagnostic; slower)")
    g.add_argument("--fold-concat", action="store_true", default=_S,
                   help="run the (re|im) fold operators as ONE wide GEMM "
                        "per tile instead of two")
    g.add_argument("--fold-ksplit", type=int, default=_S, metavar="K",
                   help="contraction split of the JAX kernel; accepted and "
                        "validated, the CUDA kernels stage the decode in "
                        "their own K loop (output unchanged)")
    g.add_argument("--fast-log", action="store_true", default=_S,
                   help="polynomial exponent-extraction log2 epilogue "
                        "(fast-math analog; maps 0 to a finite floor)")
    g.add_argument("--pallas-tile", type=int, default=_S, metavar="LINES",
                   help="lines per tile cap of the JAX kernels; accepted and "
                        "unused (the CUDA tile is a compile-time choice)")
    g.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default=_S,
                   help="spectral-chain GEMM dtype (bfloat16 = x and the "
                        "operators rounded to bf16, one tensor-core term)")
    g.add_argument("--matmul-precision",
                   choices=["default", "high", "highest"], default=_S,
                   help="fidelity ladder for float32 GEMMs: default = one "
                        "pass (~2^-8 rel budget), high = 3-pass bf16 split "
                        "(~2^-16 rel), highest = 5-pass split (~2^-24)")
    g.add_argument("--output-dtype", choices=["float32", "bfloat16"],
                   default=_S,
                   help="stored magnitude volume dtype (bfloat16 halves "
                        "write-back and host-transfer bytes)")
    g.add_argument("--settings", default=None,
                   help="INI settings file applying every [acquisition]/"
                        "[processing]/[tpu]/[streaming]/[record] key; "
                        "explicit CLI flags override its values")
    g.add_argument("--mesh", default=None, metavar="B[,A]",
                   help="shard the step over a (bscan, ascan) mesh of --device's "
                        "devices, e.g. --mesh 4 or --mesh 4,2 (parallel/sharding.py; "
                        "with cpu, B*A copies of the CPU device)")
    g.add_argument("--plugins", action="append", default=None,
                   metavar="PKG.MOD[:FACTORY]",
                   help="load a third-party plugin (repeatable): an "
                        "Extension subclass/instance or a factory(ctx) "
                        "registering extensions/acquisition systems "
                        "(QPluginLoader analog, octprozapp.cpp:99-174); "
                        "also loaded: [plugins] load= settings key and "
                        "installed 'octproz_tpu_torch.plugins' entry points")
    g.add_argument("--no-entry-point-plugins", action="store_true",
                   default=False,
                   help="skip installed entry-point plugin discovery")


def _load_bundle(args):
    """The parsed settings file (or an empty bundle without --settings)."""
    from .utils.configmap import SettingsBundle, from_settings

    if not getattr(args, "settings", None):
        return SettingsBundle()
    from .utils.settings import SettingsManager

    return from_settings(SettingsManager(args.settings))


class _SettingsGroupMap:
    """Lazy group lookup for PluginContext.settings (per-plugin settings
    round-trip, plugin.h:43-45)."""

    def __init__(self, manager):
        self._manager = manager

    def get(self, key, default=None):
        if self._manager is None:
            return default
        return self._manager.get_group(key) or default


def _plugin_context(args, bundle):
    """The session's plugin surface: extension manager + acquisition-system
    registry holding the built-ins plus every runtime-loaded plugin
    (--plugins flags, [plugins] load= settings key, installed
    octproz_tpu_torch.plugins entry points) — the QPluginLoader discovery pass
    (octprozapp.cpp:99-174) as module-path + entry-point loading."""
    from .io import phytooct
    from .io.systems import SystemRegistry
    from .plugins import PluginContext, load_plugins

    manager = None
    if getattr(args, "settings", None):
        from .utils.settings import SettingsManager

        manager = SettingsManager(args.settings)
    registry = SystemRegistry(manager)
    phytooct.register(registry)
    ctx = PluginContext(systems=registry,
                        settings=_SettingsGroupMap(manager))
    specs = list(bundle.plugins) + list(getattr(args, "plugins", None) or [])
    load_plugins(specs, ctx,
                 entry_points=not getattr(args, "no_entry_point_plugins",
                                          False))
    # loaded extensions start ACTIVE: a headless session has no sidebar
    # toggle, and an extension someone explicitly loaded should observe the
    # stream (deactivation remains available over the control API)
    for ext in ctx.extensions.extensions.values():
        ext.activate()
    for kind, name in ctx.loaded:
        print(f"plugin loaded: {kind} '{name}'", file=sys.stderr)
    return ctx


def _maybe_system_source(args, bundle, ctx=None):
    """Activate a registered acquisition system when the input spec is
    ``system:NAME`` (the SystemChooser analog for the CLI); else None.

    Systems read their device settings from the ``[system:NAME]`` group of
    the ``--settings`` INI (storeSettings/settingsLoaded round-trip,
    plugin.h:43-45).  ``ctx`` (a PluginContext) supplies the registry so
    runtime-loaded system plugins are activatable."""
    spec = getattr(args, "input", None)
    if not (isinstance(spec, str) and spec.startswith("system:")):
        return None
    if ctx is None:
        ctx = _plugin_context(args, bundle)
    return ctx.systems.activate(spec.split(":", 1)[1])


def _build_config(args, bundle=None, system=None):
    """Resolve (AcqParams, ProcConfig, model kwargs): built-in defaults,
    overlaid with every recognized settings-file key, overlaid with the CLI
    flags the user actually passed (argparse.SUPPRESS defaults make the
    'actually passed' set exact).

    With ``system`` (an activated acquisition system), the device supplies
    the base instead: its geometry, its recommended processing chain, and
    its factory calibration — the analog of a plugin pushing
    setKLinCoeffsRequest/setCustomResamplingCurveRequest (plugin.h:82-86).
    Settings-file values and explicit CLI flags still overlay it."""
    from .params import FpnMode, Interpolation, WindowType
    from .utils import configmap

    bundle = _load_bundle(args) if bundle is None else bundle
    a = vars(args)

    acq_over = {field: a[flag] for flag, field in _ACQ_FLAGS.items()
                if flag in a}
    cfg_over = {field: a[flag] for flag, field in _CFG_FLAGS.items()
                if flag in a}
    for flag, field in _CFG_INVERT.items():
        if flag in a:
            cfg_over[field] = not a[flag]
    if "interpolation" in a:
        cfg_over["interpolation"] = Interpolation(a["interpolation"])
    if "fpn" in a:
        cfg_over["fpn_mode"] = FpnMode(a["fpn"])

    if system is not None:
        if acq_over:
            raise SystemExit(
                "acquisition geometry flags cannot override a system: "
                "source — the device owns its geometry; set "
                f"{sorted(acq_over)} in the [system:NAME] settings group")
        acq = system.acq  # the device owns its geometry
        base = (system.recommended_config()
                if hasattr(system, "recommended_config") else None)
        if base is not None:
            merged = dict(bundle.cfg_kwargs)
            merged.update(cfg_over)
            cfg = dataclasses.replace(base, **merged)
        else:
            _, cfg = configmap.build_config(bundle, None, cfg_over)
    elif a.get("preset"):
        from .models.presets import PRESETS

        acq_base, cfg_base = PRESETS[a["preset"]]
        acq = dataclasses.replace(acq_base, **{**bundle.acq_kwargs, **acq_over})
        cfg = dataclasses.replace(cfg_base, **{**bundle.cfg_kwargs, **cfg_over})
    else:
        acq, cfg = configmap.build_config(bundle, acq_over, cfg_over,
                                          require_geometry=True)

    # curve / model kwargs: settings first, CLI flags override
    model_kw = dict(
        resample_coeffs=(0.0, float(acq.samples_per_line - 1), 0.0, 0.0),
        dispersion_coeffs=(0.0, 0.0, 0.0, 0.0),
        window_type=WindowType.HANNING,
        window_center=0.5,
        window_fill_factor=1.0,
    )
    if system is not None and hasattr(system, "curve_kwargs"):
        model_kw.update(system.curve_kwargs())  # factory calibration
    # what a partially-specified INI coefficient tuple falls back to, slot
    # by slot (None marks unspecified slots, utils/configmap.py)
    coeff_base = {f: model_kw[f]
                  for f in ("resample_coeffs", "dispersion_coeffs")}
    ck = dict(bundle.curve_kwargs)
    custom_csv = ck.pop("custom_resampling_filepath", None)
    post_bg_csv = ck.pop("post_background_filepath", None)
    model_kw.update(ck)
    if post_bg_csv:
        # PROC_POST_BACKGROUND_FILEPATH: the recorded background curve
        from .io.curvefiles import load_curve_csv

        model_kw["post_background"] = load_curve_csv(
            post_bg_csv, expected_size=acq.output_ascan_length)
    for field, base in coeff_base.items():
        v = model_kw[field]
        if any(x is None for x in v):
            model_kw[field] = tuple(b if x is None else x
                                    for x, b in zip(v, base))
    if "klin_coeffs" in a:
        model_kw["resample_coeffs"] = tuple(a["klin_coeffs"])
    if "disp_coeffs" in a:
        model_kw["dispersion_coeffs"] = tuple(a["disp_coeffs"])
    if "window_type" in a:
        model_kw["window_type"] = WindowType(a["window_type"])
    if "window_center" in a:
        model_kw["window_center"] = a["window_center"]
    if "window_fill" in a:
        model_kw["window_fill_factor"] = a["window_fill"]
    if "klin_curve_csv" in a:
        custom_csv = a["klin_curve_csv"]
    if custom_csv:
        from .io.curvefiles import load_curve_csv

        model_kw["custom_resample_curve"] = load_curve_csv(
            custom_csv, expected_size=acq.samples_per_line)
    return acq, cfg, model_kw


def _model(args, acq, cfg, model_kw, device):
    """FdOctModel on ``device``, its step sharded over ``--mesh B[,A]`` when
    given: on a CUDA device the local CUDA devices from it on (too few is an
    error, never a fallback), on the CPU B*A copies of the CPU device."""
    from .models.fdoct import FdOctModel

    mesh = None
    if getattr(args, "mesh", None):
        from .parallel import make_mesh

        dims = [int(x) for x in args.mesh.split(",")]
        if len(dims) == 1:
            dims.append(1)
        if device.type == "cpu":
            devices = [device] * (dims[0] * dims[1])
        else:
            first = 0 if device.index is None else device.index
            devices = [torch.device("cuda", i)
                       for i in range(first, torch.cuda.device_count())]
        mesh = make_mesh(dims[0], dims[1], devices=devices)
    return FdOctModel(acq, cfg, **model_kw, mesh=mesh, device=device)


def _device(args) -> torch.device:
    """The --device the pipeline and the renderer run on; a CUDA device
    without one available is an error, never a silent move to the CPU."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(f"--device {args.device}: no CUDA device is available "
                         "(torch.cuda.is_available() is False); pass --device cpu "
                         "to run on the CPU")
    return device


def _source_kwargs(args, bundle) -> dict:
    """Input-framing options for VirtualOctSource (settings + CLI merge)."""
    kw = dict(packed_12bit=False, big_endian=False, copy_to_ram=True)
    kw.update(bundle.source_kwargs)
    a = vars(args)
    if "packed_12bit" in a:
        kw["packed_12bit"] = a["packed_12bit"]
    if "big_endian" in a:
        kw["big_endian"] = a["big_endian"]
    if "stream_from_disk" in a:
        kw["copy_to_ram"] = not a["stream_from_disk"]
    if a.get("keep_packed"):
        kw["keep_packed"] = True
    return kw


def cmd_process(args) -> int:
    from .io.source import VirtualOctSource
    from .viz import builtin_lut, save_bscan_png, save_enface_png

    device = _device(args)
    bundle = _load_bundle(args)
    ctx = _plugin_context(args, bundle)
    system = _maybe_system_source(args, bundle, ctx)
    acq, cfg, model_kw = _build_config(args, bundle, system=system)
    model = _model(args, acq, cfg, model_kw, device)
    if system is not None:
        src = system
        raw_buffers = []
        for raw in src.buffers():
            raw_buffers.append(raw)
            if (args.max_buffers is not None
                    and len(raw_buffers) >= args.max_buffers):
                break
        system.close()
        n_buffers = len(raw_buffers)
        read_buffer = raw_buffers.__getitem__
    else:
        src = VirtualOctSource(args.input, acq,
                               total_buffers_to_acquire=args.max_buffers,
                               **_source_kwargs(args, bundle))
        n_buffers = min(src.buffers_in_file,
                        src.buffers_in_file if args.max_buffers is None
                        else args.max_buffers)
        read_buffer = src.read_buffer

    # batch-mode extension fan-out: plugins loaded with --plugins must
    # observe the stream here too, not only under `replay` (raw before
    # upload, processed after — quantized at the acquisition bit depth,
    # the same contract the streaming engine's consumer stream uses)
    exts = ctx.extensions
    want_raw = any(e.active and e.wants_raw_data
                   for e in exts.extensions.values())
    want_proc = any(e.active and e.wants_processed_data
                    for e in exts.extensions.values())
    if want_proc:
        from .ops import quantize as _quantize
        from .parallel.sharding import per_shard

    t0 = time.perf_counter()
    outs = []
    for i in range(n_buffers):
        raw_i = read_buffer(i)
        if want_raw:
            exts.feed_raw(np.asarray(raw_i), acq, i % max(
                acq.buffers_per_volume, 1))
        outs.append(model.process_buffer(raw_i))
        if want_proc:
            exts.feed_processed(model.fetch(per_shard(
                lambda t: _quantize.quantize(t, acq.bit_depth), outs[-1])),
                                acq, acq.bit_depth,
                                i % max(acq.buffers_per_volume, 1))
    volume = np.concatenate([model.fetch(o) for o in outs], axis=0)
    dt = time.perf_counter() - t0
    ascans = n_buffers * acq.ascans_per_buffer
    print(f"processed {n_buffers} buffers ({volume.shape[0]} B-scans) in "
          f"{dt:.2f} s -- {ascans / dt / 1e3:.1f} kHz A-scans", file=sys.stderr)

    lut = builtin_lut(args.lut) if args.lut else None
    if args.output:
        np.clip(volume, 0.0, 1.0).astype(np.float32).tofile(args.output)
        print(f"wrote {args.output} float32 "
              f"{volume.shape[2]}x{volume.shape[1]}x{volume.shape[0]}",
              file=sys.stderr)
    if args.bscan_png is not None:
        p = save_bscan_png(args.bscan_png, volume, frame_nr=args.frame, lut=lut)
        print(f"wrote {p}", file=sys.stderr)
    if args.enface_png is not None:
        p = save_enface_png(args.enface_png, volume, depth_nr=args.depth, lut=lut)
        print(f"wrote {p}", file=sys.stderr)
    if args.render_png is not None:
        _render_to_png(volume, args.render_png, args.render_mode, lut, device)
    if args.plot_png is not None:
        from .viz import plot_lines, select_line

        # the raw buffer holding global frame args.frame (same A-scan as
        # the processed trace)
        raw_buf_nr = min(args.frame // acq.bscans_per_buffer, n_buffers - 1)
        raw_line = select_line(read_buffer(raw_buf_nr),
                               args.frame % acq.bscans_per_buffer,
                               args.plot_ascan).astype(np.float64)
        proc_line = select_line(volume, args.frame, args.plot_ascan)
        p = plot_lines(args.plot_png, raw_line=raw_line, processed_line=proc_line,
                       title=f"B-scan {args.frame}, A-scan {args.plot_ascan}")
        print(f"wrote {p}", file=sys.stderr)
    return 0


def _render_to_png(volume, path, mode_name, lut, device):
    from .viz import RenderMode, RenderParams, render_volume, save_png

    params = RenderParams(mode=RenderMode(mode_name))
    img = render_volume(volume, params, yaw=0.5, pitch=0.4, device=device)
    save_png(path, img)
    print(f"wrote {path} ({mode_name})", file=sys.stderr)


def cmd_replay(args) -> int:
    from .io.source import VirtualOctSource
    from .runtime import StreamingEngine
    from .utils.console import MessageConsole

    device = _device(args)
    bundle = _load_bundle(args)
    ctx = _plugin_context(args, bundle)
    system = _maybe_system_source(args, bundle, ctx)
    acq, cfg, model_kw = _build_config(args, bundle, system=system)
    model = _model(args, acq, cfg, model_kw, device)
    # wire-format / source-framing consistency (both directions: packed
    # wire without a packed source feeds garbage shapes into the step, and
    # packed bytes with a uint16 wire would be decoded as samples)
    keep_packed = getattr(args, "keep_packed", False)
    packed_src = bool(vars(args).get("packed_12bit", False))
    if args.wire_format == "packed12" and not (system is None and keep_packed
                                               and packed_src):
        raise SystemExit("--wire-format packed12 needs a file source with "
                         "--packed-12bit --keep-packed (the engine expects "
                         "packed wire bytes)")
    if keep_packed and not packed_src:
        raise SystemExit("--keep-packed requires --packed-12bit")
    if keep_packed and args.wire_format != "packed12":
        raise SystemExit("--keep-packed yields packed wire bytes; use "
                         "--wire-format packed12 (or drop --keep-packed "
                         "to unpack on host)")
    src = system or VirtualOctSource(
        args.input, acq, wait_time_us=args.wait_us,
        total_buffers_to_acquire=args.max_buffers,
        **_source_kwargs(args, bundle))
    console = MessageConsole(echo=True)
    if args.camera_dir and not args.live:
        args.live = True  # the pane only exists in the live viewer
    # streaming enable/decimation: settings-file values under the CLI flags
    # (STREAM_STREAMING / STREAM_STREAMING_SKIP analog)
    stream_file = bundle.streaming.get("stream_to_host", False)
    skip = args.skip if args.skip is not None else \
        bundle.streaming.get("streaming_skip", 0)
    stream = (args.stream or stream_file
              or (args.record and args.record_processed) or args.live)
    windows = []
    # opened here, closed in the finally below — which must also cover
    # engine/viewer construction and recording setup, or an exception in
    # any of that leaks the handle (ADVICE r4)
    metrics_fh = open(args.metrics_json, "w") if args.metrics_json else None
    live = None

    def on_metrics(stats):
        # the engine's own 5 s info-box instrument, streamed as JSONL —
        # the reference's published MHz comes from exactly this counter
        # (processing.cpp:193-207)
        rec = {"t": round(time.perf_counter(), 3),
               "ascans_per_s": round(stats.ascans_per_s, 1),
               "buffers_per_s": round(stats.buffers_per_s, 3),
               "bscans_per_s": round(stats.bscans_per_s, 1),
               "volumes_per_s": round(stats.volumes_per_s, 4),
               "mb_per_s": round(stats.mb_per_s, 1),
               "wire_mb_per_s": round(stats.wire_mb_per_s, 1),
               "wire_mb": round(stats.wire_mb, 1),
               "buffers_processed": stats.buffers_processed}
        windows.append(rec)
        if metrics_fh:
            metrics_fh.write(json.dumps(rec) + "\n")
            metrics_fh.flush()

    try:
        eng = StreamingEngine(model, src, stream_to_host=stream,
                              extensions=ctx.extensions,
                              streaming_skip=skip, on_info=console.info,
                              metrics_window_s=args.metrics_window,
                              dispatch_chunk=args.chunk,
                              chunk_strategy=args.chunk_strategy,
                              upload_prefetch=not args.no_upload_prefetch,
                              prefetch_depth=args.prefetch_depth,
                              wire_format=args.wire_format,
                              on_metrics=on_metrics)
        if args.live:
            from .viz.live import LiveView

            live = LiveView(port=args.live_port, host=args.live_host,
                            lut=args.live_lut, volume_render=args.live_volume,
                            device=device)
            live.attach(eng)  # auto-creates a ParamController (POST /control)
            if args.camera_dir:
                from .extensions.camera import CameraExtension, DirectoryCamera

                cam = CameraExtension(DirectoryCamera(args.camera_dir,
                                                      fps=args.camera_fps))
                eng.extensions.add(cam)
                cam.activate()
                live.attach_camera(cam)
            print(f"live view: {live.url}", flush=True)
        if args.record_background:
            eng.record_post_background(args.record_background)
        if args.record:
            from .io.recorder import RecordingParams

            rec_kw = dict(bundle.recording)  # [record] group (sidebar REC keys)
            if args.record_dir is not None:
                rec_kw["save_dir"] = args.record_dir
            if args.record_name is not None:
                rec_kw["name"] = args.record_name
            if args.record_buffers is not None:
                rec_kw["buffers_to_record"] = args.record_buffers
            if args.record_start_with_volume:
                rec_kw["start_with_first_buffer_of_volume"] = True
            if args.record_processed:
                rec_kw["save_processed"] = True
            if args.record_raw:
                rec_kw["save_raw"] = True
            elif args.record_processed and "save_raw" not in rec_kw:
                rec_kw["save_raw"] = False
            if args.record_float32:
                rec_kw["save_as_32bit_float"] = True
            if args.settings:
                # recording metadata = copy of the settings file
                # (octprozapp.cpp:295-298)
                rec_kw.setdefault("settings_file", args.settings)
            params = RecordingParams(**rec_kw)
            if args.schedule_interval is not None:
                eng.schedule_recordings(params,
                                        interval_s=args.schedule_interval,
                                        total=args.schedule_total)
            else:
                eng.start_recording(params)
        t0 = time.perf_counter()
        n = eng.run(max_buffers=args.max_buffers)
        dt = time.perf_counter() - t0
    finally:
        # a failure anywhere above — engine/viewer construction, recording
        # setup, or the run itself — must not leak the metrics handle, the
        # producer thread, or the viewer's server socket (ADVICE r4)
        if system is not None:
            system.close()  # join the device producer thread
        if live is not None:
            live.close()
        if metrics_fh:
            metrics_fh.close()
    report = {
        "buffers_processed": n,
        "ascans_per_s": round(n * acq.ascans_per_buffer / dt, 1),
        "mb_per_s": round(n * acq.bytes_per_buffer / 1e6 / dt, 1),
    }
    if windows:
        report["windows"] = len(windows)
        report["last_window"] = windows[-1]
        report["best_window_ascans_per_s"] = max(
            w["ascans_per_s"] for w in windows)
    print(json.dumps(report))
    return 0


def cmd_render(args) -> int:
    from .viz import RenderMode, RenderParams, builtin_lut, render_volume, save_png

    device = _device(args)
    data = np.fromfile(args.input, dtype=np.float32)
    volume = data.reshape(args.bscans, args.ascans, args.depth)
    params = RenderParams(mode=RenderMode(args.mode), threshold=args.threshold,
                          gamma=args.gamma, step_length=args.step_length)
    lut = builtin_lut(args.lut) if args.lut else None
    img = render_volume(volume, params, yaw=args.yaw, pitch=args.pitch,
                        out_shape=(args.size, args.size), lut=lut, device=device)
    save_png(args.out, img)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


def cmd_compare(args) -> int:
    """Fidelity harness: PSNR/SSIM of a processed volume vs a reference
    volume (BASELINE: 'B-scan PSNR vs reference within its SNR bound').

    Workflow for an externally produced reference (e.g. the reference
    application's recorded output on the figshare volume,
    /root/reference/README.md:70-72):

        octproz-tpu-torch process in.raw ... --output got.raw
        octproz-tpu-torch compare got.raw ref.raw --bscans B --ascans A \\
            --depth D --ref-dtype uint8 --min-psnr 25
    """
    from .utils.fidelity import compare_volumes, load_volume

    shape = (args.bscans, args.ascans, args.depth)
    got = load_volume(args.got, shape, dtype=args.dtype)
    ref = load_volume(args.ref, shape, dtype=args.ref_dtype)
    clip = (0.0, 1.0) if args.clip01 else None
    res = compare_volumes(got, ref, data_range=args.data_range, clip=clip)
    out = res.to_dict()
    if args.min_psnr is not None:
        out["min_psnr_required_db"] = args.min_psnr
        out["passed"] = bool(res.psnr_db >= args.min_psnr)
    print(json.dumps(out))
    if args.min_psnr is not None and not out["passed"]:
        return 1
    return 0


def cmd_settings(args) -> int:
    """Show or save an INI settings file covering the FULL parameter surface
    (acquisition / processing / tpu / streaming / record groups with the
    reference's sidebar.h:44-96 key names).

      settings show PATH            parsed + validated file as JSON
      settings save PATH [flags]    write defaults + optional --settings base
                                    + CLI flags as a settings file

    ``save`` round-trips: loading the written file reproduces the exact
    AcqParams/ProcConfig/curve configuration.
    """
    from .utils import configmap
    from .utils.settings import SettingsManager

    if args.action == "show":
        bundle = configmap.from_settings(SettingsManager(args.path))

        def enc(d):
            return {k: (v.value if hasattr(v, "value") else v)
                    for k, v in d.items()}

        print(json.dumps({
            "acquisition": enc(bundle.acq_kwargs),
            "source": enc(bundle.source_kwargs),
            "processing": enc(bundle.cfg_kwargs),
            "curves": enc(bundle.curve_kwargs),
            "streaming": enc(bundle.streaming),
            "record": enc(bundle.recording),
            "plugins": bundle.plugins,
        }, indent=2, default=str))
        return 0

    # save: built-in defaults, overlaid with an optional --settings base
    # file, overlaid with the CLI flags -- then written to PATH
    from .params import AcqParams

    bundle = _load_bundle(args)
    a = vars(args)
    # Saving only passes the custom-curve PATH through; never load/validate
    # the CSV here (a settings file must be re-savable without its sidecar).
    # Pop BOTH sources unconditionally or the base file's path would leak
    # into _build_config and get loaded.
    cli_csv = a.pop("klin_curve_csv", None)
    base_csv = bundle.curve_kwargs.pop("custom_resampling_filepath", None)
    base_bg = bundle.curve_kwargs.pop("post_background_filepath", None)
    custom_csv = cli_csv or base_csv
    defaults = AcqParams()
    for field in _ACQ_FLAGS.values():
        bundle.acq_kwargs.setdefault(field, getattr(defaults, field))
    acq, cfg, model_kw = _build_config(args, bundle)
    curve_kw = {k: model_kw[k] for k in
                ("resample_coeffs", "dispersion_coeffs", "window_type",
                 "window_center", "window_fill_factor")}
    if custom_csv:
        curve_kw["custom_resampling_filepath"] = custom_csv
    if base_bg:
        curve_kw["post_background_filepath"] = base_bg
    sm = SettingsManager(args.path)
    configmap.to_settings(sm, acq=acq, cfg=cfg, curve_kwargs=curve_kw,
                          source_kwargs=_source_kwargs(args, bundle),
                          streaming=bundle.streaming or None,
                          recording=bundle.recording or None)
    # plugin specs round-trip too: base-file [plugins] load= merged with
    # any --plugins flags (the save/load asymmetry would otherwise
    # silently drop exactly the key the loader reads)
    plugin_specs = list(bundle.plugins) + [
        s for s in (a.get("plugins") or []) if s not in bundle.plugins]
    if plugin_specs:
        sm.set_group("plugins", {"load": ", ".join(plugin_specs)})
    sm.save()
    print(f"wrote {args.path}", file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    from . import __version__
    from .utils.deviceinfo import format_report

    print(f"octproz_tpu_torch {__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda or 'none'}, "
          f"CUDA available: {torch.cuda.is_available()}")
    print(format_report())
    # registry report (SystemChooser / extension-list analog): built-ins
    # plus everything runtime plugin discovery found
    ctx = _plugin_context(args, _load_bundle(args))
    print("acquisition systems: "
          + (", ".join(ctx.systems.names) or "none"))
    print("extensions: "
          + (", ".join(sorted(ctx.extensions.extensions)) or "none"))
    # about/acknowledgments (AboutDialog analog: version + third-party
    # credits, octproz/src/aboutdialog.*)
    print("license: MIT; capability reference: OCTproZ (spectralcode, "
          "GPLv2 app / MIT DevKit) - independent implementation, no code "
          "shared")
    print(f"third-party: torch {torch.__version__}, numpy {np.__version__} "
          "(BSD-style licenses); optional Pillow (LUT files, camera frame "
          "files) and matplotlib (line plots)")
    return 0


def cmd_bench(args) -> int:
    from . import bench

    _device(args)
    bench.main()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="octproz_tpu_torch",
        description="FD-OCT processing framework on PyTorch and CUDA")
    p.add_argument("--device", default="cuda", metavar="DEVICE",
                   help="torch device of the pipeline and the renderer "
                        "(default: cuda, the first CUDA device; an error "
                        "without one); 'cpu' runs the plain torch versions "
                        "of the kernels on the CPU")
    sub = p.add_subparsers(dest="command", required=True)

    pp = sub.add_parser("process", help="process a raw volume file")
    pp.add_argument("input", help=".raw file (unpacked little-endian "
                                  "samples), or 'system:NAME' to acquire "
                                  "from a registered system")
    _add_acq_args(pp)
    _add_proc_args(pp)
    pp.add_argument("--max-buffers", type=int, default=None)
    pp.add_argument("--output", default=None, help="write processed float32 .raw")
    pp.add_argument("--bscan-png", default=None)
    pp.add_argument("--frame", type=int, default=0, help="B-scan frame number")
    pp.add_argument("--enface-png", default=None)
    pp.add_argument("--depth", type=int, default=0, help="en-face depth index")
    pp.add_argument("--render-png", default=None)
    pp.add_argument("--render-mode", default="mip",
                    choices=["isosurface", "alpha_blending", "mip", "depth_mip",
                             "mida", "xray", "oct_depth"])
    pp.add_argument("--lut", default=None)
    pp.add_argument("--plot-png", default=None,
                    help="1D raw-spectrum + processed A-scan plot")
    pp.add_argument("--plot-ascan", type=int, default=0)
    pp.set_defaults(fn=cmd_process)

    pr = sub.add_parser("replay", help="stream a file through the runtime")
    pr.add_argument("input",
                    help="raw volume file, or 'system:NAME' to stream from "
                         "a registered acquisition system (e.g. "
                         "system:phytooct); device settings come from the "
                         "[system:NAME] group of --settings")
    _add_acq_args(pr)
    _add_proc_args(pr)
    pr.add_argument("--max-buffers", type=int, default=None)
    pr.add_argument("--wait-us", type=int, default=0,
                    help="artificial per-buffer delay (rate emulation)")
    pr.add_argument("--stream", action="store_true", help="fetch processed data")
    pr.add_argument("--skip", type=int, default=None,
                    help="streaming buffers to skip")
    pr.add_argument("--chunk", type=int, default=1, metavar="K",
                    help="throughput mode: batch K buffers into ONE device "
                         "dispatch (at the cost of K buffers of latency)")
    pr.add_argument("--chunk-strategy", choices=["auto", "scan", "batch"],
                    default="auto",
                    help="chunk dispatch: 'batch' = one fused kernel over "
                         "the whole chunk, 'scan' = per-buffer steps with "
                         "the FPN state carried, 'auto' = batch when the "
                         "config allows it")
    pr.add_argument("--no-upload-prefetch", action="store_true",
                    help="disable the pipelined H2D upload thread (uploads "
                         "then happen inline on the engine loop)")
    pr.add_argument("--prefetch-depth", type=int, default=2,
                    help="host prefetch + device upload queue depth "
                         "(device-side raw backlog = depth x buffer bytes)")
    pr.add_argument("--metrics-window", type=float, default=5.0)
    pr.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="stream each throughput window as a JSON line to "
                         "PATH (the engine's live-counter record)")
    pr.add_argument("--wire-format", choices=["uint16", "packed12"],
                    default="uint16",
                    help="host->device wire format; 'packed12' uploads "
                         "1.5 bytes/sample and unpacks on device (needs a "
                         "source yielding packed bytes, e.g. --packed-12bit "
                         "with --keep-packed)")
    pr.add_argument("--keep-packed", action="store_true",
                    help="with --packed-12bit: hand the engine the packed "
                         "wire bytes instead of unpacking on host")
    rec = pr.add_argument_group("recording (octprozapp.cpp:215-299 analog)")
    rec.add_argument("--record-background", type=int, default=0, metavar="N",
                     help="capture the post-process background from the "
                          "next N processed buffers (cuda_code.cu:1556-1562)")
    rec.add_argument("--record", action="store_true")
    rec.add_argument("--record-dir", default=None)
    rec.add_argument("--record-name", default=None)
    rec.add_argument("--record-buffers", type=int, default=None)
    rec.add_argument("--record-raw", action="store_true")
    rec.add_argument("--record-processed", action="store_true")
    rec.add_argument("--record-float32", action="store_true",
                     help="record processed data as float32 instead of quantized")
    rec.add_argument("--record-start-with-volume", action="store_true")
    rec.add_argument("--schedule-interval", type=float, default=None,
                     help="record a time series every N seconds")
    rec.add_argument("--schedule-total", type=int, default=1)
    live = pr.add_argument_group("live view (GLWindow2D/info-box analog)")
    live.add_argument("--live", action="store_true",
                      help="serve a browser live view while streaming")
    live.add_argument("--live-port", type=int, default=8765)
    live.add_argument("--live-host", default="127.0.0.1")
    live.add_argument("--live-lut", default="gray")
    live.add_argument("--live-volume", action="store_true",
                      help="periodic 3D render of the assembled volume "
                           "(GLWindow3D analog, throttled)")
    live.add_argument("--camera-dir", default=None, metavar="PATH",
                      help="serve a sample-view camera pane from image "
                           "files in PATH (Camera extension analog; cycles "
                           "frames at --camera-fps; implies --live)")
    live.add_argument("--camera-fps", type=float, default=10.0)
    pr.set_defaults(fn=cmd_replay)

    pv = sub.add_parser("render", help="render a processed float32 volume")
    pv.add_argument("input")
    pv.add_argument("--bscans", type=int, required=True)
    pv.add_argument("--ascans", type=int, required=True)
    pv.add_argument("--depth", type=int, required=True)
    pv.add_argument("--mode", default="mip")
    pv.add_argument("--threshold", type=float, default=0.25)
    pv.add_argument("--gamma", type=float, default=2.0)
    pv.add_argument("--step-length", type=float, default=0.01)
    pv.add_argument("--yaw", type=float, default=0.5)
    pv.add_argument("--pitch", type=float, default=0.4)
    pv.add_argument("--size", type=int, default=512)
    pv.add_argument("--lut", default=None)
    pv.add_argument("--out", required=True)
    pv.set_defaults(fn=cmd_render)

    pc = sub.add_parser("compare",
                        help="PSNR/SSIM of a processed volume vs a reference")
    pc.add_argument("got", help="this pipeline's processed volume (.raw)")
    pc.add_argument("ref", help="reference volume (.raw)")
    pc.add_argument("--bscans", type=int, required=True)
    pc.add_argument("--ascans", type=int, required=True)
    pc.add_argument("--depth", type=int, required=True)
    pc.add_argument("--dtype", default="float32",
                    choices=["float32", "float64", "uint8", "uint16", "uint32"])
    pc.add_argument("--ref-dtype", default="float32",
                    choices=["float32", "float64", "uint8", "uint16", "uint32"],
                    help="reference file sample type (quantized uints are "
                         "scaled to [0,1], inverting floatToOutput)")
    pc.add_argument("--data-range", type=float, default=None,
                    help="PSNR peak range; default: reference max-min")
    pc.add_argument("--clip01", action="store_true",
                    help="clip both volumes to [0,1] first (display range; "
                         "keeps log-floor voxels from dominating the MSE)")
    pc.add_argument("--min-psnr", type=float, default=None,
                    help="exit non-zero if overall PSNR is below this (dB)")
    pc.set_defaults(fn=cmd_compare)

    pset = sub.add_parser(
        "settings", help="show or save an INI settings file "
                         "(full sidebar.h:44-96 key surface)")
    pset.add_argument("action", choices=["show", "save"])
    pset.add_argument("path", help="settings INI file")
    _add_acq_args(pset)
    _add_proc_args(pset)
    pset.set_defaults(fn=cmd_settings)

    pi = sub.add_parser("info", help="device + version report, plus the "
                                     "registered acquisition systems and "
                                     "extensions (built-in + plugins)")
    pi.add_argument("--settings", default=None,
                    help="settings INI (enables [plugins] load= discovery)")
    pi.add_argument("--plugins", action="append", default=None,
                    metavar="PKG.MOD[:FACTORY]")
    pi.add_argument("--no-entry-point-plugins", action="store_true",
                    default=False)
    pi.set_defaults(fn=cmd_info)

    pb = sub.add_parser("bench", help="run the port's benchmark on the card "
                                      "(python -m octproz_tpu_torch.bench)")
    pb.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename or e}", file=sys.stderr)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
