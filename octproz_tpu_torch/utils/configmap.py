"""Declarative mapping between the framework configuration and the INI
settings file: every acquisition / processing / window / coefficient /
streaming / recording parameter round-trips through one table.

Capability-equivalent of the reference's full settings surface: the sidebar
writes every processing key into the "processing"/"streaming"/"record"
groups using the macro key names of
octproz_project/octproz/src/sidebar.h:44-96, persisted by
SettingsFileManager (src/settingsfilemanager.h:100-125) and restored at
startup (src/octprozapp.cpp:526-583).  The same key names are used here so
a reference user finds their parameters where they expect them; TPU-build
knobs without a reference equivalent live in their own "tpu" group.

Two directions:

* :func:`to_settings` — write AcqParams / ProcConfig / curve kwargs /
  source / streaming / recording state into a SettingsManager.
* :func:`from_settings` — parse a settings file into keyword dicts
  (:class:`SettingsBundle`); only keys actually present in the file are
  returned, so partial files merge cleanly under CLI flags.

Values are validated on read against the same vocabularies the CLI uses
(enum names, dtype strings); a bad value raises ``ValueError`` naming the
group and key instead of surfacing as a trace-time KeyError.

A copy of ``octproz_tpu/utils/configmap.py`` with the same tables, so one
settings file selects the same configuration in both packages (the "tpu"
group keeps its name; ``[tpu] fold_concat`` selects the concat fold
kernels; ``[plugins] load`` names the plugin specs for
``plugins.load_plugins``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..params import AcqParams, FpnMode, Interpolation, ProcConfig, WindowType
from .settings import SettingsManager

# group names (sidebar.h:44-46: REC "record", PROC "processing",
# STREAM "streaming")
ACQ = "acquisition"
PROC = "processing"
TPU = "tpu"
STREAM = "streaming"
REC = "record"

_TRUE = ("1", "true", "yes", "on")


def _parse_bool(v: str) -> bool:
    return str(v).strip().lower() in _TRUE


# (ini_key, field, parser) per group.  Key names follow sidebar.h:44-96.
_ACQ_TABLE = [
    ("samples_per_line", "samples_per_line", int),
    ("ascans_per_bscan", "ascans_per_bscan", int),
    ("bscans_per_buffer", "bscans_per_buffer", int),
    ("buffers_per_volume", "buffers_per_volume", int),
    ("bit_depth", "bit_depth", int),
]

# raw-input framing options of the acquisition source (VirtualOCTSystem
# params analog, virtualoctsystem.cpp:40-51)
_SOURCE_TABLE = [
    ("packed_12bit", "packed_12bit", _parse_bool),
    ("big_endian", "big_endian", _parse_bool),
    ("copy_file_to_ram", "copy_to_ram", _parse_bool),
]

_PROC_TABLE = [
    ("bitshift", "bitshift", _parse_bool),                       # PROC_BITSHIFT
    ("flip_bscans", "bscan_flip", _parse_bool),                  # PROC_FLIP_BSCANS
    ("background_removal", "background_removal", _parse_bool),
    ("background_removal_window_size", "rolling_average_window", int),
    ("resampling", "resampling", _parse_bool),
    ("dispersion_compensation", "dispersion", _parse_bool),
    ("windowing", "windowing", _parse_bool),
    ("log", "log_scaling", _parse_bool),                         # PROC_LOG
    ("min", "grayscale_min", float),                             # PROC_MIN
    ("max", "grayscale_max", float),                             # PROC_MAX
    ("coeff", "multiplicator", float),                           # PROC_COEFF
    ("addend", "addend", float),                                 # PROC_ADDEND
    ("fixed_pattern_removal_bscans", "bscans_for_noise", int),
    ("sinusoidal_scan_correction", "sinusoidal_correction", _parse_bool),
    ("post_processing_background_removal", "post_background_removal",
     _parse_bool),
    ("post_processing_background_removal_weight", "post_background_weight",
     float),
    ("post_processing_background_removal_offset", "post_background_offset",
     float),
]

# TPU-build knobs (ProcConfig fields with no reference counterpart)
_TPU_TABLE = [
    ("resample_via_matmul", "resample_via_matmul", _parse_bool),
    ("compute_dtype", "compute_dtype", str),
    ("matmul_precision", "matmul_precision", str),
    ("output_dtype", "output_dtype", str),
    ("use_pallas_prep", "use_pallas_prep", _parse_bool),
    ("fft_via_matmul", "fft_via_matmul", _parse_bool),
    ("fold_backend", "fold_backend", str),
    ("fused_scale", "fused_scale", _parse_bool),
    ("fold_concat", "fold_concat", _parse_bool),
    ("fold_k_split", "fold_k_split", int),
    ("fast_log", "fast_log", _parse_bool),
    ("pallas_tile", "pallas_tile", int),
]

_STREAM_TABLE = [
    ("streaming_enabled", "stream_to_host", _parse_bool),  # STREAM_STREAMING
    ("streaming_skip", "streaming_skip", int),             # STREAM_STREAMING_SKIP
]

# RecordingParams kwargs (sidebar.h REC_* keys; octalgorithmparameters.h:84-98)
_REC_TABLE = [
    ("path", "save_dir", str),
    ("name", "name", str),
    ("volumes", "buffers_to_record", int),
    ("record_raw", "save_raw", _parse_bool),
    ("record_processed", "save_processed", _parse_bool),
    ("save_as_32_bit_float", "save_as_32bit_float", _parse_bool),
    ("start_with_first_buffer", "start_with_first_buffer_of_volume",
     _parse_bool),
    ("save_meta_info", "save_meta", _parse_bool),
    ("record_screenshots", "save_screenshots", _parse_bool),
    ("stop_after_record", "stop_after_record", _parse_bool),
    ("description", "description", str),
]


@dataclasses.dataclass
class SettingsBundle:
    """Keyword dicts parsed from a settings file — only keys present in the
    file appear, so callers can overlay CLI flags and fall back to dataclass
    defaults for the rest."""

    acq_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    cfg_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    curve_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    source_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    streaming: Dict[str, Any] = dataclasses.field(default_factory=dict)
    recording: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: plugin specs from the [plugins] group's ``load`` key
    #: ("pkg.mod:factory, other.mod" -- the settings-file analog of the
    #: reference's plugins directory scan, octprozapp.cpp:99-174)
    plugins: list = dataclasses.field(default_factory=list)


def _parse_table(sm: SettingsManager, group: str, table, out: Dict[str, Any]):
    raw = sm.get_group(group)
    for ini_key, field, parse in table:
        if ini_key not in raw:
            continue
        try:
            out[field] = parse(raw[ini_key])
        except (ValueError, TypeError) as e:
            raise ValueError(f"settings [{group}] {ini_key}: {e}") from e


def _parse_enum(group: str, key: str, value: str, enum_cls):
    try:
        return enum_cls(value.strip().lower())
    except ValueError:
        valid = ", ".join(m.value for m in enum_cls)
        raise ValueError(f"settings [{group}] {key}: {value!r} is not one of "
                         f"{valid}") from None


def from_settings(sm: SettingsManager) -> SettingsBundle:
    """Parse every recognized key of a settings file (missing keys are
    simply absent from the returned dicts)."""
    b = SettingsBundle()
    _parse_table(sm, ACQ, _ACQ_TABLE, b.acq_kwargs)
    _parse_table(sm, ACQ, _SOURCE_TABLE, b.source_kwargs)
    _parse_table(sm, PROC, _PROC_TABLE, b.cfg_kwargs)
    _parse_table(sm, TPU, _TPU_TABLE, b.cfg_kwargs)
    _parse_table(sm, STREAM, _STREAM_TABLE, b.streaming)
    _parse_table(sm, REC, _REC_TABLE, b.recording)

    # [plugins] load = pkg.mod:factory, other.mod  (runtime plugin loading)
    plug = sm.get_group("plugins")
    if "load" in plug:
        b.plugins = [s.strip() for s in str(plug["load"]).replace(";", ",")
                     .split(",") if s.strip()]

    proc = sm.get_group(PROC)
    if "resampling_interpolation" in proc:
        b.cfg_kwargs["interpolation"] = _parse_enum(
            PROC, "resampling_interpolation",
            proc["resampling_interpolation"], Interpolation)
    # FPN mode from the reference's two booleans (PROC_FIXED_PATTERN_REMOVAL
    # + _CONTINUOUSLY) unless the explicit mode key is present
    if "fixed_pattern_removal_mode" in proc:
        b.cfg_kwargs["fpn_mode"] = _parse_enum(
            PROC, "fixed_pattern_removal_mode",
            proc["fixed_pattern_removal_mode"], FpnMode)
    elif "fixed_pattern_removal" in proc:
        if not _parse_bool(proc["fixed_pattern_removal"]):
            b.cfg_kwargs["fpn_mode"] = FpnMode.OFF
        elif _parse_bool(proc.get("fixed_pattern_removal_continuously", "0")):
            b.cfg_kwargs["fpn_mode"] = FpnMode.CONTINUOUS
        else:
            b.cfg_kwargs["fpn_mode"] = FpnMode.ONCE

    # curve kwargs: polynomial coefficients, window, custom curve file
    for prefix, field, keys in (
            ("resampling_c", "resample_coeffs",
             ["resampling_c0", "resampling_c1", "resampling_c2",
              "resampling_c3"]),
            ("dispersion_compensation_d", "dispersion_coeffs",
             ["dispersion_compensation_d0", "dispersion_compensation_d1",
              "dispersion_compensation_d2", "dispersion_compensation_d3"])):
        if any(k in proc for k in keys):
            try:
                # Missing slots stay None: the consumer overlays them on
                # its defaults (identity resampling is (0, N-1, 0, 0) — a
                # zero-fill would collapse the curve to sample 0).
                b.curve_kwargs[field] = tuple(
                    float(proc[k]) if k in proc else None for k in keys)
            except ValueError as e:
                raise ValueError(f"settings [{PROC}] {prefix}0..3: {e}") from e
    if "window_type" in proc:
        b.curve_kwargs["window_type"] = _parse_enum(
            PROC, "window_type", proc["window_type"], WindowType)
    if "window_center_position" in proc:
        b.curve_kwargs["window_center"] = float(proc["window_center_position"])
    if "window_fill_factor" in proc:
        b.curve_kwargs["window_fill_factor"] = float(proc["window_fill_factor"])
    if (_parse_bool(proc.get("custom_resampling", "0"))
            and proc.get("custom_resampling_filepath")):
        b.curve_kwargs["custom_resampling_filepath"] = \
            proc["custom_resampling_filepath"]
    if proc.get("post_processing_background_filepath"):
        # PROC_POST_BACKGROUND_FILEPATH (sidebar.h:91): the recorded
        # background curve file
        b.curve_kwargs["post_background_filepath"] = \
            proc["post_processing_background_filepath"]

    # Legacy keys an earlier CLI read from [processing] (its
    # _apply_settings_file); the canonical locations above win.
    if "klin_coeffs" in proc and "resample_coeffs" not in b.curve_kwargs:
        try:
            coeffs = tuple(float(x) for x in proc["klin_coeffs"].split(","))
            if len(coeffs) != 4:
                raise ValueError(f"expected 4 comma-separated values, "
                                 f"got {len(coeffs)}")
        except ValueError as e:
            raise ValueError(f"settings [{PROC}] klin_coeffs: {e}") from e
        b.curve_kwargs["resample_coeffs"] = coeffs
    for key in ("compute_dtype", "matmul_precision", "output_dtype"):
        if key in proc:
            b.cfg_kwargs.setdefault(key, proc[key])
    return b


def to_settings(
    sm: SettingsManager,
    acq: Optional[AcqParams] = None,
    cfg: Optional[ProcConfig] = None,
    curve_kwargs: Optional[Dict[str, Any]] = None,
    source_kwargs: Optional[Dict[str, Any]] = None,
    streaming: Optional[Dict[str, Any]] = None,
    recording: Optional[Dict[str, Any]] = None,
) -> SettingsManager:
    """Write the given state into the manager's groups (the sidebar-write
    analog, sidebar.cpp:319-359).  Call ``sm.save()`` to persist."""

    def fmt(v):
        return str(int(v)) if isinstance(v, bool) else str(v)

    if acq is not None:
        sm.update_group(ACQ, {k: fmt(getattr(acq, f))
                              for k, f, _ in _ACQ_TABLE})
    if source_kwargs:
        sm.update_group(ACQ, {k: fmt(source_kwargs[f])
                              for k, f, _ in _SOURCE_TABLE
                              if f in source_kwargs})
    if cfg is not None:
        proc = {k: fmt(getattr(cfg, f)) for k, f, _ in _PROC_TABLE}
        proc["resampling_interpolation"] = cfg.interpolation.value
        # both the reference's boolean pair and the explicit mode
        proc["fixed_pattern_removal"] = fmt(cfg.fpn_mode != FpnMode.OFF)
        proc["fixed_pattern_removal_continuously"] = \
            fmt(cfg.fpn_mode == FpnMode.CONTINUOUS)
        proc["fixed_pattern_removal_mode"] = cfg.fpn_mode.value
        sm.update_group(PROC, proc)
        sm.update_group(TPU, {k: fmt(getattr(cfg, f))
                              for k, f, _ in _TPU_TABLE})
    if curve_kwargs:
        proc = {}
        for field, keys in (("resample_coeffs",
                             ["resampling_c0", "resampling_c1",
                              "resampling_c2", "resampling_c3"]),
                            ("dispersion_coeffs",
                             ["dispersion_compensation_d0",
                              "dispersion_compensation_d1",
                              "dispersion_compensation_d2",
                              "dispersion_compensation_d3"])):
            coeffs = curve_kwargs.get(field)
            if coeffs is not None:
                # None slots mark unspecified coefficients (partial files,
                # from_settings contract) — leave them unwritten
                for k, c in zip(keys, coeffs):
                    if c is not None:
                        proc[k] = repr(float(c))
        wt = curve_kwargs.get("window_type")
        if wt is not None:
            proc["window_type"] = wt.value if isinstance(wt, WindowType) else str(wt)
        if curve_kwargs.get("window_center") is not None:
            proc["window_center_position"] = repr(
                float(curve_kwargs["window_center"]))
        if curve_kwargs.get("window_fill_factor") is not None:
            proc["window_fill_factor"] = repr(
                float(curve_kwargs["window_fill_factor"]))
        path = curve_kwargs.get("custom_resampling_filepath")
        if path:
            proc["custom_resampling"] = "1"
            proc["custom_resampling_filepath"] = str(path)
        bg_path = curve_kwargs.get("post_background_filepath")
        if bg_path:
            proc["post_processing_background_filepath"] = str(bg_path)
        if proc:
            sm.update_group(PROC, proc)
    if streaming:
        sm.update_group(STREAM, {k: fmt(streaming[f])
                                 for k, f, _ in _STREAM_TABLE
                                 if f in streaming})
    if recording:
        sm.update_group(REC, {k: fmt(recording[f])
                              for k, f, _ in _REC_TABLE if f in recording})
    return sm


def build_config(bundle: SettingsBundle,
                 acq_overrides: Optional[Dict[str, Any]] = None,
                 cfg_overrides: Optional[Dict[str, Any]] = None,
                 require_geometry: bool = False):
    """(AcqParams, ProcConfig) from a bundle + optional override dicts
    (CLI flags win over file values; dataclass defaults fill the rest).
    ``require_geometry`` raises unless the merged kwargs pin the buffer
    geometry explicitly (instead of silently using dataclass defaults)."""
    acq_kw = dict(bundle.acq_kwargs)
    acq_kw.update(acq_overrides or {})
    cfg_kw = dict(bundle.cfg_kwargs)
    cfg_kw.update(cfg_overrides or {})
    if require_geometry:
        missing = [f for f in ("samples_per_line", "ascans_per_bscan",
                               "bscans_per_buffer") if f not in acq_kw]
        if missing:
            raise ValueError(
                "acquisition geometry required: pass --samples/--ascans/"
                "--bscans or provide them in the settings file "
                f"(missing: {', '.join(missing)})")
    return AcqParams(**acq_kw), ProcConfig(**cfg_kw)
