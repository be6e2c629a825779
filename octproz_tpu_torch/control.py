"""Live parameter re-tuning surface for a running pipeline.

Counterpart of ``octproz_tpu/control.py`` over the port's
:class:`~octproz_tpu_torch.models.fdoct.FdOctModel` and
:class:`~octproz_tpu_torch.runtime.StreamingEngine`: the same command set,
the same replies.  Commands are handled one at a time (a lock), since the
live viewer serves requests on several threads.

Capability-equivalent of the reference's live control paths (SURVEY.md
section 3.5): sidebar edits writing OctAlgorithmParameters fields +
updateResampleCurve/updateDispersionCurve/updateWindowCurve
(octalgorithmparameters.cpp:141-249) and the plugin request signals
``setKLinCoeffsRequest`` / ``setDispCompCoeffsRequest`` /
``setGrayscaleConversionRequest`` (octproz_devkit/src/plugin.h:82-84)
handled by OCTproZApp (octprozapp.cpp:456-517).

:class:`ParamController` is a :class:`~octproz_tpu_torch.plugins.Plugin`, so the
same command set reaches it from every remote surface:

* the socket-stream extension routes ``{"command": ..., "target":
  "processing"}`` JSON lines to it over the message bus, and
* the live HTTP viewer (viz/live.py) POSTs to ``/control``.

Curve-only changes (k-lin / dispersion coefficients, window, custom
resampling curve, post background) build a whole new ``Curves`` on the
model's device -- the operators and, for the one-pass kernels, their bf16
parts split anew -- the analog of the reference's dirty-flag driven async
LUT re-uploads (cuda_code.cu:1432-1445).  ProcConfig changes (grayscale
range, FPN mode, interpolation) build a new step function with its curves
(``FdOctModel.set_config``), like the reference switching its fused kernel
dispatch.  The model publishes each change as one (config, curves, step)
snapshot in a single attribute; the engine reads that snapshot once per
buffer, so every buffer runs wholly on the old or wholly on the new
parameters.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

import numpy as np

from .params import WindowType
from .plugins import Plugin


def _coeffs(params: Dict[str, Any], prefix: str = "c") -> tuple:
    if "coeffs" in params:
        c = [float(x) for x in params["coeffs"]]
        if len(c) != 4:
            raise ValueError("coeffs must have 4 entries")
        return tuple(c)
    return tuple(float(params.get(f"{prefix}{i}", 0.0)) for i in range(4))


class ParamController(Plugin):
    """Command handler mutating a :class:`FdOctModel` (and optionally its
    :class:`StreamingEngine`) while the stream runs."""

    name = "processing"

    COMMANDS = (
        "set_klin_coeffs", "set_dispersion_coeffs", "set_window",
        "set_custom_resample_curve", "set_grayscale", "set_post_background",
        "set_interpolation", "set_fpn_mode", "set_streaming",
        "start_recording", "recording_status",
        "redetermine_fpn", "record_post_background", "get_params", "stop",
        "list_extensions", "activate_extension", "deactivate_extension",
    )

    def __init__(self, model, engine=None,
                 on_info: Optional[Callable[[str], None]] = None):
        super().__init__()
        self.model = model
        self.engine = engine
        self.on_info = on_info or (lambda msg: None)
        self._lock = threading.Lock()

    # -- the command surface -------------------------------------------------
    def handle(self, command: Optional[str], params: Dict[str, Any]) -> Dict[str, Any]:
        """Execute one command; returns a JSON-able reply dict."""
        with self._lock:
            return self._handle(command, params)

    def _handle(self, command: Optional[str], params: Dict[str, Any]) -> Dict[str, Any]:
        try:
            if command == "set_klin_coeffs":  # plugin.h:82
                c = _coeffs(params)
                self.model.set_klin_coeffs(*c)
                self.on_info(f"k-lin coeffs set to {c}")
            elif command == "set_dispersion_coeffs":  # plugin.h:83
                d = _coeffs(params, "d")
                self.model.set_dispersion_coeffs(*d)
                self.on_info(f"dispersion coeffs set to {d}")
            elif command == "set_window":
                self.model.set_window(
                    WindowType(params.get("type", "hanning")),
                    center=float(params.get("center", 0.5)),
                    fill_factor=float(params.get("fill_factor", 1.0)))
            elif command == "set_custom_resample_curve":
                curve = np.asarray(params["values"], np.float32)
                self.model.set_custom_resample_curve(curve)
            elif command == "set_grayscale":  # plugin.h:84 (new step)
                self.model.set_config(
                    grayscale_min=float(params.get(
                        "min", self.model.cfg.grayscale_min)),
                    grayscale_max=float(params.get(
                        "max", self.model.cfg.grayscale_max)))
            elif command == "set_post_background":
                self.model.set_post_background(
                    np.asarray(params["values"], np.float32))
            elif command == "set_interpolation":  # sidebar.cpp:323 (new step)
                from .params import Interpolation

                self.model.set_config(
                    interpolation=Interpolation(params["type"]))
                self.on_info(f"interpolation set to {params['type']}")
            elif command == "set_fpn_mode":  # sidebar.cpp:328 (new step)
                from .params import FpnMode

                self.model.set_config(fpn_mode=FpnMode(params["mode"]))
                self.on_info(f"fpn mode set to {params['mode']}")
            elif command == "set_streaming":
                # streaming toggle + skip-N decimation (sidebar.cpp:339-344,
                # streamingBuffersToSkip octalgorithmparameters.h:189-192)
                if self.engine is None:
                    return {"error": "no engine attached"}
                if "skip" in params:
                    skip = int(params["skip"])
                    if skip < 0:
                        raise ValueError("skip must be >= 0")
                    self.engine.streaming_skip = skip
                if "enabled" in params:
                    self.engine.stream_to_host = bool(params["enabled"])
                self.on_info(
                    f"streaming: enabled={self.engine.stream_to_host} "
                    f"skip={self.engine.streaming_skip}")
            elif command == "start_recording":
                # remote record trigger (startRecordingRequest plugin.h:85;
                # sidebar recording params sidebar.cpp:346-359)
                if self.engine is None:
                    return {"error": "no engine attached"}
                if self.engine.recording:
                    return {"error": "recording already in progress"}
                from .io.recorder import RecordingParams

                self.engine.start_recording(RecordingParams(
                    save_dir=str(params.get("dir", ".")),
                    name=str(params.get("name", "remote")),
                    buffers_to_record=int(params.get("buffers", 1)),
                    save_raw=bool(params.get("raw", False)),
                    save_processed=bool(params.get("processed", True)),
                    save_meta=bool(params.get("meta", True)),
                    save_screenshots=bool(params.get("screenshots", False)),
                    start_with_first_buffer_of_volume=bool(
                        params.get("start_at_volume", False)),
                    stop_after_record=bool(params.get("stop_after", False))))
            elif command == "recording_status":
                if self.engine is None:
                    return {"error": "no engine attached"}
                return {"reply": {
                    "recording": self.engine.recording,
                    "raw": self.engine.raw_recorder.recording,
                    "processed": self.engine.processed_recorder.recording,
                    "last_file": self.engine.processed_recorder.last_file
                    or self.engine.raw_recorder.last_file}}
            elif command == "redetermine_fpn":  # cuda_code.cu:1521
                self.model.redetermine_fpn()
            elif command == "record_post_background":
                if self.engine is None:
                    return {"error": "no engine attached"}
                self.engine.record_post_background(int(params.get("n", 1)))
            elif command == "get_params":
                return {"reply": self.describe()}
            elif command == "stop":  # plugin.h:86 stopProcessingRequest
                if self.engine is None:
                    return {"error": "no engine attached"}
                self.engine.stop()
            elif command in ("list_extensions", "activate_extension",
                             "deactivate_extension"):
                # headless ExtensionUIManager analog (src/extensionuimanager
                # .cpp: activation toggles without the Qt tabs)
                if self.engine is None:
                    return {"error": "no engine attached"}
                exts = self.engine.extensions.extensions
                if command == "list_extensions":
                    return {"reply": {n: e.active for n, e in exts.items()}}
                name = params.get("name", "")
                if name not in exts:
                    return {"error": f"unknown extension {name!r}",
                            "extensions": sorted(exts)}
                if command == "activate_extension":
                    exts[name].activate()
                else:
                    exts[name].deactivate()
            else:
                return {"error": f"unknown command {command!r}",
                        "commands": list(self.COMMANDS)}
            return {"reply": "ok"}
        except (KeyError, TypeError, ValueError) as e:
            return {"error": str(e)}

    def describe(self) -> Dict[str, Any]:
        kw = self.model._curve_kwargs
        return {
            "klin_coeffs": list(kw["resample_coeffs"]),
            "dispersion_coeffs": list(kw["dispersion_coeffs"]),
            "window_type": kw["window_type"].value,
            "window_center": kw["window_center"],
            "window_fill_factor": kw["window_fill_factor"],
            "grayscale_min": self.model.cfg.grayscale_min,
            "grayscale_max": self.model.cfg.grayscale_max,
            "fpn_mode": self.model.cfg.fpn_mode.value,
            "interpolation": self.model.cfg.interpolation.value,
            "streaming_enabled": (self.engine.stream_to_host
                                  if self.engine else None),
            "streaming_skip": (self.engine.streaming_skip
                               if self.engine else None),
            "recording": (self.engine.recording if self.engine else None),
            "commands": list(self.COMMANDS),
        }

    # -- message-bus entry point (pluginmessagebus.cpp:28-56 route) ----------
    def receive_command(self, sender: str, command: str,
                        params: Dict[str, Any]) -> None:
        reply = self.handle(command, params)
        if "error" in reply:
            self.on_info(f"control: {sender}: {reply['error']}")
