"""Recording: raw and processed buffer capture to .raw files + metadata,
with optional scheduled time-series recording.  A copy of
``octproz_tpu/io/recorder.py`` (numpy only; the port's processing
configuration is written the same way).

Capability-equivalent of the reference's ``Recorder``
(octproz_project/octproz/src/recorder.{h,cpp}): preallocate
``buffers_to_record`` slots (recorder.cpp:74), copy each incoming buffer
(recorder.cpp:122-124), optionally gate the start on the first buffer of a
volume (recorder.cpp:116-118), and write one contiguous .raw file at the end
(recorder.cpp:135-152).  Two instances ("raw" / "processed") are used by the
runtime, mirroring processing.cpp:49-70.  The recording metadata file is the
analog of the settings-file copy (octprozapp.cpp:295-298) -- here a JSON
sidecar with the full acquisition + processing configuration.

``RecordingScheduler`` mirrors the reference's timer-driven series recording
(recordingscheduler.cpp:131-155): start delay, start-to-start interval, total
recording count, overlap protection.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class RecordingParams:
    """Mirrors the reference's RecordingParams (octalgorithmparameters.h:84-98)."""

    save_dir: str = "."
    name: str = "recording"
    buffers_to_record: int = 1
    start_with_first_buffer_of_volume: bool = False
    save_raw: bool = True
    save_processed: bool = False
    save_as_32bit_float: bool = False
    save_meta: bool = True
    save_screenshots: bool = False   # B-scan/en-face/volume PNGs at finish
                                     # (octprozapp.cpp:266-292 analog)
    stop_after_record: bool = False  # auto-stop the stream when the
                                     # recording completes (REC_STOP,
                                     # octprozapp.cpp:424-446)
    settings_file: Optional[str] = None  # INI copied next to the recording
                                         # as metadata (octprozapp.cpp:295-298)
    description: str = ""


class Recorder:
    """One recording target (raw or processed)."""

    def __init__(self, name: str):
        self.name = name
        self.recording = False
        self._slots: List[np.ndarray] = []
        self._params: Optional[RecordingParams] = None
        self._start_ts: Optional[str] = None
        self._first_buffer_gate = False
        self.on_done: Optional[Callable[[str], None]] = None
        self.last_file: Optional[str] = None

    def start(self, params: RecordingParams, timestamp: Optional[str] = None) -> None:
        if self.recording:
            raise RuntimeError(f"recorder '{self.name}' is already recording")
        self._params = params
        self._slots = []
        self._start_ts = timestamp or time.strftime("%Y%m%d_%H%M%S")
        self._first_buffer_gate = params.start_with_first_buffer_of_volume
        self.recording = True

    def record_buffer(self, buffer: np.ndarray, buffer_nr_in_volume: int = 0) -> None:
        """Feed one buffer; finishes automatically once enough are captured."""
        if not self.recording:
            return
        if self._first_buffer_gate:
            if buffer_nr_in_volume != 0:
                return  # wait for the start of a volume (recorder.cpp:116-118)
            self._first_buffer_gate = False
        self._slots.append(np.asarray(buffer).copy())
        if len(self._slots) >= self._params.buffers_to_record:
            self._save()

    def _save(self) -> None:
        p = self._params
        os.makedirs(p.save_dir, exist_ok=True)
        data = np.stack(self._slots)
        dtype_tag = str(data.dtype)
        fname = f"{self._start_ts}_{p.name}_{self.name}_{dtype_tag}_" \
                f"{data.shape[-1]}x{data.shape[-2]}x{data.shape[0]*data.shape[1]}.raw"
        path = os.path.join(p.save_dir, fname)
        seq = 1
        while os.path.exists(path):  # scheduled series within one second
            seq += 1
            path = os.path.join(p.save_dir, fname[:-4] + f"_{seq}.raw")
        data.tofile(path)
        self.last_file = path
        self.recording = False
        self._slots = []
        if self.on_done:
            self.on_done(path)

    def flush(self) -> Optional[str]:
        """End-of-stream flush: save whatever was captured so a source that
        ends before ``buffers_to_record`` does not silently discard data.
        Returns the written path, or None if nothing was captured."""
        if not self.recording:
            return None
        if not self._slots:
            self.recording = False
            return None
        self._save()
        return self.last_file

    def abort(self) -> None:
        self.recording = False
        self._slots = []


def write_meta(path_prefix: str, acq, cfg, rec_params: RecordingParams,
               extra: Optional[dict] = None) -> str:
    """JSON metadata sidecar (analog of the settings.ini copy,
    octprozapp.cpp:295-298)."""
    meta = {
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "acquisition": dataclasses.asdict(acq),
        "processing": {k: (v.value if hasattr(v, "value") else v)
                       for k, v in dataclasses.asdict(cfg).items()},
        "recording": dataclasses.asdict(rec_params),
    }
    if extra:
        meta.update(extra)
    path = path_prefix + "_meta.json"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    return path


class RecordingScheduler:
    """Timer-driven series recording (recordingscheduler.cpp:131-155).

    Drives a ``start_recording`` callback every ``interval_s`` seconds after
    ``delay_s``, ``total_recordings`` times; if a recording is still running
    at a scheduled point, retries after ``retry_s`` (reference: 10 s).
    """

    def __init__(self, start_recording: Callable[[], bool],
                 delay_s: float = 0.0, interval_s: float = 60.0,
                 total_recordings: int = 1, retry_s: float = 10.0):
        self.start_recording = start_recording
        self.delay_s = delay_s
        self.interval_s = interval_s
        self.total = total_recordings
        self.retry_s = retry_s
        self.done = 0
        self._next_time: Optional[float] = None
        self.active = False

    def start(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._next_time = now + self.delay_s
        self.done = 0
        self.active = True

    def stop(self) -> None:
        self.active = False

    def poll(self, now: Optional[float] = None) -> bool:
        """Call periodically; returns True if a recording was started."""
        if not self.active or self.done >= self.total:
            self.active = self.active and self.done < self.total
            return False
        now = time.monotonic() if now is None else now
        if now < self._next_time:
            return False
        if self.start_recording():
            self.done += 1
            self._next_time += self.interval_s
            if self.done >= self.total:
                self.active = False
            return True
        # overlap protection: recording still running, retry later
        self._next_time = now + self.retry_s
        return False
