"""Camera extension: live sample-view video alongside the OCT stream.

A copy of ``octproz_tpu/extensions/camera.py`` (numpy; Pillow is imported
only where a frame file is read or a snapshot written).  The live viewer
serves its frames at ``/camera.png`` once ``LiveView.attach_camera`` is
given the extension (viz/live.py, encoded there without Pillow).

Capability-equivalent of the reference's Camera extension
(docs/docs/plugins.md:22-24: "displays live video ... of
the sample under examination" with snapshot saving), re-designed for a
headless host: instead of a Qt widget wrapping a local webcam device,
a :class:`FrameSource` supplies frames (a directory of images cycled at a
fixed rate, a user callable bridging any capture SDK, or a hardware
bridge) and the frames are served into the live HTTP viewer
(``/camera.png``, viz/live.py) next to the B-scan/en-face panes.

The hardware capture itself is out of scope exactly like the reference's
(its plugin links OpenCV; ours accepts any callable producing RGB
arrays) — :class:`DirectoryCamera` doubles as the virtual test camera the
same way VirtualOCTSystem stands in for an acquisition board.
"""

from __future__ import annotations

import glob
import os
import threading
import time
from typing import Callable, Optional, Protocol, Sequence

import numpy as np

from ..plugins import Extension


class FrameSource(Protocol):
    """Anything that can produce the current camera frame."""

    def get_frame(self) -> Optional[np.ndarray]:
        """Latest frame as (H, W) or (H, W, 3) uint8, or None if absent."""
        ...


class CallableCamera:
    """Adapts any zero-arg callable (capture-SDK bridge) to FrameSource."""

    def __init__(self, fn: Callable[[], Optional[np.ndarray]]):
        self._fn = fn

    def get_frame(self) -> Optional[np.ndarray]:
        frame = self._fn()
        return None if frame is None else np.asarray(frame, np.uint8)


class DirectoryCamera:
    """Cycles image files from a directory at ``fps`` — the virtual camera
    (and the replay path for recorded sample video).

    Frames are loaded lazily and cached; ``get_frame`` returns the file for
    the current time slot, so a stalled consumer simply skips frames like a
    real camera.
    """

    def __init__(self, path: str, pattern: str = "*.png", fps: float = 10.0):
        self.paths: Sequence[str] = sorted(glob.glob(os.path.join(path, pattern)))
        if not self.paths:
            raise ValueError(f"no '{pattern}' frames in {path}")
        self.fps = fps
        self._t0 = time.monotonic()
        self._cache: dict = {}

    def _load(self, p: str) -> np.ndarray:
        if p not in self._cache:
            from PIL import Image

            self._cache[p] = np.asarray(Image.open(p).convert("RGB"),
                                        np.uint8)
        return self._cache[p]

    def get_frame(self) -> Optional[np.ndarray]:
        i = int((time.monotonic() - self._t0) * self.fps) % len(self.paths)
        return self._load(self.paths[i])


class CameraExtension(Extension):
    """The extension object: owns a FrameSource, guards concurrent access,
    counts frames, and saves snapshots (the reference extension's snapshot
    button).  Does not consume OCT data (wants_raw_data/processed False) —
    it is a side channel, like the reference's."""

    name = "camera"
    wants_raw_data = False
    wants_processed_data = False

    def __init__(self, source: FrameSource):
        super().__init__()
        self.source = source
        self._lock = threading.Lock()
        self.frames_served = 0
        self.last_frame: Optional[np.ndarray] = None

    def current_frame(self) -> Optional[np.ndarray]:
        with self._lock:
            frame = self.source.get_frame()
            if frame is not None:
                self.last_frame = frame
                self.frames_served += 1
            return frame if frame is not None else self.last_frame

    def snapshot(self, path: str) -> Optional[str]:
        """Save the current frame as PNG (reference: snapshot saving)."""
        frame = self.current_frame()
        if frame is None:
            return None
        from PIL import Image

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        Image.fromarray(frame).save(path)
        return path
