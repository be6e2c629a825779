"""Display-frame extraction: B-scan slices, en-face slices, and volume
projections with frame averaging / maximum-intensity projection.

Counterpart of ``octproz_tpu/ops/projections.py`` on tensors, on whatever
device the volume lies on.  Capability-equivalent of the reference's
display-buffer kernels (octproz_project/octproz/src/cuda_code.cu):

* ``updateDisplayedBscanFrame``     (:810-860): B-scan frame = volume[b, :, :]
  with optional averaging or MIP over ``display_frames`` adjacent B-scans
  (frames past the end of the volume are skipped, not clamped).
* ``updateDisplayedEnFaceViewFrame`` (:862-912): en-face frame =
  volume[:, :, d] with averaging/MIP over adjacent depth indices.
* full-volume MIP / mean projections along any axis (the offline analog of
  the reference's GLSL raycast modes, glwindow3d.cpp:266-272).

The reference also reverses sample order for OpenGL display orientation
(cuda_code.cu:828,884); that is a presentation concern and is exposed via
``flip_display`` rather than baked in.

The average adds the frames one after another and scales the sum by the
float32 reciprocal of their count, the arithmetic XLA gives the JAX
package's mean, so that a window's mean is the same number on every
device and in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import DisplayFunction


def _frame_window(volume_frames: int, frame_nr: int, display_frames: int):
    """Static list of frame indices composited together (skip out-of-range,
    mirroring the `frameForAveraging < total` guard, cuda_code.cu:827).

    frame_nr is clamped to [0, volume_frames) first: the reference kernel's
    frameNr is unsigned (cuda_code.cu:815), so a scrubbing UI decrementing
    past 0 must not wrap to the volume's tail via Python negative indexing.
    """
    frame_nr = min(max(frame_nr, 0), volume_frames - 1)
    idx = [frame_nr + j for j in range(max(display_frames, 1))]
    idx = [i for i in idx if i < volume_frames]
    return np.asarray(idx if idx else [frame_nr], dtype=np.int32)


def _composite(frames, function: DisplayFunction) -> torch.Tensor:
    """MIP (floored at 0) or mean of a list of equally shaped frames."""
    if function == DisplayFunction.MIP and len(frames) > 1:
        # reference maxValue starts at 0 (cuda_code.cu:841-852): all-
        # negative columns display 0, not the true (negative) maximum
        return torch.stack(frames).amax(dim=0).clamp_min(0.0)
    total = frames[0]
    for f in frames[1:]:
        total = total + f
    return total * float(np.float32(1.0 / len(frames)))


def bscan_frame(volume: torch.Tensor, frame_nr: int, display_frames: int = 1,
                function: DisplayFunction = DisplayFunction.AVERAGING,
                flip_display: bool = False) -> torch.Tensor:
    """volume (bscans, ascans, depth) -> (ascans, depth) display frame."""
    idx = _frame_window(volume.shape[0], frame_nr, display_frames)
    out = _composite([volume[int(i)] for i in idx], function)
    if flip_display:
        out = out.flip(0, 1)
    return out


def enface_frame(volume: torch.Tensor, depth_nr: int, display_frames: int = 1,
                 function: DisplayFunction = DisplayFunction.AVERAGING,
                 flip_display: bool = False) -> torch.Tensor:
    """volume (bscans, ascans, depth) -> (bscans, ascans) en-face frame."""
    idx = _frame_window(volume.shape[2], depth_nr, display_frames)
    out = _composite([volume[:, :, int(i)] for i in idx], function)
    if flip_display:
        out = out.flip(0, 1)
    return out


def mip_projection(volume: torch.Tensor, axis: int = 2) -> torch.Tensor:
    """Maximum-intensity projection along an axis (offline 3D-view analog)."""
    return volume.amax(dim=axis)


def mean_projection(volume: torch.Tensor, axis: int = 2) -> torch.Tensor:
    return volume.mean(dim=axis)
