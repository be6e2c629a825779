"""Offline volume raycaster: the 7 render modes of the reference's 3D viewer.

Counterpart of ``octproz_tpu/viz/render.py`` in PyTorch, on the device it
is given.  Capability-equivalent of GLWindow3D + RayCastVolume + the GLSL
raycast shaders (octproz_project/octproz/src/glwindow3d.cpp:266-272 mode
list; shaders/*.frag), as an orthographic ray marcher: instead of one GPU
fragment thread per pixel, a Python loop over ray steps advances ALL pixels
together, each step one trilinear volume sample per pixel
(``torch.nn.functional.grid_sample``) plus the mode's compositing update.
The pixel grid, the view vectors and the LUT are made once, before the
loop.

Trilinear sampling is the JAX package's ``map_coordinates(order=1,
mode="constant", cval=0)`` at ``coords = (pos + 0.5) * (shape - 1)``: that
is ``grid_sample(mode="bilinear", padding_mode="zeros",
align_corners=True)`` at the normalized point ``2 * pos``, whose last grid
axis is ordered (x, y, z) = (depth, ascans, bscans), the reverse of the
volume's axes.  The two frameworks round the interpolation weights in
another order, so a sample may differ in its last bits; a mode that
thresholds a sample can then decide a pixel the other way.

Mode semantics (matched to the shader integration loops, not transcribed):

* MIP      (maximum_intensity_projection.frag:141-199): running max of
           samples above threshold; transfer function on the max.
* DMIP     (depth_mip.frag): MIP + depth modulation
           ``colour * ((1-w) + 2 w (1-depth_at_max))``.
* ALPHA    (alpha_blending.frag): front-to-back "over" compositing with
           alpha = intensity^alpha_exponent and the reference's ray-length
           brightness term ``a * 2.25^(frac_remaining)/1.75``.
* MIDA     (mida.frag): maximum-intensity-difference accumulation --
           compositing weighted by ``1 - (intensity - running_max)`` only
           when a new maximum is reached (Bruckner & Groeller MIDA).
* XRAY     (xray.frag): sqrt of the mean of samples above threshold.
* ISOSURFACE (isosurface.frag): first sample above threshold with two
           bisection refinement steps, Blinn-Phong shaded
           (Ia=0.75, Id=0.5, Is with exponent 600, shader shading()).
* OCT_DEPTH (oct_depth.frag + compute_sample_depths.glsl): back-to-front
           compositing colored by distance below the first surface.

All modes finish with the shader's background blend and gamma correction
(``pow(colour, 1/gamma)``).  View = yaw/pitch rotation around the volume
center (the trackball analog, src/trackball.cpp), orthographic projection.

On a CUDA device the raycast runs on a stream of its own (one the caller
keeps, as the live viewer does, or one drawn for the call), not on the
caller's current stream, where a processing pipeline enqueues, and that
stream alone is synchronized when the image comes back to the host: the
reference's display path never stalls processing either
(glwindow3d.cpp:316-323).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class RenderMode(enum.Enum):
    ISOSURFACE = "isosurface"
    ALPHA = "alpha_blending"
    MIP = "mip"
    DMIP = "depth_mip"
    MIDA = "mida"
    XRAY = "xray"
    OCT_DEPTH = "oct_depth"


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Display parameters (GLWindow3DParams, src/controlpanel.h:67-84)."""

    mode: RenderMode = RenderMode.MIP
    step_length: float = 0.01          # rayMarchStepLength
    threshold: float = 0.25
    gamma: float = 2.0
    alpha_exponent: float = 2.0
    depth_weight: float = 0.7          # DMIP depthWeight
    depth_threshold: float = 0.1       # compute_sample_depths depthIntensityThreshold
    shading: bool = False
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    material: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    light_position: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    stretch: Tuple[float, float, float] = (1.0, 1.0, 1.0)  # stretch x/y/z


def _rotation(yaw: float, pitch: float) -> np.ndarray:
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return rx @ ry


def _sample(volumes: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Trilinear samples of C stacked volumes (1, C, bscans, ascans, depth)
    at world positions ``pos`` (..., 3) in [-0.5, 0.5]^3; 0 outside.
    -> (C, ...)."""
    grid = (2.0 * pos).flip(-1).reshape(1, 1, -1, 1, 3)
    out = F.grid_sample(volumes, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.reshape(volumes.shape[1], *pos.shape[:-1])


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1, keepdim=True))


def _normal(volume: torch.Tensor, pos: torch.Tensor, eps: float = 0.01) -> torch.Tensor:
    """Central-difference gradient normal (shader normal()): the six
    neighbours in one sampling call."""
    off = torch.eye(3, dtype=torch.float32, device=pos.device) * eps
    probes = torch.stack([p for axis in range(3)
                          for p in (pos + off[axis], pos - off[axis])])
    s = _sample(volume, probes)[0]
    g = torch.stack([s[2 * axis] - s[2 * axis + 1] for axis in range(3)], dim=-1)
    return g / (_norm(g) + 1e-8)


def _blinn_phong(colour, pos, ray_dir, normal, light_position):
    """Ia=0.75, Id=0.5 max(0, N.L), Is=pow(max(0, N.H), 600) (shader shading())."""
    light = torch.tensor(light_position, dtype=torch.float32, device=pos.device)
    l = light - pos
    l = l / (_norm(l) + 1e-8)
    v = -ray_dir / (_norm(ray_dir) + 1e-8)
    h = l + v
    h = h / (_norm(h) + 1e-8)
    idiff = 0.5 * torch.clamp_min((normal * l).sum(-1), 0.0)
    ispec = torch.pow(torch.clamp_min((normal * h).sum(-1), 0.0), 600.0)
    return (0.75 + idiff)[..., None] * colour + ispec[..., None]


def compute_sample_depths(volume: torch.Tensor, threshold: float = 0.1) -> torch.Tensor:
    """Per-voxel depth-below-surface texture (compute_sample_depths.glsl:28-62).

    Scans each A-scan column from the surface side (high depth index toward 0,
    matching the shader's z loop): voxels before the first sample above
    ``threshold`` get 0; from the surface on, depth starts at 1.0 and
    decreases by 1/n per voxel.
    """
    n = volume.shape[-1]
    rev = volume.flip(-1)  # scan order: surface first
    seen = torch.cumsum((rev > threshold).to(torch.float32), dim=-1)
    started = seen > 0
    zero = torch.zeros((), dtype=torch.float32, device=volume.device)
    # voxels since the surface voxel (0 at the surface itself)
    since = torch.where(started, torch.cumsum(started.to(torch.float32), dim=-1) - 1.0, zero)
    depth = torch.where(started, torch.clamp_min(1.0 - since / n, 0.0), zero)
    return depth.flip(-1)


def _transfer(intensity, alpha_exponent, lut: Optional[torch.Tensor]):
    """colour_transfer / LUT lookup (shader colour_transfer + lut branch)."""
    a = torch.pow(intensity.clamp(0.0, 1.0), alpha_exponent)
    if lut is None:
        rgb = torch.stack([intensity] * 3, dim=-1)
    else:
        idx = intensity.clamp(0.0, 1.0) * (lut.shape[0] - 1)
        rgb = lut[torch.round(idx).to(torch.int64)]
    return rgb, a


def _render(volume, depth_tex, rot, lut, params: RenderParams, out_shape: Tuple[int, int]):
    """The raycast on ``volume``'s device: (1, 1, B, A, D) volume ->
    (H, W, 3) gamma-corrected colour."""
    dev = volume.device
    h, w = out_shape
    stretch = torch.tensor(params.stretch, dtype=torch.float32, device=dev)

    # Orthographic pixel grid on the view plane, covering the unit cube's
    # rotated extent (sqrt(3) diagonal margin).
    extent = 0.5 * math.sqrt(3.0)
    us = torch.linspace(-extent, extent, w, device=dev)
    vs = torch.linspace(-extent, extent, h, device=dev)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    # view axes in world space (rows of rot)
    right, up, fwd = rot[0], rot[1], rot[2]
    n_steps = max(int(2.0 * extent / params.step_length), 2)
    t0 = -extent
    dt = 2.0 * extent / n_steps
    origin = uu[..., None] * right + vv[..., None] * up + t0 * fwd  # (h, w, 3)
    step_vec = dt * fwd

    def pos_at(i: int) -> torch.Tensor:
        return (origin + float(i) * step_vec) / stretch  # stretch scales the volume

    def sample(pos):
        return _sample(volume, pos)[0]

    thr = params.threshold
    zeros = torch.zeros((h, w), dtype=torch.float32, device=dev)

    if params.mode in (RenderMode.MIP, RenderMode.DMIP):
        max_i, i_at_max = zeros, zeros
        for i in range(n_steps):
            s = sample(pos_at(i))
            better = (s > max_i) & (s > thr)
            max_i = torch.where(better, s, max_i)
            i_at_max = torch.where(better, float(i), i_at_max)
        rgb, a = _transfer(max_i, params.alpha_exponent, lut)
        if params.mode == RenderMode.DMIP:
            depth = i_at_max / n_steps
            wgt = (1.0 - params.depth_weight) + 2.0 * params.depth_weight * (1.0 - depth)
            rgb = rgb * wgt[..., None]
            a = a * wgt
        colour, alpha = rgb, a

    elif params.mode == RenderMode.XRAY:
        total, count = zeros, zeros
        for i in range(n_steps):
            s = sample(pos_at(i))
            use = s > thr
            total = total + torch.where(use, s, 0.0)
            count = count + use.to(torch.float32)
        avg = torch.where(count > 0, torch.sqrt(total / torch.clamp_min(count, 1.0)), 0.0)
        colour, alpha = _transfer(avg, params.alpha_exponent, lut)

    elif params.mode == RenderMode.ALPHA:
        rgb, a = torch.zeros((h, w, 3), dtype=torch.float32, device=dev), zeros
        for i in range(n_steps):
            p = pos_at(i)
            s = sample(p)
            c_rgb, c_a = _transfer(s, params.alpha_exponent, lut)
            new_rgb = c_a[..., None] * c_rgb + (1.0 - c_a)[..., None] * a[..., None] * rgb
            new_a = c_a + (1.0 - c_a) * a
            # reference ray-length brightness term (alpha_blending.frag)
            frac_remaining = 1.0 - i / n_steps
            boost = new_a * math.pow(2.25, frac_remaining) / 1.75
            new_rgb = new_rgb * boost[..., None]
            if params.shading:
                new_rgb = _blinn_phong(new_rgb, p, step_vec, _normal(volume, p),
                                       params.light_position)
            # reference loop terminates at colour.a >= 0.9
            # (alpha_blending.frag): freeze saturated pixels
            use = (s > thr) & (a < 0.9)
            rgb = torch.where(use[..., None], new_rgb, rgb)
            a = torch.where(use, new_a, a)
        colour, alpha = rgb, a

    elif params.mode == RenderMode.MIDA:
        rgb, a, max_i = torch.zeros((h, w, 3), dtype=torch.float32, device=dev), zeros, zeros
        for i in range(n_steps):
            s = sample(pos_at(i))
            c_rgb, c_a = _transfer(s, params.alpha_exponent, lut)
            weighting = 1.0 - (s - max_i)
            tmp = (1.0 - weighting * a) * c_a
            new_rgb = weighting[..., None] * rgb + tmp[..., None] * c_rgb
            new_a = weighting * a + tmp
            # mida.frag also terminates at colour.a >= 0.9
            use = (s > thr) & (s > max_i) & (a < 0.9)
            rgb = torch.where(use[..., None], new_rgb, rgb)
            a = torch.where(use, new_a, a)
            max_i = torch.where(use, s, max_i)
        colour, alpha = rgb, a

    elif params.mode == RenderMode.ISOSURFACE:
        found = torch.zeros((h, w), dtype=torch.bool, device=dev)
        hit_pos = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        for i in range(n_steps):
            p = pos_at(i)
            hit = sample(p) > thr
            hit_pos = torch.where((hit & ~found)[..., None], p, hit_pos)
            found = found | hit
        # two bisection refinements (isosurface.frag)
        p1 = hit_pos - 0.5 * step_vec / stretch
        s1 = sample(p1)
        p2 = p1 - torch.where((s1 > thr)[..., None], 0.25, -0.25) * step_vec / stretch
        material = torch.tensor(params.material, dtype=torch.float32, device=dev)
        shaded = _blinn_phong(material, p2, step_vec, _normal(volume, p2),
                              params.light_position)
        bg = torch.pow(torch.tensor(params.background, dtype=torch.float32, device=dev),
                       params.gamma)
        colour = torch.where(found[..., None], shaded, bg)
        alpha = torch.ones((h, w), dtype=torch.float32, device=dev)

    elif params.mode == RenderMode.OCT_DEPTH:
        both = torch.cat([volume, depth_tex], dim=1)  # one sampling call per step
        rgb, a = torch.zeros((h, w, 3), dtype=torch.float32, device=dev), zeros
        d_old = torch.ones((h, w), dtype=torch.float32, device=dev)
        for i in range(n_steps):
            j = n_steps - 1 - i  # back-to-front (oct_depth.frag marches ray_stop->start)
            s, d = _sample(both, pos_at(j))
            d_delta = torch.abs(d - d_old)
            use = (s > thr) & (s < 0.9) & (d > 0.1) & (d_delta < 1.01 * params.step_length)
            c_rgb, _ = _transfer((d - 0.05).clamp(0.0, 1.0), params.alpha_exponent, lut)
            c_a = torch.pow(s.clamp(0.0, 1.0), params.alpha_exponent)
            new_rgb = c_a[..., None] * c_rgb + (1.0 - c_a)[..., None] * a[..., None] * rgb
            new_a = c_a + (1.0 - c_a) * a
            new_rgb = new_rgb / torch.clamp_min(new_a, 1e-6)[..., None]
            rgb = torch.where(use[..., None], new_rgb, rgb)
            a = torch.where(use, new_a, a)
            d_old = d
        colour, alpha = rgb, a

    else:
        raise ValueError(f"unknown render mode {params.mode}")

    # background blend + gamma correction (every shader's tail)
    bg = torch.pow(torch.tensor(params.background, dtype=torch.float32, device=dev),
                   params.gamma)
    if params.mode != RenderMode.ISOSURFACE:
        colour = alpha[..., None] * colour + (1.0 - alpha)[..., None] * bg
    return torch.pow(colour.clamp(0.0, 1.0), 1.0 / params.gamma)


def render_volume(
    volume,
    params: RenderParams = RenderParams(),
    yaw: float = 0.0,
    pitch: float = 0.0,
    out_shape: Tuple[int, int] = (512, 512),
    lut: Optional[np.ndarray] = None,
    device="cuda",
    stream=None,
) -> np.ndarray:
    """Render a processed volume (bscans, ascans, depth; float 0..1; a host
    array or a tensor) to an (H, W, 3) float32 RGB host image.  yaw/pitch in
    radians (trackball analog).

    ``device``: where the raycast runs; the volume is copied there.  On a
    CUDA device the work is enqueued on ``stream`` (default: one drawn from
    PyTorch's stream pool for this call), which first waits for the
    caller's current stream, and only that stream is synchronized before
    the image is returned.
    """
    device = torch.device(device)

    def go():
        vol = torch.as_tensor(volume, dtype=torch.float32, device=device).clamp(0.0, 1.0)
        vol = vol[None, None]
        rot = torch.as_tensor(_rotation(yaw, pitch), device=device)
        if params.mode == RenderMode.OCT_DEPTH:
            depth_tex = compute_sample_depths(vol, params.depth_threshold)
        else:
            depth_tex = None
        lut_t = None if lut is None else torch.as_tensor(
            np.asarray(lut, np.float32), device=device)
        return _render(vol, depth_tex, rot, lut_t, params, out_shape).cpu().numpy()

    if device.type != "cuda":
        return go()
    stream = stream if stream is not None else torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))  # a CUDA volume is ready
    with torch.cuda.stream(stream):
        return go()  # .cpu() synchronizes this stream alone
