"""Portable low-cost OCT acquisition system (PhytoOCT-class device).

Counterpart of ``octproz_tpu/io/phytooct.py``: the device model is the same
numpy code (its frames and curves are bit-identical to the JAX package's),
the producer thread fills the port's native ring.

Capability-equivalent of the PhytoOCT acquisition plugin in the reference's
plugin ecosystem (docs/docs/plugins.md:17: "A portable and
low-cost OCT system"; .gitmodules lists it as an external acquisition-system
submodule).  The real plugin drives a spectrometer line camera and an
open-loop resonant scanner over USB/serial; that hardware I/O is out of
scope here exactly as for the Camera extension — what this module provides
is the complete *system integration* a hardware port would reuse:

* :class:`PortableOctSystem` — an ``AcquisitionSource`` whose producer
  thread fills the native DMA-stable ring (`io/hwbridge.py`) the way the
  real device's frame-grabber callback would, paced by the configured
  line-camera exposure.
* :class:`PhytoDeviceModel` — a physics model of the device class standing
  in for the hardware (the same role VirtualOCTSystem plays for file
  replay): Gaussian-source spectral envelope on a warped-pixel spectrometer
  (k-nonlinearity), mirror + sample reflectors, resonant-scanner sinusoidal
  lateral distortion, bidirectional frames, camera fixed-pattern columns
  and shot noise, 12-bit ADC left-aligned in 16-bit words.
* Device *calibration outputs*: the exact per-pixel k-linearization curve
  (served through the custom-resampling-curve path, the analog of
  ``Plugin::setCustomResamplingCurveRequest``, plugin.h:86) plus fitted
  GUI-style cubic coefficients, and the matching
  :func:`recommended_config` whose stages (bitshift, k-lin, FPN,
  bidirectional flip, sinusoidal correction) are exactly what this device
  class needs.

The model is deliberately adversarial to the pipeline: every artifact it
injects is one a specific processing stage removes, so end-to-end tests can
assert each stage earns its keep on this "hardware".
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterator, Optional

import numpy as np

from ..params import AcqParams, FpnMode, Interpolation, ProcConfig
from .hwbridge import HardwareRingSource

#: How long the producer waits for a slot before it gives the consumer up
#: (seconds): several times the first-use kernel build.
STALL_PATIENCE_S = 120.0


@dataclasses.dataclass(frozen=True)
class PhytoDeviceConfig:
    """Device knobs a PhytoOCT-class portable scanner exposes.

    These are the fields a settings dialog / INI group round-trips (the
    reference plugin's QDialog, acquisitionsystem.h:67).
    """

    samples_per_line: int = 1024       # line-camera pixels
    ascans_per_bscan: int = 256
    bscans_per_buffer: int = 8
    buffers_per_volume: int = 4
    exposure_us: float = 20.0          # line period -> paces the producer
    k_warp: float = 0.12               # quadratic spectrometer nonlinearity
    dispersion_d2: float = 6.0         # unbalanced fiber (GUI-scale d2)
    scan_amplitude: float = 0.85       # fraction of B-scan width swept
    bidirectional: bool = True         # every 2nd frame scanned backwards
    surface_depth: float = 0.22        # sample surface (fraction of depth)
    surface_tilt: float = 0.10         # depth change across the B-scan
    n_layers: int = 3                  # reflector layers below the surface
    fpn_strength: float = 0.004        # column fixed-pattern (of full scale)
    shot_noise: float = 0.002          # rms noise (of full scale)
    seed: int = 7

    @property
    def acq(self) -> AcqParams:
        return AcqParams(samples_per_line=self.samples_per_line,
                         ascans_per_bscan=self.ascans_per_bscan,
                         bscans_per_buffer=self.bscans_per_buffer,
                         buffers_per_volume=self.buffers_per_volume,
                         bit_depth=12)


class PhytoDeviceModel:
    """Simulated interferograms for the device class (see module docstring).

    Spectrometer model: camera pixel ``u = i/(N-1)`` samples normalized
    wavenumber ``v = u + k_warp * (u**2 - u)`` — a quadratic pixel->k warp
    (zero at both ends) like a real grating+camera misalignment.  A
    reflector at depth ``z`` (in units of the axial FOV) contributes a
    fringe ``cos(2*pi * z * n_depth * v + phi_disp(v))`` under a Gaussian
    source envelope; without k-linearization the chirped fringe blurs the
    peak, with the exact inverse curve it is transform-limited again.
    """

    def __init__(self, cfg: PhytoDeviceConfig):
        self.cfg = cfg
        n = cfg.samples_per_line
        u = np.linspace(0.0, 1.0, n, dtype=np.float64)
        self.v = u + cfg.k_warp * (u * u - u)          # pixel -> k (warped)
        self.envelope = np.exp(-0.5 * ((u - 0.5) / 0.22) ** 2)
        # dispersion phase as a function of WAVENUMBER (it is a property of
        # the light path, not of the camera pixel): phi = d2 * t^2 with
        # t = normalized k.  After k-linearization t becomes j/N, so the
        # GUI-normalized compensation polynomial (octalgorithmparameters.cpp:
        # 211-220, phi(j) = d2*(j/N)^2) cancels it with coeffs (0,0,-d2,0).
        t = (self.v - self.v[0]) / (self.v[-1] - self.v[0])
        self.phi_disp = cfg.dispersion_d2 * t * t
        self.fpn = (cfg.fpn_strength *
                    np.random.default_rng(cfg.seed).standard_normal(n))

    # -- calibration ground truth ------------------------------------------
    def klin_curve(self) -> np.ndarray:
        """Exact k-linearization resampling curve: fractional pixel index
        whose warped wavenumber is uniform in j — what the device's factory
        calibration ships, consumed via the custom-curve path."""
        n = self.cfg.samples_per_line
        v_target = np.linspace(self.v[0], self.v[-1], n)
        # self.v is strictly monotonic for |k_warp| < 1
        idx = np.interp(v_target, self.v, np.arange(n, dtype=np.float64))
        return np.clip(idx, 0.0, n - 3).astype(np.float32)

    def klin_coeffs(self) -> tuple:
        """GUI-style cubic (c0..c3) fit of :meth:`klin_curve` (what a user
        without the factory file would dial in on the sidebar)."""
        n = self.cfg.samples_per_line
        j = np.arange(n, dtype=np.float64)
        fit = np.polynomial.polynomial.polyfit(j / n, self.klin_curve(), 3)
        return tuple(float(c) for c in fit)

    def scan_positions(self, reverse: bool = False) -> np.ndarray:
        """Lateral sample position of each A-scan under the resonant
        scanner: position follows (1 - cos) of the drive phase, the exact
        distortion the acos sinusoidal-scan correction inverts
        (cuda_code.cu:516-521)."""
        a = self.cfg.ascans_per_bscan
        phase = np.linspace(0.0, np.pi, a)
        pos = 0.5 * (1.0 - np.cos(phase))              # 0..1, sinusoidal
        pos = 0.5 + self.cfg.scan_amplitude * (pos - 0.5)
        return pos[::-1].copy() if reverse else pos

    def _ascan_spectrum(self, lateral: np.ndarray,
                        noise_key: int = 0) -> np.ndarray:
        """Interferogram spectra for A-scans at the given lateral
        positions: (len(lateral), samples) float in [0, 1).  Noise is
        keyed by the frame index so any buffer can be regenerated
        deterministically (replay property of a virtual device)."""
        cfg = self.cfg
        n = cfg.samples_per_line
        depth_scale = n / 2                            # output A-scan bins
        surface = (cfg.surface_depth +
                   cfg.surface_tilt * (lateral - 0.5))  # tilted surface
        zs = [surface]
        refl = [1.0]
        for layer in range(1, cfg.n_layers + 1):
            zs.append(surface + 0.12 * layer)
            refl.append(0.5 ** layer)
        fringes = np.zeros((lateral.size, n))
        karg = 2.0 * np.pi * self.v * depth_scale      # (n,)
        for z, r in zip(zs, refl):
            fringes += r * np.cos(np.outer(z, karg) + self.phi_disp)
        dc = 0.5
        sig = dc + 0.18 * self.envelope * fringes
        sig += self.fpn                                 # camera column FPN
        rng = np.random.default_rng((cfg.seed, 1, noise_key))
        sig += cfg.shot_noise * rng.standard_normal(sig.shape)
        return np.clip(sig, 0.0, 1.0 - 2.0 ** -13)

    def frame(self, bscan_index: int) -> np.ndarray:
        """One B-scan (ascans, samples) uint16: 12-bit ADC codes left-shifted
        by 4 (12-in-16-bit digitizer format, docs/docs/processing.md:18) —
        decode with ``ProcConfig(bitshift=True)``."""
        # Even WITHIN-BUFFER frames scan backwards: ops.postprocess.
        # bscan_flip reverses even within-buffer indices, restoring them —
        # global parity would desync for odd bscans_per_buffer.
        within = bscan_index % self.cfg.bscans_per_buffer
        reverse = self.cfg.bidirectional and (within % 2 == 0)
        spec = self._ascan_spectrum(self.scan_positions(reverse),
                                    noise_key=bscan_index)
        codes = (spec * 4096.0).astype(np.uint16)
        return codes << 4

    def buffer(self, buffer_index: int) -> np.ndarray:
        """One raw buffer (bscans, ascans, samples) uint16."""
        b = self.cfg.bscans_per_buffer
        first = buffer_index * b
        return np.stack([self.frame(first + i) for i in range(b)])


class PortableOctSystem:
    """The acquisition system: producer thread -> native ring -> consumer.

    Structured like a real device port: ``start()`` spawns the acquisition
    thread (the reference moves the plugin to its own QThread,
    octprozapp.cpp:337-349) which writes each exposure-paced frame into the
    DMA-stable ring exactly as a frame-grabber callback would; the
    StreamingEngine consumes ``buffers()``.  Replacing
    :class:`PhytoDeviceModel` with real camera reads is the entire port.
    """

    def __init__(self, device: PhytoDeviceConfig | None = None,
                 n_volumes: int = 1, n_slots: int = 4):
        self.device_cfg = device or PhytoDeviceConfig()
        self.model = PhytoDeviceModel(self.device_cfg)
        self.acq = self.device_cfg.acq
        self.n_buffers = self.acq.buffers_per_volume * n_volumes
        self._ring = HardwareRingSource(self.acq, n_slots=n_slots)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle (startAcquisition/stopAcquisition analog) ----------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._produce,
                                        name="phytooct-acq", daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        line_period = self.device_cfg.exposure_us * 1e-6
        lines_per_buffer = (self.acq.ascans_per_bscan *
                            self.acq.bscans_per_buffer)
        next_due = time.monotonic()
        try:
            for i in range(self.n_buffers):
                if self._stop.is_set():
                    break
                frame = self.model.buffer(i)
                next_due += line_period * lines_per_buffer
                delay = next_due - time.monotonic()
                if delay > 0:       # camera line rate paces the producer
                    time.sleep(delay)
                # The consumer's first buffer can stall the ring while the
                # CUDA kernels build at first use (16-24 s of nvcc on an H100
                # host); a stall is NOT "consumer gone", so retry in short
                # slices (checking for close()) with patience beyond that
                # build.
                deadline = time.monotonic() + STALL_PATIENCE_S
                while not self._stop.is_set():
                    try:
                        self._ring.write_blocking(frame, timeout_s=5.0)
                        break
                    except TimeoutError:
                        if time.monotonic() > deadline:
                            return  # genuinely stuck consumer
        finally:
            # ALWAYS end the stream, even if frame generation raised: the
            # consumer must see end-of-stream, not a 10 s idle timeout
            self._ring.finish()

    def buffers(self) -> Iterator[np.ndarray]:
        self.start()
        return self._ring.buffers()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self._ring.close()

    # -- calibration surface ------------------------------------------------
    def recommended_config(self, tpu: bool = True) -> ProcConfig:
        """The processing chain this device class needs: every enabled stage
        cancels one injected artifact (bitshift <- left-aligned ADC, k-lin
        <- spectrometer warp, dispersion <- fiber mismatch, FPN <- camera
        columns, flip <- bidirectional scan, sinusoidal <- resonant
        scanner).

        ``tpu=True`` (default; the JAX package's name, as in
        ``models.presets``) selects the folded-GEMM path, the fold kernels
        B1/B2 on the card; ``tpu=False`` the FFT path.
        """
        return ProcConfig(
            bitshift=True,
            resampling=True, interpolation=Interpolation.CUBIC,
            windowing=True, dispersion=True,
            fpn_mode=FpnMode.ONCE, log_scaling=True,
            bscan_flip=self.device_cfg.bidirectional,
            sinusoidal_correction=True,
            fft_via_matmul=tpu,
        )

    def curve_kwargs(self) -> dict:
        """make_curves(...) kwargs carrying the factory calibration: the
        exact custom resampling curve and the dispersion coefficients that
        cancel the device's phase (negated d2, direction=1 phasor)."""
        return dict(
            custom_resample_curve=self.model.klin_curve(),
            dispersion_coeffs=(0.0, 0.0, -self.device_cfg.dispersion_d2, 0.0),
        )


def _get(settings: dict, key: str, cast, default):
    raw = settings.get(key, default)
    if cast is bool and isinstance(raw, str):
        # same truthy vocabulary as every other settings group
        from ..utils.configmap import _parse_bool

        return _parse_bool(raw)
    return cast(raw)


def make_system(settings: dict) -> PortableOctSystem:
    """SystemRegistry factory: build the system from an INI settings group
    (string values allowed, like QVariant round-trips)."""
    fields = {f.name: f for f in dataclasses.fields(PhytoDeviceConfig)}
    kwargs = {}
    for name, field in fields.items():
        if name in settings:
            kwargs[name] = _get(settings, name, type(field.default),
                                field.default)
    dev = PhytoDeviceConfig(**kwargs)
    return PortableOctSystem(dev,
                             n_volumes=_get(settings, "n_volumes", int, 1))


def register(registry) -> None:
    """Register the system under its ecosystem name."""
    registry.register("phytooct", make_system)
