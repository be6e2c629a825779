"""Engine against upload-only windows: the soak.

Counterpart of ``scripts/e2e_soak.py`` without its tunnel parts (no
tunnel waits, no fresh process per cycle).  Each cycle measures, in one
process and back to back, windows of the same length:

    upload-only window (the engine's own feeder, runtime.engine_feeder,
                        no compute: every buffer staged, uploaded and,
                        on the packed-12 wire, unpacked, its upload
                        events synchronized)
    engine window      (StreamingEngine: pipelined upload, chunked
                        dispatch; buffers processed over wall time)
    upload-only window

and reports ratio = engine / mean(upload-only) per cycle, then the median
and p10 over the cycles.  Both window kinds build the feeder alike (queue
depth, pinned slots), and its pinned slots come from PyTorch's
pinned-memory cache, filled by the warm-up: no window pays for them.  A ratio
near 1 says the engine runs at the pace of its own upload path (the host
staging copy and the H2D); well below 1, the step or the dispatch holds
it back.

The default chain is the JAX soak's: the fold path at
``compute_dtype="bfloat16"`` with a bf16 store, FPN once from one B-scan,
chunks of 8, the packed-12 wire, on full 1024 x 512 x 256 buffers of
12-bit samples (``--small``: 256 x 32 x 8, the CPU tests' geometry).

    python -m octproz_tpu_torch.soak --cycles 4 --window-s 10
    python -m octproz_tpu_torch.soak --small --device cpu --cycles 1 --window-s 3 --chunk 4
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from .params import AcqParams, FpnMode, Interpolation, ProcConfig, WindowType

#: The JAX soak's CPU geometry (``--small``); the full one is the
#: benchmark's, ``bench.FULL_ACQ``.
SMALL_ACQ = AcqParams(samples_per_line=256, ascans_per_bscan=32, bscans_per_buffer=8,
                      buffers_per_volume=1, bit_depth=12)


def soak_config() -> ProcConfig:
    """The JAX soak's chain (``scripts/e2e_soak.py:65-70``)."""
    return ProcConfig(bitshift=True, resampling=True, interpolation=Interpolation.CUBIC,
                      windowing=True, dispersion=True, fpn_mode=FpnMode.ONCE,
                      bscans_for_noise=1, log_scaling=True, fft_via_matmul=True,
                      compute_dtype="bfloat16", output_dtype="bfloat16")


def curve_kwargs(acq: AcqParams) -> dict:
    return dict(resample_coeffs=(0.0, float(acq.samples_per_line - 1), 20.0, -10.0),
                dispersion_coeffs=(0.0, 0.0, 10.0, 0.0), window_type=WindowType.HANNING)


def soak_model(acq: Optional[AcqParams] = None, device="cuda",
               cfg: Optional[ProcConfig] = None):
    """The soak chain's model on ``acq`` (default ``bench.FULL_ACQ``)."""
    from .bench import FULL_ACQ
    from .models.fdoct import FdOctModel

    acq = acq or FULL_ACQ
    return FdOctModel(acq, cfg or soak_config(), **curve_kwargs(acq), device=device)


def host_ring(acq: AcqParams, wire: str, count: int = 3, seed: int = 0) -> List[np.ndarray]:
    """``count`` random host buffers of ``acq.bit_depth``-bit samples (in
    uint16, or uint32 above 16 bits; the JAX soak's draws at 12 bits),
    packed on the packed-12 wire."""
    rng = np.random.default_rng(seed)
    container = np.uint32 if acq.bit_depth > 16 else np.uint16
    ring = [rng.integers(0, 1 << acq.bit_depth, size=acq.buffer_shape).astype(container)
            for _ in range(count)]
    if wire == "packed12":
        from . import native

        ring = [native.pack_uint12(b.reshape(-1)) for b in ring]
    return ring


class HostRing:
    """An endless source cycling over host buffers already in memory."""

    def __init__(self, acq: AcqParams, ring: List[np.ndarray]):
        self.acq = acq
        self._ring = ring

    def buffers(self):
        i = 0
        while True:
            yield self._ring[i % len(self._ring)]
            i += 1


#: The host prefetch depth of both window kinds (``StreamingEngine``'s
#: ``prefetch_depth``).
PREFETCH_DEPTH = 2

#: The engine's and the feeder's worker threads (``runtime``).
ENGINE_THREADS = ("octproz-acquisition", "octproz-upload")


def join_engine_threads(timeout_s: float = 60.0) -> None:
    """Join every live engine worker thread, or fail: a window ends only
    once its threads did, so none runs into the next window."""
    for t in [t for t in threading.enumerate() if t.name in ENGINE_THREADS]:
        t.join(timeout=timeout_s)
        if t.is_alive():
            raise RuntimeError(f"thread {t.name} did not end")


def upload_window(model, ring, wire: str, chunk: int, budget_s: float):
    """Upload-only rate (MHz) and buffers through the feeder the engine
    builds for ``chunk`` (``runtime.engine_feeder``).  On the card the
    feeder hands each buffer over with the events of its upload, before the
    copy has ended; each is synchronized here, so a buffer counts once it
    is on the device (unpacked on packed-12)."""
    from .runtime import _Prefetcher, engine_feeder

    pre = _Prefetcher(HostRing(model.acq, ring), PREFETCH_DEPTH)
    feeder = engine_feeder(pre, model, PREFETCH_DEPTH, chunk, wire)
    pre.start()
    feeder.start()
    n = 0
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < budget_s:
            item = feeder.get()
            if item is None:
                break
            for _device, event in item[2] or ():
                event.synchronize()
            n += 1
    finally:
        elapsed = time.perf_counter() - t0
        feeder.stop()
        pre.stop()
        join_engine_threads()
    return n * model.acq.ascans_per_buffer / elapsed / 1e6, n


def warm_up(model, ring, wire: str, chunk: int) -> None:
    """Outside every timed window: buffer 0 (the FPN determination), then a
    chunk, so the engine window runs steady buffers only; on the card the
    feeder's pinned slots, allocated and released into PyTorch's
    pinned-memory cache, where every window's feeder takes them from."""
    from .bench import sync
    from .runtime import engine_feeder_slots

    put = model.put_packed_buffer if wire == "packed12" else model.put_buffer
    model.process_buffer(put(ring[0]))
    if chunk > 1:
        model.process_chunk(torch.stack([put(ring[0])] * chunk))
    if model.device.type == "cuda":
        _, slots = engine_feeder_slots(PREFETCH_DEPTH, chunk)
        pinned = [torch.from_numpy(ring[0]).pin_memory() for _ in range(slots)]
        del pinned  # all alive at once, then cached
    sync(model.devices)


def engine_window(model, ring, wire: str, chunk: int, window_s: float) -> dict:
    """The engine's rate over a window stopped by a watchdog: buffers
    processed over the run's wall time, and the meter's windows."""
    from .bench import sync
    from .runtime import StreamingEngine

    windows = []
    eng = StreamingEngine(model, HostRing(model.acq, ring), upload_prefetch=True,
                          prefetch_depth=PREFETCH_DEPTH, dispatch_chunk=chunk,
                          chunk_strategy="auto", metrics_window_s=5.0, wire_format=wire,
                          on_metrics=lambda s: windows.append(s.ascans_per_s / 1e6))
    sync(model.devices)
    watchdog = threading.Timer(window_s, eng.stop)
    watchdog.daemon = True
    t0 = time.perf_counter()
    watchdog.start()
    done = eng.run()
    watchdog.cancel()
    elapsed = time.perf_counter() - t0
    join_engine_threads()
    return {"mhz": done * model.acq.ascans_per_buffer / elapsed / 1e6, "buffers": done,
            "seconds": elapsed, "meter_windows_mhz": windows}


def cycle_record(wire: str, chunk: int, window_s: float, before, eng: dict, after) -> dict:
    """A cycle's record from its windows: ``before`` and ``after`` the
    upload-only windows' (MHz, buffers), ``eng`` the engine window's."""
    ups = [u for u, _ in (before, after) if u > 0]
    base = sum(ups) / len(ups) if ups else 0.0
    return {
        "t": time.time(),
        "wire": wire,
        "chunk": chunk,
        "window_s": window_s,
        "upload_before_mhz": before[0],
        "upload_after_mhz": after[0],
        "upload_buffers": before[1] + after[1],
        "engine_mhz": eng["mhz"],
        "engine_buffers": eng["buffers"],
        "engine_seconds": eng["seconds"],
        "engine_meter_windows_mhz": eng["meter_windows_mhz"],
        "ratio": eng["mhz"] / base if base else None,
    }


def run_cycle(window_s: float, chunk: int, wire: str, model=None,
              ring: Optional[List[np.ndarray]] = None, device="cuda") -> dict:
    """One cycle -- upload-only, engine, upload-only -- on ``model`` (the
    soak chain at full geometry by default) over ``ring`` (:func:`host_ring`
    of the model's geometry by default).  Returns the record."""
    if model is None:
        model = soak_model(device=device)
    if ring is None:
        ring = host_ring(model.acq, wire)
    warm_up(model, ring, wire, chunk)
    before = upload_window(model, ring, wire, chunk, window_s)
    eng = engine_window(model, ring, wire, chunk, window_s)
    after = upload_window(model, ring, wire, chunk, window_s)
    return cycle_record(wire, chunk, window_s, before, eng, after)


def pct(ratios: List[float], p: float):
    """The element of sorted ``ratios`` at percentile ``p`` (the JAX
    soak's pick: index int(p/100 * n), capped at the last)."""
    if not ratios:
        return None
    return ratios[min(int(p / 100 * len(ratios)), len(ratios) - 1)]


def summarize(cycles: List[dict], wire: str, chunk: int, window_s: float) -> dict:
    """The JAX soak's report over ``cycles`` (every cycle ran: a failure
    raises instead of being counted)."""
    ratios = sorted(c["ratio"] for c in cycles if c.get("ratio") is not None)
    return {
        "protocol": "per-cycle engine/upload-only ratio with symmetric adjacent windows "
                    "(upload, engine, upload) in one process; see octproz_tpu_torch/soak.py",
        "wire": wire, "chunk": chunk, "window_s": window_s,
        "cycles": len(cycles), "failed_cycles": 0,
        "ratio_median": pct(ratios, 50), "ratio_p10": pct(ratios, 10),
        "ratio_min": ratios[0] if ratios else None,
        "ratio_max": ratios[-1] if ratios else None,
        "upload_mhz_range": [
            min(min(c["upload_before_mhz"], c["upload_after_mhz"]) for c in cycles),
            max(max(c["upload_before_mhz"], c["upload_after_mhz"]) for c in cycles)]
        if cycles else None,
        "records": cycles,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cycles", type=int, default=4)
    p.add_argument("--window-s", type=float, default=10.0)
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--wire", default="packed12", choices=["uint16", "packed12"])
    p.add_argument("--small", action="store_true",
                   help="256 x 32 x 8 buffers (the CPU tests' geometry)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda:0)")
    p.add_argument("--out", default=None, help="write the report here as JSON")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("soak: no CUDA device (pass --device cpu for the plain versions)")
    model = soak_model(SMALL_ACQ if args.small else None, args.device)
    ring = host_ring(model.acq, args.wire)
    cycles = []
    for _ in range(args.cycles):
        cycles.append(run_cycle(args.window_s, args.chunk, args.wire, model=model, ring=ring))
        print(json.dumps(cycles[-1]), flush=True)
    report = summarize(cycles, args.wire, args.chunk, args.window_s)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "records"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
