"""Sharded-throughput scaling harness of the port (cards and hosts).

Counterpart of ``benchmarks/scaling.py``.  Measures the steady-state
per-buffer throughput of the sharded step (``parallel.make_sharded_step``)
over growing meshes and reports the scaling efficiency against linear,
each mesh's output against the single-device step on the same buffer.

Modes:

* default: a 1-D sweep over the local CUDA cards (1, 2, 4, ... of
  ``torch.cuda.device_count()``); on a one-card machine one 1x1 row.
* ``--virtual``: meshes over :data:`VIRTUAL_REPEATS` repeats of one device
  (cuda:0, or the CPU with ``--device cpu``).  Every row carries
  ``"shared_device": true``: the shards run one after another on the one
  device, so ``scaling_efficiency`` reads as the partition's overhead, not
  as scaling.
* ``--hosts N``: a (host, bscan, ascan) sweep in ONE process, the host
  axis and its FPN reduction without a cluster.
* ``--coordinator ADDR --num-processes N --process-id I``: one process of
  a real multi-process run (``parallel.multihost.initialize``: NCCL when
  every rank has cards of its own, gloo when ranks share a card or with
  ``--device cpu``); each process feeds its own B-scan block and reports
  the global buffer rate.  ``--local-devices`` is the devices per process
  (copies of the CPU device with ``--device cpu``).
* ``--traffic OUT_JSON``: the transfer tally of the sharded step
  (``parallel.traffic``) on three meshes of 8 repeats of the device, with
  an analytic 2-host efficiency model.  Its compute time is the
  single-device steady ms measured on the card in the same call, or
  ``--compute-ms`` (required with ``--device cpu``); its links are
  rates are arguments, by default NVIDIA's published H100 SXM NVLink 4 rate
  and one NDR InfiniBand port, labelled "published, not measured", with
  no latency floor.
* ``--gloo-anchor OUT_JSON``: the same 2-position workload in one process
  against two processes of one position each over gloo (both on cuda:0 on
  one card), in adjacent pairs; the median of the pairs' rate ratios is a
  measured floor of the protocol's overhead.

    python -m octproz_tpu_torch.scaling --virtual --samples 1024 --ascans 512 --bscans 256
    python -m octproz_tpu_torch.scaling --traffic traffic.json
    python -m octproz_tpu_torch.scaling --gloo-anchor anchor.json --pairs 3
    python -m octproz_tpu_torch.scaling --device cpu --virtual --samples 256 --ascans 32 --bscans 8

Prints one JSON line per mesh (or the report).  ``--device cuda`` (the
default) without a CUDA device exits with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .params import AcqParams, FpnMode, Interpolation, ProcConfig

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Link rates of the traffic report's model, GB/s: NVIDIA's published
#: figures, not measured (the H100 SXM data sheet's NVLink 4 rate, both
#: directions together; one NDR InfiniBand port, 400 Gb/s).
NVLINK_GBPS = 900.0
INFINIBAND_GBPS = 50.0
PUBLISHED = "published, not measured"
#: Positions of the ``--virtual`` meshes (the JAX harness's 8 virtual devices).
VIRTUAL_REPEATS = 8


def scaling_config() -> ProcConfig:
    """The JAX harness's chain (``benchmarks/scaling.py:366-369``): cubic
    k-linearization, window, dispersion, FPN once, log scaling, on the fold
    path (the kernels on the card, their plain versions on the CPU)."""
    return ProcConfig(bitshift=True, resampling=True, interpolation=Interpolation.CUBIC,
                      windowing=True, dispersion=True, fpn_mode=FpnMode.ONCE,
                      log_scaling=True, fft_via_matmul=True)


def curve_kwargs(acq: AcqParams) -> dict:
    """The JAX harness's curves (``benchmarks/scaling.py:75-77``)."""
    return dict(resample_coeffs=(0.0, float(acq.samples_per_line - 1), 10.0, -4.0),
                dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))


def _curves(acq: AcqParams, cfg: ProcConfig, device):
    from . import curves as curves_mod

    return curves_mod.make_curves(acq, cfg, **curve_kwargs(acq), device=device)


def _raw(shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 4095, size=shape).astype(np.uint16)


def _measure(step, raw, curves, state, acq: AcqParams, devices, n_iters: int, warmup: int,
             barrier=None):
    """Host-clock rate of ``n_iters`` steady steps between two syncs of
    every device, after ``warmup`` steps (at least one: the FPN
    determination) and ``barrier()`` when given (the processes of a
    multi-process run start their timed steps together).  Returns
    (A-scans per s, s per buffer, last output)."""
    from .bench import sync

    for _ in range(max(warmup, 1)):
        out, state = step(raw, curves, state)
    sync(devices)
    if barrier is not None:
        barrier()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out, state = step(raw, curves, state)
    sync(devices)
    dt = time.perf_counter() - t0
    return n_iters * acq.ascans_per_buffer / dt, dt / n_iters, out


def _gathered(out, device: torch.device) -> torch.Tensor:
    """A sharded output's blocks joined into the whole buffer on ``device``."""
    from .parallel.sharding import row_blocks

    return torch.cat([t.to(device) for _, t in row_blocks(out)])


def max_abs_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max |got - want| over the finite voxels, inf where the finite masks
    differ."""
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        return float("inf")
    return float((got[fin].float() - want[fin].float()).abs().max())


def run_scaling(mesh_builders, acq: AcqParams, cfg: ProcConfig, n_iters: int = 20,
                warmup: int = 2, shared_device: bool = False) -> List[Dict]:
    """mesh_builders: list of (label_dict, fn() -> Mesh).  One row per mesh:
    the JAX harness's keys, ``shared_device``, and ``max_abs_diff`` of the
    mesh's last steady output against the single-device step's on the same
    buffer (FPN determined on it, then once more), the reference computed
    once on the first mesh's first device."""
    from . import pipeline
    from .parallel import make_sharded_step
    from .parallel.sharding import shard_buffer

    raw_np = _raw(acq.buffer_shape)
    results, base, reference = [], None, None
    for label, build in mesh_builders:
        mesh = build()
        first = mesh.local_devices[0]
        curves = _curves(acq, cfg, first)
        if reference is None:
            step = pipeline.make_step(acq, cfg)
            raw = torch.from_numpy(raw_np).to(first)
            _, state = step(raw, curves, pipeline.initial_fpn_state(acq, device=first))
            reference, _ = step(raw, curves, state)
            del raw
        n_dev = mesh.size
        rate, per_buf, out = _measure(make_sharded_step(acq, cfg, mesh),
                                      shard_buffer(raw_np, mesh), curves,
                                      pipeline.initial_fpn_state(acq, device=first), acq,
                                      mesh.local_devices, n_iters, warmup)
        diff = max_abs_diff(_gathered(out, reference.device), reference)
        del out
        if base is None:
            base = (n_dev, rate)
        rec = dict(label, devices=n_dev, ascans_per_s=rate, ms_per_buffer=per_buf * 1e3,
                   scaling_efficiency=rate / (base[1] * n_dev / base[0]),
                   shared_device=shared_device, max_abs_diff=diff)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    return results


def run_distributed(args, acq: AcqParams, cfg: ProcConfig) -> Dict:
    """One process of a real multi-process run."""
    import torch.distributed as dist

    from . import pipeline
    from .parallel import make_sharded_step, multihost

    on_cpu = torch.device(args.device).type == "cpu"
    multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                         platform="cpu" if on_cpu else None,
                         local_device_count=args.local_devices or None)
    try:
        mesh = multihost.make_multihost_mesh(n_ascan_shards=args.ascan_shards)
        first = mesh.local_devices[0]
        lo, hi = multihost.local_bscan_range(acq, mesh)
        raw_local = _raw((hi - lo,) + tuple(acq.buffer_shape[1:]))
        rate, per_buf, _ = _measure(make_sharded_step(acq, cfg, mesh),
                                    multihost.feed_from_local(raw_local, acq, mesh),
                                    _curves(acq, cfg, first),
                                    pipeline.initial_fpn_state(acq, device=first), acq,
                                    mesh.local_devices, args.iters, 2, barrier=dist.barrier)
        rec = {"hosts": dist.get_world_size(), "process": dist.get_rank(),
               "devices": mesh.size, "ascans_per_s": rate, "ms_per_buffer": per_buf * 1e3,
               "via": dist.get_backend()}
    finally:
        dist.destroy_process_group()
    print(json.dumps(rec), flush=True)
    return rec


def default_links(nvlink_gbps: float = NVLINK_GBPS, infiniband_gbps: float = INFINIBAND_GBPS
                  ) -> Tuple[Tuple[str, float, float, str], ...]:
    """The traffic model's links, fastest first: (name, GB/s, latency floor
    in s, source of the rate).  No latency floor: none was measured."""
    return (("nvlink", nvlink_gbps, 0.0,
             PUBLISHED if nvlink_gbps == NVLINK_GBPS else "given"),
            ("infiniband", infiniband_gbps, 0.0,
             PUBLISHED if infiniband_gbps == INFINIBAND_GBPS else "given"))


def run_traffic_report(acq: AcqParams, cfg: ProcConfig, compute_s_per_buffer: float,
                       out_path: Optional[str], devices: Sequence[torch.device],
                       links=None, compute_source: str = "given") -> Dict:
    """The sharded step's transfers on three meshes of ``devices`` (eight
    positions; repeats of one device do), tallied by the step itself
    (``traffic.measure_collective_traffic``: one FPN-determination step on
    a zero buffer), and an analytic 2-host efficiency model: the steady
    state moves no bytes between devices, the determination buffer pays the
    host-spanning mesh's bytes over the slowest link plus its latency floor,
    folded in as equivalent bytes (``links``: :func:`default_links`)."""
    from .parallel import make_mesh, make_simulated_multihost_mesh, traffic

    devices = list(devices)
    links = default_links() if links is None else links
    report = {
        "workload": {"samples": acq.samples_per_line, "ascans": acq.ascans_per_bscan,
                     "bscans": acq.bscans_per_buffer,
                     "config": "full benchmark chain (cubic k-lin, window, dispersion, "
                               "FPN once, log)"},
        "compute_s_per_buffer": compute_s_per_buffer,
        "compute_source": compute_source,
        "devices": [str(d) for d in devices],
        "meshes": {},
    }
    meshes = {
        "bscan8": lambda: make_mesh(8, 1, devices=devices),
        "host2x4": lambda: make_simulated_multihost_mesh(2, 4, 1, devices=devices),
        "bscan4_ascan2": lambda: make_mesh(4, 2, devices=devices),
    }
    for name, build in meshes.items():
        r = traffic.measure_collective_traffic(acq, cfg, build())
        report["meshes"][name] = {"by_op": r["by_op"], "total_bytes": r["total_bytes"]}
    det_bytes = report["meshes"]["host2x4"]["total_bytes"]
    report["expected_fpn_psum_bytes"] = traffic.expected_fpn_psum_bytes(acq)

    models = {}
    for link_name, gbps, lat_s, source in links:
        eff_bytes = det_bytes + gbps * 1e9 * lat_s
        models[link_name] = {
            "link_gbps": gbps, "latency_floor_s": lat_s, "source": source,
            "fpn_once": traffic.efficiency_model(
                acq, cfg, compute_s_per_buffer=compute_s_per_buffer, link_gbps=gbps,
                det_bytes=int(eff_bytes), fpn_once=True),
            "fpn_continuous": traffic.efficiency_model(
                acq, cfg, compute_s_per_buffer=compute_s_per_buffer, link_gbps=gbps,
                det_bytes=int(eff_bytes), fpn_once=False),
        }
    report["efficiency_model"] = models
    slowest = min(models, key=lambda k: models[k]["link_gbps"])
    report["predicted_efficiency"] = {
        "note": "MODEL-PREDICTED from the tallied transfer bytes and an analytic link "
                "model, not a wall-clock measurement across cards; the measured "
                "companion is the 2-process gloo anchor (--gloo-anchor)",
        f"fpn_once_{slowest}": models[slowest]["fpn_once"]["predicted_efficiency"],
        f"fpn_continuous_{slowest}": models[slowest]["fpn_continuous"]["predicted_efficiency"],
    }
    report["claim"] = (
        "steady-state cross-device bytes = 0 (tallied by the sharded step); 2-host "
        "efficiency is bounded by the once-per-stream FPN reduction, predicted by the "
        "analytic link model")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


def launch_ranks(runs: Sequence[Tuple[Sequence[str], int, int]], timeout: float,
                 what: str) -> List[str]:
    """Start ``python -m <argv>`` for each (argv, rank, world) of ``runs``,
    all together, from the repo root: fresh processes (CUDA and fork do not
    mix) with ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` set, stderr to temporary
    files -- draining coordinated workers one after another over pipes can
    deadlock (worker 1 blocks on a full stderr pipe before reaching the
    barrier worker 0 waits at) -- and one deadline of ``timeout`` s, after
    which every process is killed.  Returns each process's stdout, in
    order; raises ``RuntimeError`` on a stall or a nonzero exit, with the
    stderr's tail."""
    env = dict(os.environ, PYTHONPATH=_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, errs = [], []
    try:
        for argv, rank, world in runs:
            errs.append(tempfile.TemporaryFile(mode="w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", *argv], cwd=_ROOT, stdout=subprocess.PIPE,
                stderr=errs[-1], text=True,
                env=dict(env, LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))))
        deadline = time.monotonic() + timeout
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                for p in procs]
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{what}: a process did not finish within {timeout:.0f} s "
                           f"(coordination stall)") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        tails = []
        for ef in errs:
            ef.seek(0)
            tails.append(ef.read()[-4000:])
            ef.close()
    for (argv, rank, world), p, tail in zip(runs, procs, tails):
        if p.returncode != 0:
            raise RuntimeError(f"{what}: rank {rank} of {world} failed (exit "
                               f"{p.returncode}):\n{tail}")
    return outs


def _launch(acq: AcqParams, num_processes: int, devices_per_proc: int, iters: int,
            timeout: float, device: str) -> List[Dict]:
    """One coordinated measurement: ``num_processes`` processes of this
    module (:func:`launch_ranks`) meeting at a file rendezvous.  Returns
    every rank's record, in rank order."""
    geo = ["--samples", str(acq.samples_per_line), "--ascans", str(acq.ascans_per_bscan),
           "--bscans", str(acq.bscans_per_buffer), "--iters", str(iters), "--device", device]
    with tempfile.TemporaryDirectory() as tmp:
        outs = launch_ranks(
            [(["octproz_tpu_torch.scaling", "--coordinator", f"file://{tmp}/rendezvous",
               "--num-processes", str(num_processes), "--process-id", str(i),
               "--local-devices", str(devices_per_proc)] + geo, i, num_processes)
             for i in range(num_processes)], timeout, "gloo anchor")
    return [json.loads(out.strip().splitlines()[-1]) for out in outs]


def run_gloo_anchor(acq: AcqParams, cfg: ProcConfig, out_path: Optional[str], *,
                    iters: int, pairs: int, timeout: float, device: str) -> Dict:
    """The measured 2-process protocol anchor: the same 2-position global
    workload through the same distributed machinery (:func:`run_distributed`
    on ``torch.distributed``), (a) one process owning both positions,
    (b) two processes with one each over gloo (on one card both share
    cuda:0; NCCL refuses two ranks on one GPU).  (b)'s rate is its slowest
    rank's -- a buffer is done once every rank has done its block -- with
    the ranks' timed steps started at a barrier; on one card the two
    processes' contexts take turns on it, which (b) measures too.
    ``pairs`` adjacent pairs of ``iters`` timed steps, each run within
    ``timeout`` s; the median of the pairs' ratios b/a: load noise moves
    both runs of a pair together.  A floor of the protocol's overhead, not
    a prediction."""
    runs = []
    for _ in range(max(1, pairs)):
        # 1 process x 2 positions: no process boundary
        (one,) = _launch(acq, 1, 2, iters, timeout, device)
        # 2 processes x 1 position: gloo on the path
        ranks = _launch(acq, 2, 1, iters, timeout, device)
        two = min(ranks, key=lambda r: r["ascans_per_s"])  # the slowest rank ends a buffer
        runs.append({"one_process_2dev": one, "two_process_gloo": two,
                     "two_process_ranks": ranks,
                     "ratio": two["ascans_per_s"] / one["ascans_per_s"]})
    ratios = sorted(p["ratio"] for p in runs)
    report = {
        "workload": {"samples": acq.samples_per_line, "ascans": acq.ascans_per_bscan,
                     "bscans": acq.bscans_per_buffer, "iters": iters, "device": device},
        "pairs": runs,
        "measured_protocol_ratio": ratios[len(ratios) // 2],
        "note": "measured wall-clock ratio of the identical 2-position global workload "
                "with vs without an OS-process boundary (torch.distributed over gloo, "
                "a file rendezvous); a measured floor of the protocol overhead the "
                "predicted_efficiency model abstracts",
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--virtual", action="store_true",
                   help=f"meshes over {VIRTUAL_REPEATS} repeats of one device (cuda:0, or "
                        f"the CPU)")
    p.add_argument("--traffic", metavar="OUT_JSON", default=None,
                   help="emit the transfer-traffic report instead of a timing sweep")
    p.add_argument("--gloo-anchor", metavar="OUT_JSON", default=None,
                   help="measured 2-process gloo wall-clock anchor")
    p.add_argument("--pairs", type=int, default=3,
                   help="adjacent measurement pairs for --gloo-anchor (median ratio)")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds allowed to each --gloo-anchor measurement")
    p.add_argument("--compute-ms", type=float, default=None,
                   help="single-device ms per buffer for the traffic model (default: "
                        "measured on the card in this call; required with --device cpu)")
    p.add_argument("--nvlink-gbps", type=float, default=NVLINK_GBPS)
    p.add_argument("--infiniband-gbps", type=float, default=INFINIBAND_GBPS)
    p.add_argument("--hosts", type=int, default=0,
                   help="simulated multi-host sweep with this many hosts")
    p.add_argument("--coordinator", help="HOST:PORT or file:///path of a real "
                                         "multi-process run (torch.distributed)")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--local-devices", type=int, default=0,
                   help="devices per process in a multi-process run")
    p.add_argument("--ascan-shards", type=int, default=1)
    p.add_argument("--samples", type=int, default=1024)
    p.add_argument("--ascans", type=int, default=128)
    p.add_argument("--bscans", type=int, default=64)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("scaling: no CUDA device (pass --device cpu for the plain "
                             "versions)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    acq = AcqParams(samples_per_line=args.samples, ascans_per_bscan=args.ascans,
                    bscans_per_buffer=args.bscans, bit_depth=12)
    cfg = scaling_config()

    if args.traffic:
        if args.compute_ms is not None:
            compute_ms, source = args.compute_ms, "given (--compute-ms)"
        elif device.type == "cuda":
            from .bench import device_info, steady_ms_per_buffer

            info = device_info()
            compute_ms = steady_ms_per_buffer(cfg, device, acq=acq)
            source = (f"measured in this call: single-device steady ms per buffer on "
                      f"{info['device_name']}, power limit {info['power_limit']}")
        else:
            raise SystemExit("scaling --traffic --device cpu needs --compute-ms "
                             "(a CPU time is not the card's)")
        run_traffic_report(acq, cfg, compute_ms / 1e3, args.traffic, [device] * 8,
                           default_links(args.nvlink_gbps, args.infiniband_gbps), source)
        return 0
    if args.gloo_anchor:
        run_gloo_anchor(acq, cfg, args.gloo_anchor, iters=args.iters, pairs=args.pairs,
                        timeout=args.timeout, device=args.device)
        return 0
    if args.coordinator:
        run_distributed(args, acq, cfg)
        return 0

    from .parallel import make_mesh, make_simulated_multihost_mesh

    if args.virtual:
        devices = [device] * VIRTUAL_REPEATS
    elif device.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    n_avail = len(devices)
    if args.hosts:
        per_host = n_avail // args.hosts
        builders = [({"hosts": 1}, lambda: make_mesh(per_host, 1, devices=devices[:per_host]))]
        builders += [({"hosts": h},
                      lambda h=h: make_simulated_multihost_mesh(h, per_host, 1, devices=devices))
                     for h in (2, 4, 8) if h <= args.hosts]
    else:
        builders = [({"mesh": f"{n}x1"}, lambda n=n: make_mesh(n, 1, devices=devices[:n]))
                    for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]
    run_scaling(builders, acq, cfg, n_iters=args.iters, shared_device=args.virtual)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
