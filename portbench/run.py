"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One process is one run: it loads the port;
the kind of load the cell's traffic file names (``kinds/<kind>.py``) makes
the cell's raw buffers from the seed, builds the system and warms up the
cell's own shapes; the run measures the window, holds the outputs to the
plain reference, and prints one JSON line.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
profile of the same window.
Without a CUDA card it fails; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here, before torch loads

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import cells  # noqa: E402

#: Compile caches of the program and its libraries, at fixed paths inside
#: the checkout, so that only a checkout's first run builds.
CACHE = cells.REPO / ".portbench_cache"
CACHE_VARS = {"TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor",
              "TORCH_EXTENSIONS_DIR": "torch_extensions", "CUDA_CACHE_PATH": "nv"}
#: Device operations keep this much of their name in the breakdown (a
#: kernel's template arguments run to a thousand characters).
NAME_CHARS = 160
#: Top-level module names that no run may load: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "octproz_tpu")


def forbidden_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def use_checkout_caches() -> None:
    """Point the compile caches at :data:`CACHE`; before torch loads."""
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(CACHE / sub)


@dataclasses.dataclass
class Record:
    """What a per-layer reader may read: the cell, the window's results and
    spans, the trace's summary, the card, and ``steady_ms`` to time a
    variant of the cell's model on the same ring."""

    cell: cells.Cell
    window: dict
    spans: list
    trace: object
    device_kind: str
    steady_ms: object


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, changes: dict = None, wrap=None) -> dict:
    """One run of ``cell``; returns the result line's object.  The kind of
    load its traffic file names (``kinds/<kind>.py``) sets the system up
    and drives the window.  ``changes`` alter the configuration (the
    control's lower precision), ``wrap(model)`` may replace the model's
    entry (the tests' faults)."""
    import torch

    from . import devtrace, judge, loadgen
    from .reference import Reference

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    device = torch.device(device)
    cuda = device.type == "cuda"
    kind = cells.kind_module(cell.traffic["kind"])
    log(f"[setup] s: to the cell's start (interpreter, torch, CUDA) "
        f"{time.perf_counter() - t_start}")
    s = kind.setup(cell, seed, device, changes=changes, wrap=wrap, log=log)
    loadgen.sync(device)
    # set-up's objects out of the collector's way: a full collection inside
    # the window would otherwise walk every object torch and the port made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    sample = loadgen.Sample(cell.traffic["compare"], seed)
    spans = []
    prof = devtrace.capture() if trace else contextlib.nullcontext()
    with prof:
        window = kind.drive(cell, s, seconds, sample, spans)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind_name = torch.cuda.get_device_name(device) if cuda else "cpu"
    for note in window.get("notes", ()):
        log(note)

    breakdown, device_info = None, {}
    if trace:
        summary = devtrace.summarize(devtrace.events(prof))
        log(f"[trace] {summary}" if summary is None else
            f"[trace] {summary.device_events} device events, busy {summary.busy_ns / 1e9} s "
            f"of {summary.window_ns / 1e9} s, kernels {summary.kernel_ns / 1e9} s, "
            f"host-to-device copies {summary.h2d_count}")
        record = Record(cell=cell, window=window, spans=spans, trace=summary,
                        device_kind=kind_name, steady_ms=s.steady_ms)
        metrics = {}
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary is not None:
            device_info = {"busy_s": summary.busy_ns / 1e9, "window_s": summary.window_ns / 1e9}
            breakdown = {"device_ops": [[n[:NAME_CHARS], v] for n, v in summary.ops],
                         "idle_gaps": [list(r) for r in summary.gaps]}
    else:
        values = dict(window, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    # the program's state goes before the reference runs; its outputs stay
    judged = [(s.first_out, s.first_raw)] + [(out, raw) for raw, out in sample.kept]
    s.model = s.variant = None
    del prof
    if cuda:
        torch.cuda.empty_cache()
    reference = Reference(cell.config, device)
    mean = (reference.fpn_mean_line(s.first_raw)
            if cell.config["proc"]["fpn_mode"] != "off" else None)
    numbers = judge.compare(((out, raw, mean) for out, raw in judged), reference)
    correct, checks = judge.verdict(numbers, cell.limits)
    result = {"correct": correct, "attempted": window["buffers"], "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind_name,
                         "count": 1, "memory_peak_bytes": peak, **device_info}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"
    return out.splitlines()[0] if out else "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    use_checkout_caches()

    import torch

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = _power_limit()
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    print(f"card: {result['card']}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
