"""Find the highest rate an open-loop mix sustains on a configuration: one
set-up, then the mix's window at each rate in turn, on the card (a kind
whose ``drive`` takes ``rate``, such as ``kinds/open_loop.py``).

    python3 -m portbench.sweep --config octproz-figshare-12bit --traffic open_loop_83 \
        --seed 5 --seconds 8 --rates 100,120,140

prints one JSON line per rate: the latency's p50, p95 and maximum, its
growth (the mean of the last quarter of buffers minus that of the first:
a backlog that grows all through the window reads far above 0), and how
late the submitter ran.  The sustained rate is the highest without a
growing backlog; a cell offers a fixed share of it, written into its
traffic file before the cell is listed in ``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import cells, loadgen
from .run import use_checkout_caches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True, help="a configuration of BENCHMARK.json")
    p.add_argument("--traffic", required=True, help="a mix: traffic/<mix>.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", required=True, help="buffers per second, comma-separated")
    args = p.parse_args(argv)
    use_checkout_caches()
    import torch

    bench = json.loads((cells.REPO / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": "sweep", "config": args.config, "traffic": args.traffic,
                           "chips": 1}]
    cell = cells.load_cell("sweep", bench)
    if not torch.cuda.is_available():
        print("portbench.sweep needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = cells.kind_module(cell.traffic["kind"])
    s = kind.setup(cell, args.seed, device)
    for rate in (float(r) for r in args.rates.split(",")):
        w = kind.drive(cell, s, args.seconds, loadgen.Sample(0, 0), [], rate=rate)
        w.pop("latency_ms")
        w.pop("notes")
        print(json.dumps({"config": args.config, "traffic": args.traffic, "rate_per_s": rate,
                          **w}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
