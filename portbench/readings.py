"""The compared numbers of a cell over many seeds, in one process: the
sound runs that set each limit's lower reading, and the control -- the
configuration at ``compute_dtype="bfloat16"``, the port's own lower
precision -- that sets its upper reading.

    python3 -m portbench.readings --workload figshare.replay --seconds 2 --seeds 11,12,13
    python3 -m portbench.readings --workload figshare.replay --seconds 2 --seeds 1,2,3 --control

Each run is the cell's own: its sizes, its traffic, its window (shorter),
its comparison.  One JSON line per seed, then the largest and smallest
reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import cells, judge
from .run import run_cell, use_checkout_caches

CONTROL = {"compute_dtype": "bfloat16"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    use_checkout_caches()
    import torch

    if not torch.cuda.is_available():
        print("portbench.readings needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    variant = "control" if args.control else "sound"
    seen = {name: [] for name in judge.NUMBERS}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                     time.perf_counter(), changes=CONTROL if args.control else None)
        numbers = {k: c["value"] for k, c in r["checks"].items()}
        for k, v in numbers.items():
            seen[k].append(v)
        print(json.dumps({"workload": cell.name, "variant": variant, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"], **numbers}),
              flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": cell.name, "variant": variant, "runs": len(seen["rms"]),
                      "max": {k: max(v) for k, v in seen.items()},
                      "min": {k: min(v) for k, v in seen.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
