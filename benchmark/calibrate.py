"""Readings for the limits of a cell's output check: the program's numbers
and the control's (the plain reference computed with float8 e4m3 products,
put in the program's place) on many seeds, in one process, each run one
short window at the cell's own shapes.

    python3 benchmark/calibrate.py --workload skel-temporal --seeds 1-12 \
        --out chiprun_out/cal_skel-temporal.jsonl

Each seed appends one JSON line: the seed, the program's readings and its
verdict at the cell's limits, the control's readings and its verdict through
the same code, the run's set-up and window seconds. The benchmark's own runs
never run the control. On the card only, as ``run.py``.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys
import time

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,7,9")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py runs on a CUDA card", file=sys.stderr)
        return 2
    from benchmark.harness import runner

    for seed in seeds(args.seeds):
        t = time.perf_counter()
        out = runner.run(args.workload, seed, args.seconds, False, t, control=True)
        line = {"workload": args.workload, "seed": seed,
                "program": {k: c["value"] for k, c in out["result"]["checks"].items()},
                "control": {k: c["value"] for k, c in out["control"]["checks"].items()},
                "correct": out["result"]["correct"],
                "control_correct": out["control"]["correct"],
                "setup_s": out["report"]["setup_s"], "window_s": out["report"]["window_s"],
                "run_s": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
