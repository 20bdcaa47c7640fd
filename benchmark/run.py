"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload pose-demo3d --seed 7 --seconds 50 --trace 0

Exits with 2, printing no result, without a CUDA card (or with fewer cards
than the cell asks for) or without the port's package. The last line of
standard output is the result's JSON object; the numbers that the output
check compared, each beside its limit, are the last lines of standard
error. ``--trace 1`` profiles the window and reports the per-layer metrics.
A report with the peak memory, the spans and the set-up's parts is written
to ``benchmark/.cache/reports/<cell>.json``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import os.path as osp  # noqa: E402
import sys  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        print("--seed must be a whole number >= 0", file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_CACHE_DIR", osp.join(ROOT, "benchmark", ".cache", "triton"))
    sys.path.insert(0, ROOT)
    import torch

    try:
        with open(osp.join(ROOT, "BENCHMARK.json")) as f:
            entry = {w["name"]: w for w in json.load(f)["workloads"]}[args.workload]
    except (OSError, KeyError) as e:
        print(f"no workload {args.workload!r} in BENCHMARK.json: {e!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import diffuman4d_torch  # noqa: F401
    except ImportError as e:
        print(f"the port's package is missing from this checkout: {e}", file=sys.stderr)
        return 2
    from benchmark.harness import runner

    out = runner.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    res, rep = out["result"], out["report"]
    rep.update(workload=args.workload, seed=args.seed, trace=args.trace, result=res)
    os.makedirs(osp.join(ROOT, "benchmark", ".cache", "reports"), exist_ok=True)
    with open(osp.join(ROOT, "benchmark", ".cache", "reports", f"{args.workload}.json"), "w") as f:
        json.dump(rep, f, indent=1, default=str)
    print(f"memory_peak_bytes {rep['memory_peak_bytes']} window_s {rep['window_s']} "
          f"tasks {rep['tasks']}", flush=True)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
