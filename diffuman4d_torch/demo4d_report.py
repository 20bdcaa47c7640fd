"""Roll the chained demo_4d sessions up into one JSON (counterpart of
``scripts/demo4d_report.py``): the sessions of ``sessions.jsonl``
(``demo4d_chain``), the grid's progress from the output directory's grid
state (read with the port's ``io/gridstate.py``) and the images written so
far, with each phase's mean seconds per session.

    python -m diffuman4d_torch.demo4d_report [--sessions PATH] [--outdir DIR]
        [--out PATH]

It reads files only; like every tool of the port it runs where there is a
card unless given ``--device cpu``, and without a card it exits 2."""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = ("demo_4d 48x150 @1024^2, sliding_fast (window 12, stride 2, 3 alternation rounds, "
            "18 steps/target), synthetic scene, random-init 0.87B UNet — "
            "configs/exp/demo_4d.yaml parity")


def report(sessions_path: str, outdir: str) -> dict:
    """The roll-up of ``sessions_path`` and the output directory ``outdir``."""
    sessions = []
    if osp.isfile(sessions_path):
        with open(sessions_path) as f:
            sessions = [json.loads(ln) for ln in f if ln.strip()]
    rep: dict = {
        "workload": WORKLOAD,
        "total_tasks": {"round1_spatial": 150, "round2_temporal": 44, "round3_spatial": 150},
        "sessions": sessions,
        "process_restarts": max(0, len(sessions) - 1),
        "notes": ["Each session is a fresh process resuming from the last grid-state "
                  "checkpoint (deliberate-restart resume proof)."],
    }
    state = osp.join(outdir, "state", "grid_state.d4d")
    if osp.isfile(state):
        import numpy as np

        from diffuman4d_torch.io.gridstate import read_state

        meta, data = read_state(state)
        t = np.asarray(data["t_idx"])
        rep["grid"] = {
            "completed_rounds": meta["completed_rounds"],
            "tasks_done_in_round": meta["tasks_done_in_round"],
            "cells_in_flight": int((t > 0).sum()),
            "cells_total": int(t.size),
            "t_idx_histogram": {int(v): int((t == v).sum())
                                for v in sorted(set(t.flatten().tolist()))},
            "state_file_mb": round(osp.getsize(state) / 2**20, 1),
        }
    img_dir = osp.join(outdir, "images")
    n_img = 0
    if osp.isdir(img_dir):
        for d in os.listdir(img_dir):
            p = osp.join(img_dir, d)
            if osp.isdir(p):
                n_img += sum(1 for f in os.listdir(p) if f.endswith(".jpg"))
    rep["images_on_disk"] = n_img
    rep["images_expected_at_completion"] = 48 * 150
    agg: dict = {}
    for s in sessions:
        for k, v in (s.get("phases") or {}).items():
            agg.setdefault(k, []).append(v["mean_s"])
    rep["phase_mean_s_by_session"] = {k: [round(x, 2) for x in v] for k, v in agg.items()}
    return rep


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", default=str(ROOT / "runs" / "demo4d_chain" / "sessions.jsonl"))
    ap.add_argument("--outdir", default=str(ROOT / "runs" / "d4d_4d_prefix_out"))
    ap.add_argument("--out", default=str(ROOT / "runs" / "demo4d_chain" / "report.json"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("demo4d_report: no CUDA device; pass --device cpu to run on the CPU",
                  file=sys.stderr)
            return 2
    rep = report(args.sessions, args.outdir)
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=2)
    print(json.dumps({k: rep[k] for k in rep if k != "sessions"}, indent=2))
    print(f"written to {args.out} ({len(rep['sessions'])} sessions)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
