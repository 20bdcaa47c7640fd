"""The temporal round of demo_4d at the production 48 x 150 shape without
the spatial round before it (counterpart of
``scripts/temporal_wave_proof.py``).

It seeds a "round 1 complete" grid state as the script does -- every target
cell at ``t_idx = steps_per_alt`` with its initial noise as its latent,
input cells at 0, the invariant the sampler checks at a round boundary --
checks it with the sampler's grid check, writes it with the port's
``io/gridstate.py`` (byte-equal to the JAX package's files; a copy stays as
``state/grid_state_seeded.d4d``) and then runs production temporal tasks
(300 rows each, CFG split on the temporal domain, the prefix script's cache
budgets) through the port's serial sampler until ``--task-budget`` or
``--time-budget``. The JAX script ran them as waves on a device mesh; the
port runs one card's tasks one at a time (``ROADMAP.md`` C.19). The latent
values are not round 1's, so the images mean nothing: what it shows is
that the temporal program fits and how long a task takes.

    python -m diffuman4d_torch.temporal_wave_proof [--task-budget 2] [--scene DIR]
        [--out DIR] [--size 1024] [--time-budget S] [key=value ...]

A second call on the same ``--out`` resumes the state instead of seeding.
Trailing ``key=value`` arguments override the ``exp=demo_4d`` preset as on
the CLI (a cut grid, say). Prints one JSON line: the tasks, their seconds,
the peak device memory and the phases. The card unless ``--device cpu``
(``--arch tiny`` with a small ``--size``); without a card it exits 2."""

from __future__ import annotations

import argparse
import json
import logging
import os.path as osp
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seed_round1(sampler) -> int:
    """The script's synthetic round-1-complete grid: targets at
    ``steps_per_alt``, inputs at 0, round 1 done. Returns the cells seeded."""
    import numpy as np

    spa = sampler.pipeline.sliding.steps_per_alt
    input_rows = [sampler._spa_index[s] for s in sampler.input_spa_labels]
    t_idx = np.full(sampler.grid_t_idx.shape, spa, np.int32)
    t_idx[input_rows, :] = 0
    sampler.grid_t_idx = t_idx
    sampler._completed_rounds = 1
    return int((t_idx > 0).sum())


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s",
                        datefmt="%H:%M:%S")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default=None, help="scene root (made if missing)")
    ap.add_argument("--out", default=str(ROOT / "runs" / "temporal_wave_proof"))
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--task-budget", type=int, default=2)
    ap.add_argument("--time-budget", type=float, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arch", default="full", choices=("full", "tiny"))
    ap.add_argument("overrides", nargs="*", metavar="key=value",
                    help="config overrides after the preset's, as the CLI takes them")
    args = ap.parse_args(argv)
    if args.scene is None:
        args.scene = str(ROOT / "runs" / f"d4d_4d_scene_{args.size}")
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("temporal_wave_proof: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    from diffuman4d_torch import cli
    from diffuman4d_torch.demo4d_prefix import CACHE_MB, demo4d_config, make_scene, scene_missing
    from diffuman4d_torch.sampling.loader import load_pipeline
    from diffuman4d_torch.utils.tracing import card, report

    t0 = time.perf_counter()

    def mark(what: str) -> None:
        print(f"[tproof] {what}: {time.perf_counter() - t0:.1f}s", flush=True)

    cfg = demo4d_config(args.scene, args.size, args.out, args.arch, args.device, args.overrides)
    if scene_missing(cfg):
        make_scene(cfg)
        mark("scene rendered")
    pipeline = load_pipeline(cfg.model, cfg.sampler, cfg.data, device=args.device, **CACHE_MB)
    mark("pipeline")
    sampler = cli.build_sampler(cfg, pipeline, target_pixels=False,
                                task_budget=args.task_budget, time_budget_s=args.time_budget,
                                checkpoint_every_tasks=8)
    if sampler._completed_rounds == 0 and sampler._resume_tasks_done == 0:
        cells = seed_round1(sampler)
        sampler.validate_grid(1)
        sampler.save_state()
        shutil.copyfile(sampler._state_path, osp.join(args.out, "state",
                                                      "grid_state_seeded.d4d"))
        mark(f"seeded synthetic round-1 state: {cells} target cells at "
             f"t_idx={pipeline.sliding.steps_per_alt}")
    else:
        mark(f"resuming proof state: round {sampler._completed_rounds} + "
             f"{sampler._resume_tasks_done} tasks")
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    report(reset=True)
    tt = time.perf_counter()
    sampler.execute_tasks()
    ran, dt = sampler._tasks_run, time.perf_counter() - tt
    mark(f"TEMPORAL TASKS OK: {ran} temporal tasks in {dt:.1f}s ({dt / max(ran, 1):.1f}s/task)"
         f" at {len(sampler.spa_labels)}x{len(sampler.tem_labels)}")
    rep = {"card": card(), "tasks": ran, "wall_s": dt, "s_per_task": dt / max(ran, 1),
           "state": [sampler._completed_rounds, sampler._tasks_run],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if args.device == "cuda" else None,
           "phases": report()}
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
