"""One task of each domain of demo_4d on its full grid (counterpart of
``scripts/demo4d_slice.py``).

It builds the whole 48 x 150 grid (7,200 latent cells at 128^2, ~0.94 GB
in bf16 on the card) through the ``exp=demo_4d`` preset's construction
(window 12, stride 2, DDIM, CFG 2.0; the pipeline's default caches and CFG
fused on both domains, as the script has it) and runs at production shapes
one spatial task (48 rows) and then, on a fresh grid, one temporal task
(300 rows: the condition camera and the target camera over 150 frames):
a round-2 task on a grid whose round 1 is partly done would trip the
sampler's invariants. Each task is timed by phase (``load_sample``,
``prepare_conditions``, ``denoise``, ``decode_save``). Then the grid state
is written and a fresh sampler must resume it (timesteps equal, latents
equal).

    python -m diffuman4d_torch.demo4d_slice [--scene DIR] [--out DIR] [--size 1024]
        [--tiny] [key=value ...]

An earlier state in ``--out`` is removed first, so every call starts from
fresh grids. ``--tiny`` is the smoke-test model at 64^2 (the same 48 x 150
grid logic); trailing ``key=value`` arguments override the preset as on the
CLI. Prints one JSON line. The card unless ``--device cpu``; without a card
it exits 2."""

from __future__ import annotations

import argparse
import json
import os.path as osp
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default=None,
                    help="scene root (default runs/d4d_4d_scene_{size}, made if missing)")
    ap.add_argument("--out", default=str(ROOT / "runs" / "d4d_4d_slice_out"))
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--tiny", action="store_true", help="the smoke-test model at 64^2")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("overrides", nargs="*", metavar="key=value",
                    help="config overrides after the preset's, as the CLI takes them")
    args = ap.parse_args(argv)
    if args.tiny:
        args.size = 64
    if args.scene is None:
        args.scene = str(ROOT / "runs" / f"d4d_4d_scene_{args.size}")
    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("demo4d_slice: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    from diffuman4d_torch import cli
    from diffuman4d_torch.demo4d_prefix import demo4d_config, make_scene, scene_missing
    from diffuman4d_torch.sampling.loader import load_pipeline
    from diffuman4d_torch.utils.tracing import card

    cuda = args.device == "cuda"
    t0 = time.perf_counter()

    def mark(what):
        print(f"[slice] {what}: {time.perf_counter() - t0:.1f}s cumulative", flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = demo4d_config(args.scene, args.size, args.out, "tiny" if args.tiny else "full",
                        args.device, ["sampler.split_cfg_domains=[]", *args.overrides])
    if scene_missing(cfg):
        make_scene(cfg)
        mark("scene rendered")
    shutil.rmtree(osp.join(args.out, "state"), ignore_errors=True)
    pipeline = load_pipeline(cfg.model, cfg.sampler, cfg.data, device=args.device)
    mark("pipeline")

    def fresh_sampler():
        return cli.build_sampler(cfg, pipeline, target_pixels=False)

    sampler = fresh_sampler()
    grid = sampler.grid_latents
    mark(f"grid init: {grid.shape[0] * grid.shape[1]} cells, "
         f"{grid.numel() * grid.element_size() / 2**20:.0f} MB on {args.device}")
    report = {"card": card(), "grid": list(grid.shape),
              "total_steps": pipeline.sliding.total_steps, "tasks": {}}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    spatial, temporal = sampler.all_tasks[0][0], sampler.all_tasks[1][0]
    for task in (spatial, temporal):
        if task is temporal:  # a fresh grid for the second domain
            sampler = fresh_sampler()
        phases = {}
        tt = tp = time.perf_counter()

        def pmark(name):
            nonlocal tp
            sync()
            phases[name] = time.perf_counter() - tp
            tp = time.perf_counter()

        sample = sampler.load_sample(task)
        pmark("load_sample")
        spa, tem = sampler._grid_cells(sample.labels)
        with torch.no_grad():
            cond = pipeline.prepare_conditions(sample)
        pmark("prepare_conditions")
        dev = sampler.grid_latents.device
        spa_t, tem_t = torch.from_numpy(spa).to(dev), torch.from_numpy(tem).to(dev)
        latents, t_idx, aux = pipeline.sliding_denoise(
            cond, sampler.grid_latents[spa_t, tem_t], sampler.grid_t_idx[spa, tem],
            sampler._windows_for(task, len(sample.labels)), task.domain)
        pmark("denoise")
        sampler._scatter(sample.labels, latents, t_idx, aux)
        sampler._save_task_outputs(task, sample, latents, t_idx)
        pmark("decode_save")
        dt = time.perf_counter() - tt
        done = int((sampler.grid_t_idx > 0).sum())
        report["tasks"][task.domain] = {"label": task.domain_label, "sec": dt,
                                        "rows": len(sample.labels), "cells_touched": done,
                                        "phases": phases}
        mark(f"{task.domain} task {task.domain_label}: {dt:.1f}s ({done} grid cells now in "
             f"flight) phases={phases}")

    tt = time.perf_counter()
    sampler.save_state()
    size_mb = osp.getsize(sampler._state_path) / 2**20
    mark(f"grid_state checkpoint: {size_mb:.0f} MB, {time.perf_counter() - tt:.1f}s")
    tt = time.perf_counter()
    resumed = fresh_sampler()
    if not np.array_equal(resumed.grid_t_idx, sampler.grid_t_idx):
        raise AssertionError("demo4d_slice: the resumed timestep indices differ")
    if not torch.equal(resumed.grid_latents, sampler.grid_latents):
        raise AssertionError("demo4d_slice: the resumed latents differ")
    report.update(resume_reload_s=time.perf_counter() - tt, checkpoint_mb=size_mb,
                  peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None)
    mark("resume reload verified")
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
