"""demo_4d's production schedule through the port's serial sampler, in
sessions that resume one another (counterpart of
``scripts/demo4d_prefix.py``).

Runs ``exp=demo_4d`` (48 cameras x 150 frames, window 12, stride 2, three
rounds, DDIM, CFG 2.0, CFG split on the temporal domain, bf16) on a
synthetic scene through the CLI's own construction -- ``build_config``,
``load_pipeline``, ``cli.build_sampler`` -- and
``SlidingIterativeSampler.execute_tasks``, with a per-call task budget: each
call continues from the output directory's last grid state, runs up to
``--task-budget`` tasks with checkpoints every ``--checkpoint-every`` tasks,
then stops with the state saved. Running it again is the resume: a fresh
process, a fresh sampler, the same grid. Weights come from the preset's
``model.model_dir`` when it holds a diffusers checkpoint, else random from
seed 0, as in the CLI.

    python -m diffuman4d_torch.demo4d_prefix --task-budget 24   # session 1
    python -m diffuman4d_torch.demo4d_prefix --task-budget 40   # resume
    python -m diffuman4d_torch.demo4d_prefix --report           # progress + export
    python -m diffuman4d_torch.demo4d_prefix --task-budget 2 sampler.tem_label_range=[0,12,1]

Each call writes ``phases.json`` (this call's phases) and ``counters.json``
(its counters: tasks, latent steps, cache hits and misses) into the output
directory and prints one JSON line: the resume point, the tasks run, the
seconds they took and the peak device memory. ``--report`` runs no task and
exports what the output directory holds so far. The card is used unless
``--device cpu`` is given (fp32 there); ``--arch tiny`` (with a small
``--size``) is the smoke-test model shape. Trailing ``key=value`` arguments
override the preset as on the CLI's command line (a cut grid, say).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import os.path as osp
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Cache budgets for this workload's reuse, not the pipeline's defaults
# (3072 / 512 / 1536 MB): within a spatial round every (camera, frame) cell is
# visited once, so large skeleton and latent caches only hold memory; the
# temporal rounds reuse the 4 input-camera tracks and stream their skeletons.
# The pose cache holds one spatial task's features (48 rows x 10.5 MB), so
# spatial tasks materialise and 300-row temporal tasks stream.
CACHE_MB = dict(skel_cache_mb=512, pix_cache_mb=192, pose_cache_mb=640)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default=None, help="scene root (made if missing)")
    ap.add_argument("--out", default=str(ROOT / "runs" / "d4d_4d_prefix_out"))
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--task-budget", type=int, default=24)
    ap.add_argument("--time-budget", type=float, default=None,
                    help="seconds: stop cleanly after the first task that ends past it")
    ap.add_argument("--checkpoint-every", type=int, default=24,
                    help="intra-round grid-state cadence in tasks")
    ap.add_argument("--report", action="store_true",
                    help="run no task; print progress and export the outputs so far")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arch", default="full", choices=("full", "tiny"))
    ap.add_argument("overrides", nargs="*", metavar="key=value",
                    help="config overrides after the preset's, as the CLI takes them")
    args = ap.parse_args(argv)
    if args.scene is None:
        args.scene = str(ROOT / "runs" / f"d4d_4d_scene_{args.size}")
    return args


def demo4d_config(scene: str, size: int, out: str, arch: str = "full", device: str = "cuda",
                  overrides=()):
    """The ``exp=demo_4d`` run config on a scene root at ``size``^2 writing
    to ``out``, at the tiny model for ``arch="tiny"``, fp32 on the CPU, with
    the CLI-style ``overrides`` last."""
    from diffuman4d_torch.configs.presets import build_config

    return build_config(["exp=demo_4d", f"data.data_dir={scene}", f"data.height={size}",
                         f"data.width={size}", f"sampler.output_dir={out}"]
                        + (["model.arch=tiny"] if arch == "tiny" else [])
                        + (["model.dtype=fp32"] if device == "cpu" else []) + list(overrides))


def scene_missing(cfg) -> bool:
    data = cfg.data
    return not osp.isfile(osp.join(data.data_dir, data.scene_label, "transforms.json"))


def make_scene(cfg) -> None:
    """``cfg``'s synthetic scene on its grid at its size: 4 frames rendered
    a camera, the rest hardlinked."""
    from diffuman4d_torch.data import make_synthetic_scene

    make_synthetic_scene(cfg.data.data_dir, cfg.data.scene_label,
                         num_cams=cfg.sampler.spa_label_range[1],
                         num_frames=cfg.sampler.tem_label_range[1], image_size=cfg.data.height,
                         unique_frames=4)


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s",
                        datefmt="%H:%M:%S")
    args = _args(sys.argv[1:] if argv is None else argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    from diffuman4d_torch import cli
    from diffuman4d_torch.sampling.loader import load_pipeline
    from diffuman4d_torch.utils.tracing import counters, dump_counters, dump_report, phase, report

    cfg = demo4d_config(args.scene, args.size, args.out, args.arch, args.device, args.overrides)
    report(reset=True)  # phases.json and counters.json hold this call only
    counters(reset=True)
    t0 = time.perf_counter()
    if scene_missing(cfg):
        with phase("prefix/make_scene", sync=False):
            make_scene(cfg)
    with phase("prefix/load_pipeline"):
        pipeline = load_pipeline(cfg.model, cfg.sampler, cfg.data, device=args.device,
                                 **CACHE_MB)
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with phase("prefix/sampler_init"):  # grid noise, and the state file if one is there
        # generation reads no target image, so the dataset skips them
        sampler = cli.build_sampler(
            cfg, pipeline, target_pixels=False,
            task_budget=None if args.report else args.task_budget,
            time_budget_s=None if args.report else args.time_budget,
            checkpoint_every_tasks=args.checkpoint_every)
    rep = {"resumed_rounds": sampler._completed_rounds,
           "resumed_tasks": sampler._resume_tasks_done,
           "cells_in_flight": int((sampler.grid_t_idx > 0).sum()),
           "cells_total": int(sampler.grid_t_idx.size)}
    if args.report:
        from diffuman4d_torch.io.nerfstudio import export_to_nerfstudio

        state = Path(sampler._state_path)
        rep["state_mb"] = state.stat().st_size / 2**20 if state.is_file() else None
        try:
            rep["nerfstudio_manifest"] = export_to_nerfstudio(
                osp.join(args.scene, scene_label), args.out, sampler.input_spa_labels)
        except (OSError, ValueError) as e:  # a prefix's outputs may be partial
            rep["nerfstudio_manifest_error"] = str(e)[:200]
    else:
        t_run = time.perf_counter()
        sampler.execute_tasks()
        run_s = time.perf_counter() - t_run
        rep.update({"tasks_run": sampler._tasks_run, "run_s": run_s,
                    "s_per_task": run_s / max(sampler._tasks_run, 1),
                    "completed_rounds": sampler._completed_rounds,
                    "cells_in_flight_after": int((sampler.grid_t_idx > 0).sum()),
                    "complete": sampler._completed_rounds == len(sampler.all_tasks)})
    if args.device == "cuda":
        rep["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rep["device"] = torch.cuda.get_device_name(0)
    rep["wall_s"] = time.perf_counter() - t0
    rep["phases"] = report()
    os.makedirs(args.out, exist_ok=True)
    dump_report(osp.join(args.out, "phases.json"))
    dump_counters(osp.join(args.out, "counters.json"))
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
