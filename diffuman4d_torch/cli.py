"""CLI entry point of the port (counterpart of ``diffuman4d_tpu/cli.py``;
reference: inference.py:18-47).

Usage mirrors the JAX package's, so one command line drives both:

    python -m diffuman4d_torch.cli exp=demo_4d data.scene_label=0811_06 \
        data.data_dir=./data/dna_rendering model.model_dir=./models/diffuman4d
    torchrun --nproc_per_node 8 -m diffuman4d_torch.cli exp=demo_4d ...   # waves of 8

Flags ``sampling`` / ``to_nerfstudio`` / ``evaluating`` select the stages
(configs/test.yaml:18-20). ``device=cuda|cpu`` (default ``cuda``) takes the
place of the JAX CLI's ``platform=``: without a card the CLI refuses to run
unless ``device=cpu`` is given. Under ``torchrun`` (``RANK`` /
``WORLD_SIZE`` set) the CLI first brings up the process group
(``parallel/distributed.py``: NCCL on cards, one per rank, gloo with
``device=cpu``) and samples in task waves as wide as the world; if the
group cannot be brought up it raises, it never runs one rank alone. The
export and the evaluation then run on rank 0 after every rank has finished
(the JAX CLI runs them on every process, which race to write the same
files; ``ROADMAP.md`` C). The output directory receives
``config_tree.log``, ``job.log``, ``images/{cam}/{frame}.jpg``,
``phases.json`` (rank 0's), the nerfstudio export (``transforms.json``,
``transforms_input.json``, ``export_manifest.json``, ``fmasks/``,
``images_alpha/``), the grid state ``state/grid_state.d4d`` (written after
every round and every 24 tasks; a later call on the same output directory
resumes from it, and one on a finished directory runs no task and exports
again), with ``sampler.save_debug_grids=true`` ``grids/*.jpg``, and with
``evaluating=true`` ``metrics.json``. As in the JAX CLI,
``sampler.tasks_per_wave`` is read by nothing (a wave's width is the
number of ranks) and a ``split_cfg_domains`` name other than ``spatial`` /
``temporal`` changes nothing (the pipeline tests membership only). A
checkpoint's scheduler may be DDIM, Euler,
DPM++ or DDPM and its UNet may take pose features or skeleton latents, as in
the JAX package; DDPM and DDIM with eta > 0 raise ``ValueError`` at the first
denoising step there and here (``ROADMAP.md`` C).
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import sys
import time

from diffuman4d_torch.configs.presets import RunConfig, build_config, config_tree

log = logging.getLogger("diffuman4d_torch")

_FORMAT = "[%(asctime)s][%(name)s][%(levelname)s] %(message)s"


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO, format=_FORMAT)
    argv = sys.argv[1:] if argv is None else list(argv)
    devices = [a.split("=", 1)[1] for a in argv if a.startswith("device=")]
    argv = [a for a in argv if not a.startswith("device=")]

    import torch

    device = torch.device(devices[-1] if devices else "cuda")
    if device.type not in ("cuda", "cpu"):
        print(f"device={device}: cuda or cpu", file=sys.stderr)
        return 2
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: the port runs on the card; pass device=cpu to run on the CPU",
              file=sys.stderr)
        return 2
    from diffuman4d_torch.parallel import distributed as pdist

    # torchrun runs: the process group first, as the JAX CLI's initialize()
    started = not torch.distributed.is_initialized() and pdist.initialize(device)
    try:
        if device.type == "cuda":  # a rank's own card (initialize set it)
            device = torch.device("cuda", torch.cuda.current_device())
        cfg = build_config(argv)
        lead = pdist.rank() == 0
        if lead:
            print(config_tree(cfg))
        os.makedirs(cfg.sampler.output_dir, exist_ok=True)
        fh = None
        if lead:
            with open(osp.join(cfg.sampler.output_dir, "config_tree.log"), "w") as f:
                f.write(config_tree(cfg))
            # per-run job.log (reference: hydra colorlog job.log)
            fh = logging.FileHandler(osp.join(cfg.sampler.output_dir, "job.log"))
            fh.setFormatter(logging.Formatter(_FORMAT))
            logging.getLogger().addHandler(fh)
        try:
            _run(cfg, device)
        finally:
            if fh is not None:
                logging.getLogger().removeHandler(fh)
                fh.close()
    finally:
        if started:
            torch.distributed.destroy_process_group()
    return 0


def build_sampler(cfg: RunConfig, pipeline, target_pixels: bool = True, **sampler_kw):
    """The dataset and the sampler of ``cfg`` around ``pipeline``, as the
    CLI builds them; ``sampler_kw`` overrides the sampler's defaults (the
    JAX CLI's: a checkpoint every round and every 24 tasks).
    ``target_pixels=False`` skips loading target images, which only the
    debug grids read (the prefix script's dataset)."""
    from diffuman4d_torch.data.dataset import SpaTemDataset
    from diffuman4d_torch.sampling.sampler import SlidingIterativeSampler

    dataset = SpaTemDataset(
        data_dir=cfg.data.data_dir,
        camera_path_pat=cfg.data.camera_path_pat,
        image_path_pat=cfg.data.image_path_pat,
        fmask_path_pat=cfg.data.fmask_path_pat,
        skeleton_path_pat=cfg.data.skeleton_path_pat,
        scene_label=cfg.data.scene_label,
        height=cfg.data.height,
        width=cfg.data.width,
        has_gt_target=cfg.data.has_gt_target,
        target_pixels=target_pixels,
        # generation reads skeletons as uint8 (pipeline._skel_u8)
        skeletons_uint8=True,
    )
    return SlidingIterativeSampler(
        dataset,
        pipeline,
        output_dir=cfg.sampler.output_dir,
        spa_label_range=cfg.sampler.spa_label_range,
        tem_label_range=cfg.sampler.tem_label_range,
        spa_labels=cfg.sampler.spa_labels,
        tem_labels=cfg.sampler.tem_labels,
        input_spa_labels=cfg.sampler.input_spa_labels,
        seed=cfg.sampler.seed,
        save_debug_grids=cfg.sampler.save_debug_grids,
        **sampler_kw,
    )


def _run(cfg: RunConfig, device) -> None:
    from diffuman4d_torch.parallel import distributed as pdist
    from diffuman4d_torch.sampling.loader import load_pipeline
    from diffuman4d_torch.sampling.runner import SamplingRunner
    from diffuman4d_torch.utils.tracing import counters, phase, report

    report(reset=True)  # phases.json and counters.json hold this run only
    counters(reset=True)
    with phase("cli/load_pipeline"):
        pipeline = load_pipeline(cfg.model, cfg.sampler, cfg.data, device=device)
    with phase("cli/build_sampler"):  # grid noise, and the state file if one is there
        sampler = build_sampler(cfg, pipeline)
    runner = SamplingRunner(sampler)

    if cfg.sampling:
        t0 = time.time()
        with phase("cli/sampling"):
            runner.inference()
        log.info("sampling finished in %.1fs", time.time() - t0)
    # the export and the evaluation read every rank's images: rank 0 runs
    # them once every rank is done
    pdist.barrier()
    if pdist.rank() != 0:
        return

    scene_dir = osp.join(osp.expandvars(cfg.data.data_dir), cfg.data.scene_label)
    if cfg.to_nerfstudio:
        with phase("cli/to_nerfstudio"):
            runner.to_nerfstudio(scene_dir)

    if cfg.evaluating:
        with phase("cli/evaluate"):
            metrics = runner.evaluate(data_dir=osp.expandvars(cfg.data.data_dir),
                                      scene_label=cfg.data.scene_label)
        log.info("metrics mean: %s", metrics["mean"])
    runner._dump_phases()


if __name__ == "__main__":
    raise SystemExit(main())
