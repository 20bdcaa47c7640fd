"""Multi-rank dry run on the CPU (the port's counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``: its inference half
``_dryrun_inference_waves`` and its data- and tensor-parallel train step).

    python -m diffuman4d_torch.dryrun_multichip 4

spawns n gloo ranks on the CPU (``parallel/distributed.spawn_cpu_ranks``)
and runs one full alternation round of the sliding sampler on the
production mesh layout: a (data x model) mesh, model 2 when n >= 4 and n is
even, so waves of data-many tasks each denoise context-parallel over the
model axis. The UNet has the production topology (4 stages, 3D attention in
the deepest three, temporal embeddings, pose encoder) at toy widths, the VAE
likewise; random fp32 weights from seed 0, the 6-camera x 2-frame synthetic
scene at 64^2, inputs [0, 3], window 2, DDIM, CFG 2.0. Then ``validate_grid``
checks the schedule on every rank, and rank 0's line is printed.

Then one train step on the same mesh, as the JAX dry run takes it: a
two-stage UNet at toy widths in fp32, ``TrainConfig(remat=True)``, the
temporal domain, one window of 4 frames at 8^2 latents per data row (zero
latents, rays and skeletons, the first two frames conditions), the
parameters placed by ``shard_params_for_tp`` at its default ``min_size``
(at these widths nothing reaches 2**16, as in JAX), the draws from seed 1.
Rank 0 prints ``dryrun_multichip OK: mesh=(dxm) loss=... grad_norm=...``
after a finite loss and step 1.
"""

from __future__ import annotations

import os.path as osp
import sys
import tempfile

SCENE = dict(num_cams=6, num_frames=2, image_size=64)


def _inference_waves(rank: int, world: int, scene_dir: str, out_dir: str) -> str:
    import torch

    from diffuman4d_torch.data import SpaTemDataset
    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.parallel.mesh import make_mesh
    from diffuman4d_torch.sampling.loader import build_models
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline, SlidingConfig
    from diffuman4d_torch.sampling.sampler import SlidingIterativeSampler
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig

    cfg = UNetConfig(in_channels=11, block_out_channels=(8, 8, 16, 16),
                     num_attention_heads=(1, 1, 2, 2), layers_per_block=1, norm_num_groups=4,
                     num_3d_attn_blocks=3, enable_tem_embeds=True, enable_pose_encoder=True)
    unet, vae = build_models(cfg, VAEConfig(block_out_channels=(4, 4, 8, 8), layers_per_block=1),
                             device="cpu", dtype=torch.float32, seed=0)
    pipeline = Diffuman4DPipeline(
        unet, vae, Scheduler(SchedulerConfig(kind="ddim")),
        SlidingConfig(window_size=2, alternation_rounds=1, guidance_scale=2.0),
        image_size=SCENE["image_size"], vae_batch=4)
    model_par = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh(data=world // model_par, model=model_par)
    if model_par > 1:
        pipeline.enable_context_parallel(mesh)
    dataset = SpaTemDataset(data_dir=scene_dir, scene_label="scene0", height=64, width=64)
    sampler = SlidingIterativeSampler(dataset, pipeline, output_dir=out_dir,
                                      spa_label_range=(0, 6, 1), tem_label_range=(0, 2, 1),
                                      input_spa_labels=[0, 3])
    sampler.execute_tasks_parallel(mesh)
    sampler.validate_grid(after_rounds=1)
    return (f"dryrun inference waves OK: mesh=({mesh.shape['data']}x{mesh.shape['model']}) "
            f"full-topology UNet (4-stage, CP {'active' if model_par > 1 else 'off'}), "
            "grid validated")


def _train_step(rank: int, world: int) -> str:
    import numpy as np
    import torch

    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.parallel.mesh import make_mesh
    from diffuman4d_torch.sampling.loader import build_models
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.training.trainer import (
        TrainConfig,
        create_train_state,
        make_train_step,
    )

    model_par = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh(data=world // model_par, model=model_par)
    cfg = UNetConfig(in_channels=11, block_out_channels=(8, 16), num_attention_heads=(1, 2),
                     layers_per_block=1, norm_num_groups=4, num_3d_attn_blocks=1)
    unet, _ = build_models(cfg, VAEConfig(block_out_channels=(4, 4, 8, 8), layers_per_block=1),
                           device="cpu", dtype=torch.float32, seed=0)
    tcfg = TrainConfig(remat=True)
    state = create_train_state(unet, tcfg, mesh)  # shard_params_for_tp at its default min_size
    step = make_train_step(unet, Scheduler(SchedulerConfig()), tcfg, "temporal", mesh)
    L, hw = 4, 8  # one window per data row
    batch = {"latents_x0": torch.zeros((1, L, hw, hw, 4)),
             "plucker": torch.zeros((1, L, hw, hw, 6)),
             "skeletons": torch.zeros((1, L, hw * 8, hw * 8, 3)),
             "is_cond": torch.tensor([[True, True, False, False]])}
    state, metrics = step(state, batch, torch.Generator().manual_seed(1))
    loss = metrics["loss"].item()
    assert np.isfinite(loss), f"non-finite loss: {loss}"
    assert metrics["step"] == 1
    return (f"dryrun_multichip OK: mesh=({mesh.shape['data']}x{mesh.shape['model']}) "
            f"loss={loss:.4f} grad_norm={metrics['grad_norm'].item():.4f}")


def _dryrun(rank: int, world: int, scene_dir: str, out_dir: str) -> list[str]:
    return [_inference_waves(rank, world, scene_dir, out_dir), _train_step(rank, world)]


def dryrun_multichip(n: int, timeout_s: float = 600.0) -> list[str]:
    """The dry run on ``n`` CPU ranks; returns rank 0's two lines (the
    inference waves, the train step)."""
    from diffuman4d_torch.data import make_synthetic_scene
    from diffuman4d_torch.parallel.distributed import spawn_cpu_ranks

    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_scene(tmp, "scene0", **SCENE)
        lines = spawn_cpu_ranks(_dryrun, n, (tmp, osp.join(tmp, "out")), timeout_s=timeout_s)
    return lines[0]


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 4
    for line in dryrun_multichip(n):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
