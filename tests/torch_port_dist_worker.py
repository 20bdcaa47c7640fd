"""Rank functions of the port's multi-process tests
(``tests/test_torch_port_{distributed,cp,waves,dryrun}.py``).

Each runs in a process that ``diffuman4d_torch.parallel.distributed
.spawn_cpu_ranks`` spawned as one rank of a gloo group on the CPU, and
returns numpy values to the test. This module imports the port and torch
only, never jax or the JAX package: the JAX oracle runs in the test's own
process.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

# the grid of the wave tests: demo_4d's schedule on a tiny scene (6 cameras
# x 4 frames at 64^2, inputs [0, 3], window 2, stride 2), two rounds
# (spatial, temporal), CFG 2.0 fused on the spatial domain and split on the
# temporal one; fp32 random weights of the production topology at toy widths
IMAGE = 64
SCENE = dict(num_cams=6, num_frames=4, image_size=IMAGE)
TINY_UNET = dict(in_channels=11, block_out_channels=(8, 8, 16, 16),
                 num_attention_heads=(1, 1, 2, 2), layers_per_block=1, norm_num_groups=4,
                 num_3d_attn_blocks=3, enable_tem_embeds=True, enable_pose_encoder=True)
TINY_VAE = dict(block_out_channels=(4, 4, 8, 8), layers_per_block=1)


def build_sampler(scene: str, out: str, kind: str = "ddim", rounds: int = 2, **kw):
    """The wave tests' sampler (the same weights in every process)."""
    from diffuman4d_torch.data import SpaTemDataset
    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.sampling.loader import build_models
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline, SlidingConfig
    from diffuman4d_torch.sampling.sampler import SlidingIterativeSampler
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig

    unet, vae = build_models(UNetConfig(**TINY_UNET), VAEConfig(**TINY_VAE), device="cpu",
                             dtype=torch.float32, seed=0)
    pipe = Diffuman4DPipeline(
        unet, vae, Scheduler(SchedulerConfig(kind=kind)),
        SlidingConfig(window_size=2, sliding_stride=2, alternation_rounds=rounds,
                      guidance_scale=2.0, split_cfg_domains=("temporal",)),
        image_size=IMAGE, vae_batch=4)
    dataset = SpaTemDataset(data_dir=scene, scene_label="scene0", height=IMAGE, width=IMAGE)
    kw.setdefault("tem_label_range", (0, SCENE["num_frames"], 1))
    return SlidingIterativeSampler(dataset, pipe, output_dir=out,
                                   spa_label_range=(0, SCENE["num_cams"], 1),
                                   input_spa_labels=[0, 3], **kw)


def grid_of(sampler) -> dict:
    """A sampler's grid as numpy: latents, t_idx, history, and its counts."""
    out = {"latents": sampler.grid_latents.numpy().copy(), "t_idx": sampler.grid_t_idx.copy(),
           "tasks_run": sampler._tasks_run, "completed_rounds": sampler._completed_rounds}
    for k, v in (sampler.grid_aux or {}).items():
        out[f"aux_{k}"] = v.numpy().copy()
    return out


def run_waves(rank: int, world: int, scene: str, out: str, data: int, model: int,
              kw: dict) -> dict:
    """One sampler run (``build_sampler(**kw)``) in waves over a (data,
    model) mesh, through the runner as the CLI drives it."""
    from diffuman4d_torch.parallel.mesh import make_mesh
    from diffuman4d_torch.sampling.runner import SamplingRunner

    sampler = build_sampler(scene, out, **kw)
    mesh = make_mesh(data=data, model=model)
    SamplingRunner(sampler, mesh).inference()
    return grid_of(sampler)


def refuse_time_budget(rank: int, world: int, scene: str, out: str) -> str:
    from diffuman4d_torch.parallel.mesh import make_mesh

    sampler = build_sampler(scene, out, time_budget_s=60.0)
    try:
        sampler.execute_tasks_parallel(make_mesh())
    except ValueError as e:
        return str(e)
    return "ran"


def mesh_info(rank: int, world: int, data: int, model: int) -> dict:
    """This rank's coordinates, the ranks of its two axis groups (through
    the mesh's all-gather), its data rows, a wave-row gather and the
    RankedLogger's records."""
    from diffuman4d_torch.parallel import distributed as pdist
    from diffuman4d_torch.parallel.mesh import make_mesh
    from diffuman4d_torch.utils.tracing import RankedLogger

    mesh = make_mesh(data=data, model=model)
    me = torch.tensor([rank])
    rows = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 100 * rank
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("torch_port_dist_worker.ranked")
    logger.addHandler(Keep())
    logger.setLevel(logging.INFO)
    RankedLogger(logger.name).info("wave %d", 7)
    RankedLogger(logger.name, rank_zero_only=True).info("once")
    return {
        "coords": (mesh.index("data"), mesh.index("model")),
        "model_group": mesh.all_gather(me, "model").tolist(),
        "data_group": mesh.all_gather(me, "data").tolist(),
        "local_data_rows": pdist.local_data_rows(mesh),
        "wave_rows": pdist.gather_wave_rows(mesh, rows).numpy(),
        "objects": pdist.all_gather_object({"rank": rank}),
        "records": records,
    }


def cp_attention(rank: int, world: int, q, k, v, groups: int) -> np.ndarray:
    """This rank's sequence shard of q, k, v (B, S, H, D) through
    ``cp_attention_grouped`` over a (1, world) mesh."""
    from diffuman4d_torch.ops.context_parallel import cp_attention_grouped
    from diffuman4d_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, model=world)
    s = q.shape[1] // world
    part = slice(rank * s, (rank + 1) * s)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(x[:, part])) for x in (q, k, v))
    return cp_attention_grouped(q, k, v, mesh, groups=groups).numpy()


def shard_attention(rank: int, world: int, q, k, v) -> np.ndarray:
    """Whole q, k, v through ``shard_attention_over_mesh`` over a (1,
    world) mesh: every rank returns the whole output."""
    from diffuman4d_torch.ops.context_parallel import shard_attention_over_mesh
    from diffuman4d_torch.parallel.mesh import make_mesh

    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    return shard_attention_over_mesh(make_mesh(data=1, model=world), q, k, v).numpy()


def cp_unet(rank: int, world: int, cfg_kw: dict, state: dict, x, t, tem, pf,
            num_frames: int) -> dict:
    """The whole batch's UNet forward through ``make_cp_unet_apply`` over a
    (1, world) mesh, with the K/V all-gathers it made."""
    from diffuman4d_torch.models.unet import UNetConfig, UNetMultiviewCondition
    from diffuman4d_torch.ops import context_parallel as cpa
    from diffuman4d_torch.parallel.cp_unet import make_cp_unet_apply
    from diffuman4d_torch.parallel.mesh import make_mesh

    unet = UNetMultiviewCondition(UNetConfig(**cfg_kw)).float().eval()
    unet.load_state_dict({n: torch.from_numpy(a) for n, a in state.items()})
    fn = make_cp_unet_apply(unet, make_mesh(data=1, model=world))
    cpa.cp_attention_grouped.all_gathers = 0
    with torch.no_grad():
        out = fn(*(torch.from_numpy(a) for a in (x, t, tem)), num_frames,
                 pose_features=None if pf is None else torch.from_numpy(pf))
    return {"out": out.numpy(), "all_gathers": cpa.cp_attention_grouped.all_gathers}


def scene_dir(root: Path) -> str:
    """The wave tests' synthetic scene under ``root``, made once."""
    from diffuman4d_torch.data import make_synthetic_scene

    d = root / "scene"
    if not d.is_dir():
        make_synthetic_scene(str(d), "scene0", **SCENE)
    return str(d)
