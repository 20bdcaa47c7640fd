"""Rank functions of the port's multi-process tests
(``tests/test_torch_port_{distributed,cp,waves,dryrun}.py`` and ``test_torch_port_dp_*.py``).

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


def train_steps(rank: int, world: int, data: int, model: int, cfg_kw: dict, state: dict,
                tcfg_kw: dict, domain: str, batches: list, draws: list,
                min_size: int = 2**16) -> dict:
    """Train steps of the UNet ``cfg_kw`` (fp32, weights ``state``) on a
    (data, model) mesh: each global batch's data row through the mesh's
    ``make_train_step``, with the global draws ``(t, eps)``. Returns the
    metrics, the placement, this rank's shapes of every state tensor, the
    state gathered to whole tensors (rank 0 only) and whether the module's
    working copy equals the whole masters."""
    from diffuman4d_torch.models.unet import UNetConfig, UNetMultiviewCondition
    from diffuman4d_torch.parallel.mesh import make_mesh, shard_params_for_tp
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.training import trainer as pt

    unet = UNetMultiviewCondition(UNetConfig(**cfg_kw)).float()
    unet.load_state_dict({n: torch.from_numpy(a) for n, a in state.items()})
    mesh = make_mesh(data=data, model=model)
    placement = shard_params_for_tp(dict(unet.named_parameters()), mesh, min_size)
    tcfg = pt.TrainConfig(**tcfg_kw)
    st = pt.create_train_state(unet, tcfg, mesh, placement)
    step = pt.make_train_step(unet, Scheduler(SchedulerConfig()), tcfg, domain, mesh)
    metrics = []
    for batch, (t, eps) in zip(batches, draws):
        rows = pt.data_rows(mesh, t.shape[0])
        local = {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in batch.items()}
        st, m = step(st, local, t=torch.from_numpy(t), eps=torch.from_numpy(eps))
        metrics.append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                        "step": m["step"], "state_bytes": m["state_bytes"]})
    whole = pt.gather_train_state(st)
    to_np = lambda tree: {k: v.detach().numpy().copy() for k, v in tree.items()}  # noqa: E731
    shapes = {"params": {k: tuple(p.shape) for k, p in st.params.items()},
              **{slot: {k: tuple(x.shape) for k, x in v.items()}
                 for slot, v in st.opt_state.items() if slot != "count"}}
    out = {"metrics": metrics, "placement": placement, "shapes": shapes,
           "module_is_masters": all(torch.equal(p, whole["params"][k])
                                    for k, p in unet.named_parameters())}
    if rank == 0:
        out["state"] = {"params": to_np(whole["params"]), "count": whole["opt_state"]["count"],
                        **{slot: to_np(v) for slot, v in whole["opt_state"].items()
                           if slot != "count"}}
        if "ema_params" in whole:
            out["state"]["ema"] = to_np(whole["ema_params"])
    return out


def optimizer_shards(rank: int, world: int, model: int, params: dict, grads: list,
                     tcfg_kw: dict) -> dict:
    """The port's ``Optimizer`` on this rank's slices of ``params`` (every
    2-D+ entry placed on ``model`` at min_size 1) for the whole gradients
    ``grads`` of each step; returns the whole parameters and state after
    the steps, this rank's shapes and its factored dims."""
    from diffuman4d_torch.parallel.mesh import ShardLayout, make_mesh, shard_params_for_tp
    from diffuman4d_torch.training import trainer as pt

    mesh = make_mesh(data=world // model, model=model)
    whole = {k: torch.from_numpy(v) for k, v in params.items()}
    placement = shard_params_for_tp(whole, mesh, min_size=1)
    layout = ShardLayout(placement, {k: v.shape for k, v in whole.items()}, mesh)
    mine = {k: layout.shard(k, v).clone() for k, v in whole.items()}
    opt = pt.make_optimizer(pt.TrainConfig(**tcfg_kw))
    opt_state = opt.init(mine, layout)
    for g in grads:
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, opt_state, mine, layout)
    st = pt.TrainState(mine, opt_state, len(grads), None, layout)
    gathered = pt.gather_train_state(st)
    return {"params": {k: v.numpy().copy() for k, v in gathered["params"].items()},
            "opt_state": {slot: {k: v.numpy().copy() for k, v in tree.items()}
                          for slot, tree in gathered["opt_state"].items() if slot != "count"},
            "shapes": {"params": {k: tuple(v.shape) for k, v in mine.items()},
                       **{slot: {k: tuple(v.shape) for k, v in tree.items()}
                          for slot, tree in opt_state.items() if slot != "count"}},
            "factored": {k: pt.factored_dims(layout.shapes[k]) for k in mine}}


# the loop tests' model: two stages, the inner one with 3D attention, at
# toy widths (tests/test_torch_port_training.py's loop setup)
SMALL_UNET = dict(in_channels=11, block_out_channels=(8, 16), num_attention_heads=(1, 2),
                  layers_per_block=1, norm_num_groups=4, num_3d_attn_blocks=1)


def small_models():
    """The loop tests' (unet, vae): random fp32 weights from seed 0, the
    UNet's perturbed (0.2 x normal noise from seed 1 on every tensor) so
    that no zero-initialised head starts at zero."""
    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.sampling.loader import build_models

    unet, vae = build_models(UNetConfig(**SMALL_UNET), VAEConfig(**TINY_VAE), device="cpu",
                             dtype=torch.float32, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.2)
    return unet, vae


def loop_setup(scene: str):
    """(pipeline, batcher) of the loop tests: random fp32 weights from seed
    0 (the same in every process), the 64^2 scene, window 2."""
    from diffuman4d_torch.data import SpaTemDataset
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.training.data import WindowBatcher, WindowBatcherConfig

    unet, vae = small_models()
    pipe = Diffuman4DPipeline(unet, vae, Scheduler(SchedulerConfig()), image_size=64,
                              device="cpu")
    dataset = SpaTemDataset(data_dir=scene, scene_label="scene0", height=64, width=64)
    batcher = WindowBatcher(dataset, WindowBatcherConfig(
        window_size=2, tem_labels=["000000", "000001"], input_spa_labels=["00", "03"]))
    return pipe, batcher


def loop_run(rank: int, world: int, data: int | None, model: int, scene: str, out: str,
             steps: int, tcfg_kw: dict, min_size: int = 2**8) -> list:
    """``training.loop.train`` to ``steps`` in ``out`` (global batch 2,
    checkpoints every 2 steps) on a (data, model) mesh, or without one when
    ``data`` is None; returns the metrics rank 0 logged."""
    import json
    import os.path as osp

    from diffuman4d_torch.parallel.mesh import make_mesh, shard_params_for_tp
    from diffuman4d_torch.training.loop import LoopConfig, train
    from diffuman4d_torch.training.trainer import TrainConfig

    pipe, batcher = loop_setup(scene)
    mesh = placement = None
    if data is not None:
        mesh = make_mesh(data=data, model=model)
        placement = shard_params_for_tp(dict(pipe.unet.named_parameters()), mesh, min_size)
    lcfg = LoopConfig(steps=steps, batch_size=2, window_size=2, checkpoint_every=2, log_every=1,
                      out_dir=out, seed=5)
    train(pipe, batcher, lcfg, TrainConfig(**tcfg_kw), mesh=mesh, placement=placement)
    path = osp.join(out, "metrics.jsonl")
    if rank != 0 or not osp.isfile(path):
        return []
    with open(path) as f:
        return [json.loads(x) for x in f.read().splitlines()]


def scene_dir(root: Path) -> str:
    """The wave tests' synthetic scene under ``root``, made once."""
    from diffuman4d_torch.data import make_synthetic_scene

    d = root / "scene"
    if not d.is_dir():
        make_synthetic_scene(str(d), "scene0", **SCENE)
    return str(d)
