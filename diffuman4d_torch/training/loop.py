"""The training loop: steps, checkpointing, metrics (counterpart of
``diffuman4d_tpu/training/loop.py``).

Alternating spatial / temporal window batches from :class:`WindowBatcher`,
the train step of :mod:`trainer`, checkpoints every ``checkpoint_every``
steps and a JSONL metrics log. A checkpoint is two ``torch.save`` files:
``ckpt_<step>.pt`` holds the inference weights (the EMA when enabled) as a
state dict in the diffusers key names, ``state_<step>.pt`` the full train
state (fp32 master parameters, the optimiser's state -- AdamW's moments or
Adafactor's factored second moment -- and count, step, EMA). A
run started in a directory that has ``state_*`` files resumes from the
newest. Each step seeds its data draw and its noise from ``(seed, step)``,
so a resumed run repeats an uninterrupted one exactly.

With a ``mesh`` (``parallel/mesh.py``, one process per card) every rank
makes the same raw global batch and encodes only its data row's windows,
with their rows of the global posterior noise; the train step shards the
state over the model axis (``trainer.py``). The checkpoint files hold
whole tensors: the shards are gathered, rank 0 writes, and every rank
meets at a barrier before the next step. So a state written on one mesh
shape resumes on any other, and the single-card loop reads it unchanged
(``ROADMAP.md`` C.22).

Usage::

    python -m diffuman4d_torch.training.loop data_dir=<scene tree> \\
        scene_label=<scene> steps=1000 batch_size=2 [model_dir=<diffusers dir>]

The model comes from ``sampling/loader.py::load_pipeline``, as in the JAX
package: a diffusers-layout ``model_dir`` (default ``./models/diffuman4d``)
is loaded; without one the weights are random from ``seed`` at ``arch=full``
or ``arch=tiny``. The run is on ``cuda`` unless ``device=cpu`` is given.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import os.path as osp
import time
from dataclasses import dataclass

import numpy as np
import torch

from diffuman4d_torch.parallel.distributed import barrier
from diffuman4d_torch.parallel.mesh import Mesh
from diffuman4d_torch.training.data import encode_training_batch
from diffuman4d_torch.training.ema import HostEMA
from diffuman4d_torch.training.trainer import (
    TrainConfig,
    TrainState,
    create_train_state,
    data_rows,
    gather_train_state,
    make_train_step,
    slot_sharded,
    sync_module,
)

log = logging.getLogger(__name__)


@dataclass
class LoopConfig:
    steps: int = 1000
    batch_size: int = 1
    window_size: int = 12
    checkpoint_every: int = 500
    log_every: int = 10
    out_dir: str = "./runs/train"
    seed: int = 0
    # alternate spatial/temporal batches like the sampler's rounds
    domains: tuple[str, ...] = ("spatial", "temporal")


def _step_generator(seed: int, step: int, stream: int, device) -> torch.Generator:
    """The generator of one step's random stream (0: VAE posterior,
    1: timesteps and noise), a function of (seed, step) only."""
    mixed = int(np.random.SeedSequence([seed, step, stream]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(mixed & 0x7FFFFFFFFFFFFFFF)


def train(pipeline, batcher, loop_cfg: LoopConfig, train_cfg: TrainConfig | None = None,
          mesh: Mesh | None = None, placement: dict | None = None):
    """Run the loop on the pipeline's device. ``pipeline`` provides VAE
    encoding and the UNet module; gradients update the UNet only (the VAE
    stays frozen, as in SD fine-tuning). Under ``mesh`` every rank calls
    it, ``batch_size`` is the global batch, and ``placement`` says which
    parameters the model axis splits (``create_train_state``: by default
    ``shard_params_for_tp`` at its default ``min_size``; another placement is
    for toy widths that the default leaves whole)."""
    train_cfg = train_cfg or TrainConfig()
    os.makedirs(loop_cfg.out_dir, exist_ok=True)
    metrics_path = osp.join(loop_cfg.out_dir, "metrics.jsonl")
    unet, dev = pipeline.unet, pipeline.device
    writer = mesh is None or mesh.rank == 0
    rows = data_rows(mesh, loop_cfg.batch_size) if mesh is not None else None

    steps = {d: make_train_step(unet, pipeline.scheduler, train_cfg, d, mesh)
             for d in loop_cfg.domains}
    state = create_train_state(unet, train_cfg, mesh, placement)
    host_ema = None
    if train_cfg.ema_decay and train_cfg.ema_host:
        host_ema = HostEMA(state.params, train_cfg.ema_decay,
                           update_every=train_cfg.ema_update_every, layout=state.layout)

    # resume: restore the FULL train state from the newest state checkpoint
    latest = _latest_state(loop_cfg.out_dir)
    if latest is not None:
        _restore_state(latest, state, host_ema, dev)
        sync_module(unet, state.params, state.layout)
        log.info("resumed train state at step %d from %s", state.step, latest)
    start_step = state.step

    t0 = time.time()
    with open(metrics_path, "a") if writer else contextlib.nullcontext() as mf:
        for step_i in range(start_step, loop_cfg.steps):
            domain = loop_cfg.domains[step_i % len(loop_cfg.domains)]
            rng = np.random.default_rng([loop_cfg.seed, step_i])
            raw = batcher.make_batch(rng, loop_cfg.batch_size, domain)
            batch = encode_training_batch(
                pipeline, raw, _step_generator(loop_cfg.seed, step_i, 0, dev), rows=rows)
            if host_ema is not None:
                # the step overwrites the parameters in place: the copies
                # staged after the previous step must have landed first
                host_ema.fold()
            state, metrics = steps[domain](
                state, batch, _step_generator(loop_cfg.seed, step_i, 1, dev))
            if host_ema is not None and host_ema.should_update(step_i):
                host_ema.stage(state.params)

            if step_i % loop_cfg.log_every == 0 and writer:
                rec = {
                    "step": int(metrics["step"]),
                    "domain": domain,
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "elapsed_s": round(time.time() - t0, 1),
                }
                mf.write(json.dumps(rec) + "\n")
                mf.flush()
                log.info("train %s", rec)

            if (step_i + 1) % loop_cfg.checkpoint_every == 0 or step_i == loop_cfg.steps - 1:
                if host_ema is not None:
                    host_ema.fold()  # include this step's staged params
                n = state.step
                tree = _state_to_tree(state, host_ema)  # whole tensors (a collective)
                if writer:
                    # inference-ready weights (EMA when enabled, like SD releases)
                    infer = tree.get("ema_params", tree["params"])
                    _save(osp.join(loop_cfg.out_dir, f"ckpt_{n:07d}.pt"), {"unet": infer})
                    _save(osp.join(loop_cfg.out_dir, f"state_{n:07d}.pt"), tree)
                    log.info("checkpoint written at step %d", n)
                del tree
                barrier()  # no rank reads the directory before rank 0 has written
    if host_ema is not None:
        host_ema.fold()
    return state


def _save(path: str, tree: dict) -> None:
    """Write atomically: a reader (or a resume after a kill) never sees a
    half-written file."""
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def _state_to_tree(state: TrainState, host_ema: HostEMA | None = None) -> dict:
    """The state as whole tensors (a collective under a mesh)."""
    tree = gather_train_state(state)
    if host_ema is not None:
        tree["ema_params"] = host_ema.materialize(whole=True)
    return tree


def _latest_state(out_dir: str):
    if not osp.isdir(out_dir):
        return None
    cands = sorted(f for f in os.listdir(out_dir)
                   if f.startswith("state_") and f.endswith(".pt"))
    return osp.join(out_dir, cands[-1]) if cands else None


def _restore_state(path: str, state: TrainState, host_ema: HostEMA | None, device) -> None:
    """Load a state checkpoint (whole tensors) into ``state`` (and the host
    EMA) in place, keeping this rank's slices under the state's layout. A
    checkpoint written before EMA was enabled has no ``ema_params``: the
    shadow is then seeded from the restored parameters."""
    tree = torch.load(path, map_location=device, weights_only=True)
    layout = state.layout

    def take(slot: str, name: str, x: torch.Tensor) -> torch.Tensor:
        return layout.shard(name, x) if slot_sharded(layout, slot, name) else x

    if set(tree["params"]) != set(state.params):
        raise KeyError(f"{path}: parameter names do not match the model")
    for k, p in state.params.items():
        p.copy_(take("params", k, tree["params"][k]))
    saved = tree["opt_state"]
    if set(saved) != set(state.opt_state):
        raise KeyError(f"{path}: optimiser state {sorted(saved)}, this run's optimiser keeps "
                       f"{sorted(state.opt_state)}")
    for slot, tensors in state.opt_state.items():
        if slot == "count":
            continue
        if set(saved[slot]) != set(tensors):
            raise KeyError(f"{path}: optimiser state {slot!r} holds other parameters")
        for k, m in tensors.items():
            x = take(slot, k, saved[slot][k])
            if x.shape != m.shape:
                raise ValueError(f"{path}: {slot}[{k!r}] is {tuple(saved[slot][k].shape)}, "
                                 f"expected this rank's {tuple(m.shape)}")
            m.copy_(x)
    state.opt_state["count"] = int(saved["count"])
    state.step = int(tree["step"])
    ema = tree.get("ema_params")
    if ema is None and (host_ema is not None or state.ema_params is not None):
        log.info("state checkpoint %s lacks ema_params: seeding the EMA shadow from the "
                 "restored params", path)
        ema = tree["params"]
    if host_ema is not None:
        host_ema.load({k: ema[k] for k in host_ema.names})
    elif state.ema_params is not None:
        for k, e in state.ema_params.items():
            e.copy_(take("ema", k, ema[k]))


def main(argv=None) -> int:
    import sys

    from diffuman4d_torch.configs.presets import DataConfig, ModelConfig, SamplerConfig
    from diffuman4d_torch.data.dataset import SpaTemDataset
    from diffuman4d_torch.sampling.loader import load_pipeline
    from diffuman4d_torch.training.data import WindowBatcher, WindowBatcherConfig

    logging.basicConfig(level=logging.INFO)
    kv = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    data_cfg = DataConfig(
        data_dir=kv.get("data_dir", "./data"),
        scene_label=kv.get("scene_label", ""),
        height=int(kv.get("height", 1024)),
        width=int(kv.get("width", 1024)),
    )
    if data_cfg.height != data_cfg.width:
        raise ValueError("the pipeline takes square images")
    model_cfg = ModelConfig(
        model_dir=kv.get("model_dir", "./models/diffuman4d"),
        arch=kv.get("arch", "full"),
        dtype=kv.get("dtype", "bf16"),
    )
    dataset = SpaTemDataset(
        data_dir=data_cfg.data_dir,
        scene_label=data_cfg.scene_label,
        height=data_cfg.height,
        width=data_cfg.width,
    )
    loop_cfg = LoopConfig(
        steps=int(kv.get("steps", 1000)),
        batch_size=int(kv.get("batch_size", 1)),
        window_size=int(kv.get("window_size", 12)),
        out_dir=kv.get("out_dir", "./runs/train"),
        seed=int(kv.get("seed", 0)),
    )
    pipeline = load_pipeline(model_cfg, SamplerConfig(seed=loop_cfg.seed), data_cfg,
                             device=kv.get("device", "cuda"))
    images = osp.join(dataset.data_dir, dataset.scene_label, "images")
    batcher = WindowBatcher(
        dataset,
        WindowBatcherConfig(
            window_size=loop_cfg.window_size,
            tem_labels=sorted({f.split(".")[0] for d in os.listdir(images)
                               for f in os.listdir(osp.join(images, d))}),
            input_spa_labels=kv.get("input_spa_labels", "01,13,25,37").split(","),
        ),
    )
    train(pipeline, batcher, loop_cfg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
