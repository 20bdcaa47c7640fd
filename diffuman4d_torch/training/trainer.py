"""Training: denoising-loss train step for the spatio-temporal UNet
(counterpart of ``diffuman4d_tpu/training/trainer.py``).

Objective: diffusion noise (or velocity) prediction on window sequences. A
batch element is one window (inputs + targets, as in inference):

* one timestep per element, shared by its target frames;
* conditional rows are fed clean latents at ``t = 0`` (cond-row replacement);
* the loss is the MSE over target rows only.

Precision follows flax's fp32-parameters / cast-at-use scheme: the train
state owns fp32 master parameters and the optimiser moments; the UNet module
holds a working copy in its compute dtype (bf16 in production) that is
refreshed from the masters after every step, and the working copy's
gradients are taken to fp32 before clipping and the update. The optimiser
restates ``optax.chain(clip_by_global_norm, adamw)``: weight decay applies to
every parameter, eps is 1e-8 outside the square root, the learning-rate
schedule is read at the count before the step. The step updates the state
and the module in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from diffuman4d_torch.models.unet import UNetMultiviewCondition
from diffuman4d_torch.schedulers.diffusion import Scheduler


@dataclass
class TrainConfig:
    """Same fields and defaults as the JAX package's ``TrainConfig``."""

    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: float = 1.0
    prediction_type: str = "epsilon"  # epsilon | v_prediction
    remat: bool = True  # recompute each UNet block in the backward pass
    optimizer: str = "adamw"  # adamw (adafactor is not ported yet)
    lr_schedule: str = "constant"  # constant | cosine (linear warm-up in both)
    warmup_steps: int = 0
    total_steps: int = 100_000  # cosine horizon
    # exponential moving average of the parameters; 0 disables. The shadow is
    # fp32 only: at decay 0.999 the per-step change 0.001 * (p - e) lies far
    # below a bf16 shadow's resolution, so a low-precision EMA would freeze.
    ema_decay: float = 0.0
    # keep the fp32 shadow in host memory (training.ema.HostEMA); the device
    # train step then carries no EMA state
    ema_host: bool = False
    # host EMA: stage / fold every k-th step with the decay raised to k
    ema_update_every: int = 1
    # attention implementation of the training forward / backward: "train"
    # is the differentiable kernel family (ops/flash_backward.py); None keeps
    # the UNet module's own setting
    attn_implementation: str | None = "train"


class TrainState:
    """fp32 master parameters, AdamW moments, step and optional device EMA,
    all dicts keyed by the UNet's parameter names."""

    def __init__(self, params, opt_state, step=0, ema_params=None):
        self.params = params
        self.opt_state = opt_state  # {"count": int, "mu": {...}, "nu": {...}}
        self.step = step
        self.ema_params = ema_params


def make_lr_schedule(cfg: TrainConfig):
    """count -> learning rate (``optax.linear_schedule`` /
    ``optax.warmup_cosine_decay_schedule`` with init 0 and end 0)."""
    lr = cfg.learning_rate

    def warmup(count: int, steps: int) -> float:
        return lr * min(count, steps) / steps

    if cfg.lr_schedule == "constant":
        if cfg.warmup_steps:
            return lambda count: warmup(count, cfg.warmup_steps)
        return lambda count: lr
    if cfg.lr_schedule == "cosine":
        w = max(cfg.warmup_steps, 1)
        decay_steps = cfg.total_steps - w
        if not decay_steps > 0:
            raise ValueError(f"cosine schedule needs total_steps > warmup_steps, got "
                             f"{cfg.total_steps} and {w}")

        def schedule(count: int) -> float:
            if count < w:
                return warmup(count, w)
            c = min(count - w, decay_steps)
            return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))

        return schedule
    raise ValueError(f"unknown lr_schedule: {cfg.lr_schedule}")


class Optimizer:
    """Global-norm clip, then AdamW (the chain of the JAX package's
    ``make_optimizer``), on dicts of fp32 tensors, in place."""

    def __init__(self, cfg: TrainConfig):
        if cfg.optimizer == "adafactor":
            raise NotImplementedError("the adafactor optimiser is not ported yet (adamw is)")
        if cfg.optimizer != "adamw":
            raise ValueError(cfg.optimizer)
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: dict, opt_state: dict, params: dict) -> torch.Tensor:
        """One step on ``params`` and ``opt_state``; ``grads`` (fp32) is
        consumed. Returns the gradients' global norm before clipping."""
        cfg = self.cfg
        g_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        clip = torch.where(g_norm < cfg.grad_clip, torch.ones_like(g_norm),
                           cfg.grad_clip / g_norm)
        lr = self.schedule(opt_state["count"])
        count = opt_state["count"] = opt_state["count"] + 1
        c1, c2 = 1.0 - cfg.b1 ** count, 1.0 - cfg.b2 ** count
        for name, p in params.items():
            g = grads[name] * clip
            mu = opt_state["mu"][name].mul_(cfg.b1).add_(g, alpha=1.0 - cfg.b1)
            nu = opt_state["nu"][name].mul_(cfg.b2).addcmul_(g, g, value=1.0 - cfg.b2)
            update = (mu / c1) / ((nu / c2).sqrt_() + 1e-8)
            if cfg.weight_decay:
                update.add_(p, alpha=cfg.weight_decay)
            p.add_(update, alpha=-lr)
        return g_norm


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)


def create_train_state(unet: UNetMultiviewCondition, cfg: TrainConfig) -> TrainState:
    """fp32 masters copied from the module's parameters, zero moments, and
    a device EMA shadow when ``ema_decay`` is set and ``ema_host`` is not."""
    params = {k: p.detach().float().clone() for k, p in unet.named_parameters()}
    ema = ({k: p.clone() for k, p in params.items()}
           if cfg.ema_decay and not cfg.ema_host else None)
    return TrainState(params, make_optimizer(cfg).init(params), 0, ema)


def sync_module(unet: UNetMultiviewCondition, params: dict) -> None:
    """Refresh the module's working copy from the fp32 masters."""
    with torch.no_grad():
        for k, p in unet.named_parameters():
            p.copy_(params[k])


def diffusion_loss(
    unet: UNetMultiviewCondition,
    scheduler: Scheduler,
    cfg: TrainConfig,
    batch: dict,
    domain: str,
    generator: torch.Generator | None = None,
    t: torch.Tensor | None = None,
    eps: torch.Tensor | None = None,
) -> torch.Tensor:
    """One forward + loss on a batch of windows, through the module's
    current parameters.

    batch:
      latents_x0     (B, L, h, w, C)  clean VAE latents
      plucker        (B, L, h, w, 6)
      skeletons      (B, L, H, W, 3)  full-res (pose-encoder path)
      is_cond        (B, L) bool
    The timesteps ``t`` (B,) and the noise ``eps`` (like ``latents_x0``,
    fp32) are drawn from ``generator`` unless given.
    """
    x0 = batch["latents_x0"].float()
    B, L, h, w, c = x0.shape
    dev = x0.device
    cond_flat = batch["is_cond"].reshape(-1)
    if t is None or eps is None:
        if generator is None:
            raise ValueError("diffusion_loss needs a generator, or t and eps")
        t = torch.randint(0, scheduler.config.num_train_timesteps, (B,), generator=generator,
                          device=generator.device)
        eps = torch.randn(x0.shape, generator=generator, device=generator.device)
    t_frames = t.to(dev).long().repeat_interleave(L)  # (B*L,)
    t_frames = torch.where(cond_flat, torch.zeros_like(t_frames), t_frames)

    x_flat = x0.reshape(B * L, h, w, c)
    eps_flat = eps.to(dev, torch.float32).reshape(B * L, h, w, c)
    x_t = scheduler.add_noise(x_flat, eps_flat, t_frames)
    sel = cond_flat[:, None, None, None]
    x_t = torch.where(sel, x_flat, x_t)  # conditional rows: clean latents

    dtype = unet.dtype
    mask_plane = (~cond_flat).to(dtype)[:, None, None, None].expand(B * L, h, w, 1)
    plucker = batch["plucker"].reshape(B * L, h, w, -1).to(dtype)
    net_in = torch.cat([x_t.to(dtype), plucker, mask_plane], dim=-1)

    if domain == "temporal":
        tem = torch.arange(L // 2, dtype=torch.int32, device=dev).repeat(2 * B)
    else:
        tem = torch.zeros((B * L,), dtype=torch.int32, device=dev)
    skel = batch["skeletons"].to(dtype)
    skel = skel.reshape((B * L,) + tuple(skel.shape[2:]))

    with unet.configured(remat=cfg.remat or unet.remat):
        pred = unet(net_in, t_frames, skeletons=skel, tem_indices=tem, num_frames=L).float()

    if cfg.prediction_type == "epsilon":
        target = eps_flat
    elif cfg.prediction_type == "v_prediction":
        target = scheduler.velocity(x_flat, eps_flat, t_frames)
    else:
        raise ValueError(cfg.prediction_type)

    weight = (~cond_flat).float()[:, None, None, None]  # target rows only
    se = (pred - target) ** 2 * weight
    return se.sum() / (weight.sum() * h * w * c)


def make_train_step(unet: UNetMultiviewCondition, scheduler: Scheduler, cfg: TrainConfig,
                    domain: str = "spatial"):
    """Returns ``train_step(state, batch, generator=None, t=None, eps=None)
    -> (state, metrics)``. ``state`` and the module's working copy are
    updated in place; ``metrics`` holds device scalars (``loss``,
    ``grad_norm``), the new ``step`` and the names of parameters the loss
    did not reach (``params_without_grad``; they are stepped with zeros)."""
    opt = make_optimizer(cfg)

    def train_step(state: TrainState, batch: dict, generator=None, t=None, eps=None):
        params = dict(unet.named_parameters())
        for p in params.values():
            p.grad = None
        with unet.configured(attn_implementation=cfg.attn_implementation):
            loss = diffusion_loss(unet, scheduler, cfg, batch, domain, generator, t, eps)
            loss.backward()
        grads, off_graph = {}, []
        for k, p in params.items():  # fp32 gradients; a parameter off the graph gets zeros
            if p.grad is None:
                off_graph.append(k)
            grads[k] = torch.zeros_like(state.params[k]) if p.grad is None else p.grad.float()
            p.grad = None
        g_norm = opt.update(grads, state.opt_state, state.params)
        del grads
        sync_module(unet, state.params)
        if state.ema_params is not None:
            d = cfg.ema_decay
            with torch.no_grad():
                for k, e in state.ema_params.items():
                    e.mul_(d).add_(state.params[k], alpha=1.0 - d)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": g_norm, "step": state.step,
                       "params_without_grad": off_graph}

    return train_step
