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
restates ``optax.chain(clip_by_global_norm, adamw)`` or
``optax.chain(clip_by_global_norm, adafactor)`` at optax 0.2.6's defaults:
the learning-rate schedule is read at the count before the step, and
weight decay applies to every parameter. The step updates the state and the
module in place.

Parallelism (the JAX step under ``pjit`` over a ``("data", "model")`` mesh,
one process per card here, ``parallel/mesh.py``):

* ``data`` -- each data row trains on its ``B / data`` rows of the global
  batch; the loss is the global batch's (its denominator counts every
  row's targets), the gradients are summed over the data group in one
  flattened all-reduce, and the timesteps and noise are the global draw's
  rows, so a step does not depend on the mesh's shape.
* ``model`` -- the parameters that ``shard_params_for_tp`` places are held
  as ``1/model`` slices in the train state: fp32 masters, AdamW's moments,
  Adafactor's full second moment and the factored statistic that keeps
  dim 0, and a device EMA. The module's working copy stays whole on every
  rank and is rebuilt after each update by an all-gather over the model
  group; the model ranks of a data row see the same rows, so their
  gradients are whole and equal, and each updates its slice
  (``ROADMAP.md`` C.21). Adafactor's statistics over a sharded axis (the
  row normaliser's mean, the rms of the update and of the parameter) are
  summed over the model group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from diffuman4d_torch.models.unet import UNetMultiviewCondition
from diffuman4d_torch.parallel.mesh import Mesh, ShardLayout, shard_params_for_tp
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
    optimizer: str = "adamw"  # adamw | adafactor (factored second moment: O(rows + cols))
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
    """fp32 master parameters, optimiser state, step and optional device
    EMA, all dicts keyed by the UNet's parameter names. Under a mesh,
    ``layout`` says which of them this rank holds as slices."""

    def __init__(self, params, opt_state, step=0, ema_params=None,
                 layout: ShardLayout | None = None):
        self.params = params
        # {"count": int, "mu": {...}, "nu": {...}} (AdamW) or
        # {"count": int, "v_row": {...}, "v_col": {...}, "v": {...}} (Adafactor)
        self.opt_state = opt_state
        self.step = step
        self.ema_params = ema_params
        self.layout = layout

    def nbytes(self) -> dict:
        """Bytes this rank holds of masters, optimiser moments and device EMA."""
        def size(tree):
            return sum(x.numel() * x.element_size() for x in tree.values())

        moments = sum(size(v) for k, v in self.opt_state.items() if k != "count")
        return {"masters": size(self.params), "moments": moments,
                "ema": size(self.ema_params) if self.ema_params is not None else 0}


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


# optax.adafactor's defaults (optax 0.2.6, ``alias.py`` / ``factorized.py``)
ADAFACTOR_MIN_DIM_TO_FACTOR = 128
ADAFACTOR_DECAY_EXPONENT = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP_RMS = 1.0
ADAFACTOR_MIN_PARAM_RMS = 1e-3


def factored_dims(shape) -> tuple[int, int] | None:
    """optax's ``_factored_dims``: the axes ``(d1, d0)`` of the second
    largest and the largest dim when the second largest is at least 128,
    else None (a full second moment). In torch layouts the two axes are
    the flax layout's, possibly in the other order; the factored estimate
    is symmetric in them."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def slot_sharded(layout: ShardLayout | None, slot: str, name: str) -> bool:
    """Whether optimiser slot ``slot`` of parameter ``name`` is held as a
    slice along dim 0: AdamW's moments and Adafactor's full second moment
    where the parameter is; of the factored pair, the statistic that
    keeps dim 0 (``v_row`` averages over the largest dim d0, ``v_col`` over
    the second largest d1; the other one is whole on every rank)."""
    if layout is None or not layout.sharded(name):
        return False
    if slot not in ("v_row", "v_col"):
        return True
    d1, d0 = factored_dims(layout.shapes[name])
    return (d0 if slot == "v_row" else d1) != 0


class Optimizer:
    """Global-norm clip, then AdamW or Adafactor (the chains of the JAX
    package's ``make_optimizer``), on dicts of fp32 tensors, in place.

    AdamW: eps 1e-8 outside the square root, decoupled weight decay scaled
    by the learning rate. Adafactor (``optax.adafactor(schedule,
    weight_decay_rate=weight_decay or None)``): a second moment factored
    into row and column means for parameters whose two largest dims are
    >= 128, else kept whole, decaying at ``1 - (count + 1)^-0.8``; each
    parameter's update clipped to rms 1, scaled by the learning rate and
    by ``max(rms(p), 1e-3)``; then ``weight_decay * p`` added (after the
    learning rate, as optax adds it) and the sign flipped."""

    def __init__(self, cfg: TrainConfig):
        if cfg.optimizer not in ("adamw", "adafactor"):
            raise ValueError(cfg.optimizer)
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)

    def init(self, params: dict, layout: ShardLayout | None = None) -> dict:
        """Zero state for ``params`` (this rank's slices under ``layout``;
        Adafactor factors by the whole tensor's shape)."""
        if self.cfg.optimizer == "adamw":
            return {"count": 0,
                    "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                    "nu": {k: torch.zeros_like(p) for k, p in params.items()}}
        state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
        for k, p in params.items():
            shape = layout.shapes[k] if layout is not None else tuple(p.shape)
            dims = factored_dims(shape)
            if dims is None:
                state["v"][k] = torch.zeros_like(p)
                continue
            d1, d0 = dims
            for slot, d in (("v_row", d0), ("v_col", d1)):
                s = list(shape[:d] + shape[d + 1:])
                if slot_sharded(layout, slot, k):
                    s[0] //= layout.model
                state[slot][k] = p.new_zeros(s)
        return state

    @torch.no_grad()
    def update(self, grads: dict, opt_state: dict, params: dict,
               layout: ShardLayout | None = None) -> torch.Tensor:
        """One step on ``params`` and ``opt_state``; ``grads`` (fp32, whole
        tensors) is consumed. Under ``layout`` the sharded parameters and
        their state are this rank's slices. Returns the gradients' global
        norm before clipping."""
        cfg = self.cfg
        g_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        clip = torch.where(g_norm < cfg.grad_clip, torch.ones_like(g_norm),
                           cfg.grad_clip / g_norm)
        lr = self.schedule(opt_state["count"])
        count = opt_state["count"] = opt_state["count"] + 1
        shard = layout.shard if layout is not None else (lambda name, x: x)
        if cfg.optimizer == "adamw":
            c1, c2 = 1.0 - cfg.b1 ** count, 1.0 - cfg.b2 ** count
            for name, p in params.items():
                g = shard(name, grads[name]) * clip
                mu = opt_state["mu"][name].mul_(cfg.b1).add_(g, alpha=1.0 - cfg.b1)
                nu = opt_state["nu"][name].mul_(cfg.b2).addcmul_(g, g, value=1.0 - cfg.b2)
                update = (mu / c1) / ((nu / c2).sqrt_() + 1e-8)
                if cfg.weight_decay:
                    update.add_(p, alpha=cfg.weight_decay)
                p.add_(update, alpha=-lr)
            return g_norm
        # Adafactor: the second moment decays at 1 - (t + 1)^-0.8, t the count
        # before this step
        self._adafactor(grads, clip, opt_state, params, layout, lr,
                        1.0 - count ** -ADAFACTOR_DECAY_EXPONENT)
        return g_norm

    def _adafactor(self, grads: dict, clip: torch.Tensor, opt_state: dict, params: dict,
                   layout: ShardLayout | None, lr: float, decay: float) -> None:
        """Adafactor as optax computes it on the whole arrays, for whole
        tensors and for this rank's slices alike: the factoring follows the
        whole shape and the statistics come from the whole gradient (scaled
        in place by ``clip``). The sums that span a sharded dim -- the row
        normaliser where ``v_row`` keeps dim 0 and averages over it, and the
        sums of squares of the update and of the parameter -- are completed
        over the model group in two flattened all-reduces."""
        shapes = layout.shapes if layout is not None else {k: tuple(p.shape)
                                                            for k, p in params.items()}
        shard = layout.shard if layout is not None else (lambda name, x: x)
        row_sums, dirs = {}, {}
        for name in params:  # the second moments, and the row normaliser's partial sums
            g = grads[name].mul_(clip)
            g2 = g.square().add_(ADAFACTOR_EPS)
            dims = factored_dims(shapes[name])
            if dims is None:
                v = opt_state["v"][name].mul_(decay).add_(shard(name, g2), alpha=1.0 - decay)
                dirs[name] = shard(name, g).mul_(v.rsqrt())
                continue
            d1, d0 = dims
            for slot, d in (("v_row", d0), ("v_col", d1)):
                new = g2.mean(d)
                opt_state[slot][name].mul_(decay).add_(
                    shard(name, new) if slot_sharded(layout, slot, name) else new,
                    alpha=1.0 - decay)
            # v_row's mean over d1, which is v_row's dim d1 - (d1 > d0)
            row_sums[name] = opt_state["v_row"][name].sum(d1 - (d1 > d0), keepdim=True)
            dirs[name] = g
        # a sum over v_row's dim 0 spans the shards where v_row keeps dim 0
        # (d0 != 0) and d1 is dim 0
        _sum_over_model(layout, row_sums, [k for k in row_sums if slot_sharded(layout, "v_row", k)
                                           and factored_dims(shapes[k])[0] == 0])
        for name, row_sum in row_sums.items():
            d1, d0 = factored_dims(shapes[name])
            row = (opt_state["v_row"][name] / (row_sum / shapes[name][d1])).rsqrt_()
            dirs[name] = shard(name, dirs[name]).mul_(row.unsqueeze(d0)).mul_(
                opt_state["v_col"][name].rsqrt().unsqueeze(d1))
        sq = {k: torch.stack([u.square().sum(), params[k].square().sum()])
              for k, u in dirs.items()}
        _sum_over_model(layout, sq, [k for k in sq if layout is not None and layout.sharded(k)])
        for name, update in dirs.items():
            u_rms, p_rms = (sq[name] / math.prod(shapes[name])).sqrt().unbind()
            update.div_(torch.clamp(u_rms / ADAFACTOR_CLIP_RMS, min=1.0))
            update.mul_(lr).mul_(torch.clamp(p_rms, min=ADAFACTOR_MIN_PARAM_RMS))
            if self.cfg.weight_decay:
                update.add_(params[name], alpha=self.cfg.weight_decay)
            params[name].sub_(update)


def _sum_over_model(layout: ShardLayout | None, sums: dict, names: list) -> None:
    """Replace the partial sums ``sums[k]`` of ``names`` by their sums over
    the model group, in one flattened all-reduce."""
    if layout is None or not names:
        return
    flat = layout.mesh.all_reduce(torch.cat([sums[k].reshape(-1) for k in names]), "model")
    for k, part in zip(names, flat.split([sums[k].numel() for k in names])):
        sums[k] = part.view_as(sums[k])


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)


def create_train_state(unet: UNetMultiviewCondition, cfg: TrainConfig, mesh: Mesh | None = None,
                       placement: dict | None = None) -> TrainState:
    """fp32 masters copied from the module's parameters, zero moments, and
    a device EMA shadow when ``ema_decay`` is set and ``ema_host`` is not.
    Under ``mesh`` the parameters of ``placement`` are held as this rank's
    ``1/model`` slices, with their moments and shadow. ``placement``
    defaults to ``shard_params_for_tp`` at its default ``min_size``; another
    placement (the rule at a lower ``min_size``) is for models too narrow
    for the default to shard anything, as in the tests."""
    named = dict(unet.named_parameters())
    layout = None
    if mesh is not None:
        if placement is None:
            placement = shard_params_for_tp(named, mesh)
        layout = ShardLayout(placement, {k: p.shape for k, p in named.items()}, mesh)
    params = {k: (layout.shard(k, p.detach().float()) if layout else p.detach().float()).clone()
              for k, p in named.items()}
    ema = ({k: p.clone() for k, p in params.items()}
           if cfg.ema_decay and not cfg.ema_host else None)
    return TrainState(params, make_optimizer(cfg).init(params, layout), 0, ema, layout)


def gather_train_state(state: TrainState) -> dict:
    """``{"params", "opt_state", "step"[, "ema_params"]}`` in whole tensors:
    under a layout the slices are all-gathered over the model group (every
    model rank calls it); without one, the state's own tensors."""
    layout = state.layout

    def whole(slot: str, tree: dict) -> dict:
        return {k: layout.gather(k, x) if slot_sharded(layout, slot, k) else x
                for k, x in tree.items()}

    tree = {"params": whole("params", state.params),
            "opt_state": {slot: v if slot == "count" else whole(slot, v)
                          for slot, v in state.opt_state.items()},
            "step": state.step}
    if state.ema_params is not None:
        tree["ema_params"] = whole("ema", state.ema_params)
    return tree


def sync_module(unet: UNetMultiviewCondition, params: dict,
                layout: ShardLayout | None = None) -> None:
    """Refresh the module's working copy from the fp32 masters. Under
    ``layout`` the sharded masters are this rank's slices: they are cast to
    the module's dtype and all-gathered over the model group in one
    flattened buffer."""
    with torch.no_grad():
        named = dict(unet.named_parameters())
        sharded = [k for k in named if layout is not None and layout.sharded(k)]
        for k, p in named.items():
            if k not in sharded:
                p.copy_(params[k])
        if not sharded:
            return
        dtype = next(iter(named.values())).dtype
        flat = torch.cat([params[k].reshape(-1).to(dtype) for k in sharded])
        whole = layout.mesh.all_gather(flat, "model", dim=0).view(layout.model, -1)
        off = 0
        for k in sharded:
            n = params[k].numel()
            # rank i's slice is rows i of dim 0: the rows in order are the whole
            named[k].copy_(whole[:, off:off + n].reshape(named[k].shape))
            off += n


def diffusion_loss(
    unet: UNetMultiviewCondition,
    scheduler: Scheduler,
    cfg: TrainConfig,
    batch: dict,
    domain: str,
    generator: torch.Generator | None = None,
    t: torch.Tensor | None = None,
    eps: torch.Tensor | None = None,
    weight_sum: torch.Tensor | None = None,
) -> torch.Tensor:
    """One forward + loss on a batch of windows, through the module's
    current parameters.

    batch:
      latents_x0     (B, L, h, w, C)  clean VAE latents
      plucker        (B, L, h, w, 6)
      skeletons      (B, L, H, W, 3)  full-res (pose-encoder path)
      is_cond        (B, L) bool
    The timesteps ``t`` (B,) and the noise ``eps`` (like ``latents_x0``,
    fp32) are drawn from ``generator`` unless given. ``weight_sum``, the
    count of target rows the loss averages over, defaults to this batch's
    (a data row's share of a global batch passes the global count).
    """
    x0 = batch["latents_x0"].float()
    B, L, h, w, c = x0.shape
    dev = x0.device
    cond_flat = batch["is_cond"].reshape(-1)
    if t is None or eps is None:
        if generator is None:
            raise ValueError("diffusion_loss needs a generator, or t and eps")
        t, eps = draw_noise(scheduler, generator, x0.shape)
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
    if weight_sum is None:
        weight_sum = weight.sum()
    return se.sum() / (weight_sum * h * w * c)


def draw_noise(scheduler: Scheduler, generator: torch.Generator, shape) -> tuple:
    """The timesteps (B,) and the noise ``shape`` = (B, L, h, w, c) that
    ``diffusion_loss`` draws from ``generator``."""
    t = torch.randint(0, scheduler.config.num_train_timesteps, tuple(shape[:1]),
                      generator=generator, device=generator.device)
    return t, torch.randn(tuple(shape), generator=generator, device=generator.device)


def data_rows(mesh: Mesh | None, batch_size: int) -> slice:
    """The rows of a global batch of ``batch_size`` that this rank's data
    row trains on: its ``batch_size / data`` consecutive rows."""
    if mesh is None:
        return slice(0, batch_size)
    data = mesh.shape["data"]
    if batch_size % data:
        raise ValueError(f"batch of {batch_size} does not divide over data={data}")
    n = batch_size // data
    return slice(mesh.index("data") * n, (mesh.index("data") + 1) * n)


def make_train_step(unet: UNetMultiviewCondition, scheduler: Scheduler, cfg: TrainConfig,
                    domain: str = "spatial", mesh: Mesh | None = None):
    """Returns ``train_step(state, batch, generator=None, t=None, eps=None)
    -> (state, metrics)``. ``state`` and the module's working copy are
    updated in place; ``metrics`` holds device scalars (``loss``,
    ``grad_norm``), the new ``step``, the names of parameters the loss
    did not reach (``params_without_grad``; they are stepped with zeros)
    and the bytes of the state on this rank (``state_bytes``).

    Under ``mesh`` (with a state made on it), ``batch`` is this rank's data
    row of the global batch (``data_rows``), while ``t`` / ``eps`` -- or the
    draw from ``generator`` -- are the global batch's, of which the step
    takes its rows; ``loss`` is the global batch's."""
    opt = make_optimizer(cfg)

    def train_step(state: TrainState, batch: dict, generator=None, t=None, eps=None):
        params = dict(unet.named_parameters())
        for p in params.values():
            p.grad = None
        b = batch["latents_x0"].shape[0]
        n_data = mesh.shape["data"] if mesh is not None else 1
        if t is None or eps is None:
            if generator is None:
                raise ValueError("the train step needs a generator, or t and eps")
            t, eps = draw_noise(scheduler, generator,
                                (b * n_data,) + tuple(batch["latents_x0"].shape[1:]))
        if t.shape[0] != b * n_data or eps.shape[0] != b * n_data:
            raise ValueError(f"t / eps of {t.shape[0]} / {eps.shape[0]} rows for {n_data} data "
                             f"rows of {b}")
        weight_sum = None
        if mesh is not None:
            rows = data_rows(mesh, b * n_data)
            t, eps = t[rows], eps[rows]
            weight_sum = mesh.all_reduce((~batch["is_cond"]).sum().float(), "data")
        with unet.configured(attn_implementation=cfg.attn_implementation):
            loss = diffusion_loss(unet, scheduler, cfg, batch, domain, t=t, eps=eps,
                                  weight_sum=weight_sum)
            loss.backward()
        # fp32 gradients in one flat buffer (a parameter off the graph gets
        # zeros), summed over the data group in one all-reduce
        numels = [p.numel() for p in params.values()]
        flat = torch.zeros(sum(numels), dtype=torch.float32, device=loss.device)
        off_graph = []
        for (k, p), view in zip(params.items(), flat.split(numels)):
            if p.grad is None:
                off_graph.append(k)
            else:
                view.copy_(p.grad.reshape(-1))
            p.grad = None
        loss = loss.detach()
        if mesh is not None:
            mesh.all_reduce(flat, "data")
            mesh.all_reduce(loss, "data")
        grads = {k: v.view(p.shape) for (k, p), v in zip(params.items(), flat.split(numels))}
        g_norm = opt.update(grads, state.opt_state, state.params, state.layout)
        del grads, flat
        sync_module(unet, state.params, state.layout)
        if state.ema_params is not None:
            d = cfg.ema_decay
            with torch.no_grad():
                for k, e in state.ema_params.items():
                    e.mul_(d).add_(state.params[k], alpha=1.0 - d)
        state.step += 1
        return state, {"loss": loss, "grad_norm": g_norm, "step": state.step,
                       "params_without_grad": off_graph, "state_bytes": state.nbytes()}

    return train_step
