"""Diffusion scheduler, vectorized over per-latent step state (counterpart of
``diffuman4d_tpu/schedulers/diffusion.py``).

Every latent sits at its own timestep: the state is an int ``t_index``
tensor and :meth:`Scheduler.step` indexes each row's own table entries.
Only DDIM is ported; the DDPM, Euler and DPM++ kinds raise
``NotImplementedError``. Tables are fp32; ``step`` computes in fp32 and
casts back.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SchedulerConfig:
    """Same fields and defaults as the JAX package's ``SchedulerConfig``."""

    kind: str = "ddim"  # ddim | ddpm | euler | dpm++
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # linear | scaled_linear | squaredcos_cap_v2
    prediction_type: str = "epsilon"  # epsilon | v_prediction | sample
    timestep_spacing: str = "leading"  # leading | trailing | linspace
    steps_offset: int = 1
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = False
    ddim_eta: float = 0.0
    variance_type: str = "fixed_small"


def from_config(cfg: dict) -> "Scheduler":
    """Build from a diffusers ``scheduler_config.json`` dict (the JAX
    package's ``from_config``): the class name picks the kind, the keys
    that are ``SchedulerConfig`` fields are taken, others dropped. Only a
    DDIM config builds; the other kinds raise in :class:`Scheduler`."""
    class_name = cfg.get("_class_name", "DDIMScheduler")
    kind = {
        "DDIMScheduler": "ddim",
        "DDPMScheduler": "ddpm",
        "EulerDiscreteScheduler": "euler",
        "DPMSolverMultistepScheduler": "dpm++",
    }.get(class_name)
    if kind is None:
        raise NotImplementedError(f"Scheduler {class_name} not supported")
    fields = {f.name for f in dataclasses.fields(SchedulerConfig)}
    return Scheduler(SchedulerConfig(kind=kind, **{k: v for k, v in cfg.items() if k in fields}))


def _make_betas(cfg: SchedulerConfig) -> np.ndarray:
    t = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, t, dtype=np.float64)
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, t, dtype=np.float64) ** 2
    if cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(x):
            return np.cos((x + 0.008) / 1.008 * np.pi / 2) ** 2

        return np.array(
            [min(1 - alpha_bar((i + 1) / t) / alpha_bar(i / t), 0.999) for i in range(t)],
            dtype=np.float64,
        )
    raise ValueError(f"Unknown beta schedule: {cfg.beta_schedule}")


def _spaced_timesteps(cfg: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending inference timesteps (diffusers DDIM ``set_timesteps``)."""
    t, n = cfg.num_train_timesteps, num_inference_steps
    if cfg.timestep_spacing == "linspace":
        return np.linspace(0, t - 1, n).round()[::-1].astype(np.int64)
    if cfg.timestep_spacing == "leading":
        ratio = t // n
        return (np.arange(n) * ratio).round()[::-1].astype(np.int64) + cfg.steps_offset
    if cfg.timestep_spacing == "trailing":
        ratio = t / n
        return np.round(np.arange(t, 0, -ratio)).astype(np.int64) - 1
    raise ValueError(f"Unknown timestep spacing: {cfg.timestep_spacing}")


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, ...) matching ``like``'s rank."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


class Scheduler:
    """Config + fp32 tables after :meth:`set_timesteps`.

    Usage::

        sched = Scheduler(SchedulerConfig()).set_timesteps(36)
        t = sched.timestep_of(t_index, is_cond)
        x = sched.step(eps, t_index, x, mask=~is_cond)
    """

    def __init__(self, config: SchedulerConfig, device: torch.device | str = "cpu"):
        if config.kind != "ddim":
            raise NotImplementedError(f"scheduler kind {config.kind!r} is not ported yet (ddim is; "
                                      f"ROADMAP A.4)")
        self.config = config
        self.device = torch.device(device)
        alphas_cumprod = np.cumprod(1.0 - _make_betas(config))
        self.alphas_cumprod = torch.tensor(alphas_cumprod, dtype=torch.float32, device=self.device)
        self.final_alpha_cumprod = float(
            np.float32(1.0 if config.set_alpha_to_one else alphas_cumprod[0])
        )
        self.num_inference_steps: int | None = None
        self.timesteps: torch.Tensor | None = None

    def set_timesteps(self, num_inference_steps: int,
                      device: torch.device | str | None = None) -> "Scheduler":
        """A new scheduler with ``num_inference_steps`` timesteps, its
        tables on ``device`` (default: this scheduler's)."""
        new = Scheduler(self.config, self.device if device is None else device)
        new.num_inference_steps = num_inference_steps
        ts = _spaced_timesteps(self.config, num_inference_steps)
        new.timesteps = torch.tensor(ts, dtype=torch.int64, device=new.device)
        return new

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def timestep_of(self, t_index: torch.Tensor, is_cond: torch.Tensor) -> torch.Tensor:
        """Per-sample training timestep; conditional rows forced to 0."""
        idx = torch.where(is_cond, torch.zeros_like(t_index), t_index)
        t = self.timesteps[idx.clamp(0, self.num_inference_steps - 1).long()]
        return torch.where(is_cond, torch.zeros_like(t), t)

    def scale_model_input(self, sample: torch.Tensor, t_index: torch.Tensor) -> torch.Tensor:
        """Identity for DDIM."""
        return sample

    def _sqrt_alpha_pair(self, sample: torch.Tensor, timesteps: torch.Tensor):
        a = self.alphas_cumprod.to(sample.device)[timesteps.long()]
        return _bcast(torch.sqrt(a), sample), _bcast(torch.sqrt(1.0 - a), sample)

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) forward noising (training), fp32 inside."""
        sa, sb = self._sqrt_alpha_pair(sample, timesteps)
        return (sa * sample.float() + sb * noise.float()).to(sample.dtype)

    def velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                 timesteps: torch.Tensor) -> torch.Tensor:
        """v-prediction target: v = sqrt(a) eps - sqrt(1 - a) x0."""
        sa, sb = self._sqrt_alpha_pair(sample, timesteps)
        return (sa * noise.float() - sb * sample.float()).to(sample.dtype)

    def step(
        self,
        model_output: torch.Tensor,  # (B, ...) eps prediction
        t_index: torch.Tensor,  # (B,) index into self.timesteps
        sample: torch.Tensor,  # (B, ...) current latents
        mask: torch.Tensor | None = None,  # (B,) True = step this row
        noise: torch.Tensor | None = None,  # DDIM eta > 0 noise
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """One DDIM step per row at its own timestep; rows with
        ``mask == False`` pass through unchanged."""
        if self.num_inference_steps is None:
            raise ValueError("call set_timesteps first")
        dtype = sample.dtype
        x = sample.float()
        eps = model_output.float()
        idx = t_index.clamp(0, self.num_inference_steps - 1).long()
        out = self._ddim_step(eps, idx, x, noise, generator)
        if mask is not None:
            out = torch.where(_bcast(mask, out), out, x)
        return out.to(dtype)

    def _pred_x0(self, model_output, x, alpha_prod):
        sa = torch.sqrt(alpha_prod)
        sb = torch.sqrt(1.0 - alpha_prod)
        p = self.config.prediction_type
        if p == "epsilon":
            x0, eps = (x - sb * model_output) / sa, model_output
        elif p == "v_prediction":
            x0, eps = sa * x - sb * model_output, sa * model_output + sb * x
        elif p == "sample":
            x0 = model_output
            eps = (x - sa * x0) / sb
        else:
            raise ValueError(p)
        if self.config.clip_sample:
            r = self.config.clip_sample_range
            x0 = x0.clamp(-r, r)
            eps = (x - sa * x0) / sb
        return x0, eps

    def _alpha_pair(self, idx, x):
        t = self.timesteps[idx]
        step_ratio = self.config.num_train_timesteps // self.num_inference_steps
        prev_t = t - step_ratio
        a_t = self.alphas_cumprod[t]
        a_prev = torch.where(
            prev_t >= 0,
            self.alphas_cumprod[prev_t.clamp(min=0)],
            torch.full_like(a_t, self.final_alpha_cumprod),
        )
        return _bcast(a_t, x), _bcast(a_prev, x)

    def _ddim_step(self, model_output, idx, x, noise, generator):
        a_t, a_prev = self._alpha_pair(idx, x)
        x0, eps = self._pred_x0(model_output, x, a_t)
        eta = self.config.ddim_eta
        if eta > 0:
            var = (1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)
            std = eta * torch.sqrt(var)
            if noise is None:
                if generator is None:
                    raise ValueError("ddim with eta > 0 needs noise or a generator")
                noise = torch.randn(x.shape, generator=generator, device=generator.device)
            noise = noise.to(x.device, torch.float32)
        else:
            std = torch.zeros_like(a_t)
            noise = torch.zeros_like(x)
        dir_xt = torch.sqrt((1.0 - a_prev - std**2).clamp(min=0.0)) * eps
        return torch.sqrt(a_prev) * x0 + dir_xt + std * noise
