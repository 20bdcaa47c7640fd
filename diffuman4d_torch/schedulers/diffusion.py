"""Diffusion scheduler, vectorized over per-latent step state (counterpart of
``diffuman4d_tpu/schedulers/diffusion.py``).

Every latent sits at its own timestep: the state is an int ``t_index``
tensor and :meth:`Scheduler.step` indexes each row's own table entries.
Four kinds, as in the JAX package: DDIM, DDPM, Euler (float timesteps,
interpolated sigmas) and DPM-Solver++ (2M), whose per-latent multistep
history (the previous x0 prediction and whether there is one) travels
beside the latents through :meth:`Scheduler.step_with_aux`. Tables are
fp32; ``step`` computes in fp32 and casts back.
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
    that are ``SchedulerConfig`` fields are taken, others dropped."""
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
    """Descending inference timesteps (diffusers ``set_timesteps``). DPM++
    divides the range into ``n + 1`` segments and drops the last timestep
    (its final step lands on sigma = 0 instead)."""
    t, n = cfg.num_train_timesteps, num_inference_steps
    if cfg.timestep_spacing == "trailing":
        return np.round(np.arange(t, 0, -t / n)).astype(np.int64) - 1
    m = n + 1 if cfg.kind == "dpm++" else n
    if cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, t - 1, m).round()[::-1]
    elif cfg.timestep_spacing == "leading":
        ts = (np.arange(m) * (t // m)).round()[::-1]
    else:
        raise ValueError(f"Unknown timestep spacing: {cfg.timestep_spacing}")
    ts = ts[:n].astype(np.int64)
    return ts + cfg.steps_offset if cfg.timestep_spacing == "leading" else ts


def _euler_timesteps(cfg: SchedulerConfig, n: int) -> np.ndarray:
    """diffusers EulerDiscrete's float64 timesteps (fractional under
    ``linspace`` spacing)."""
    t = cfg.num_train_timesteps
    if cfg.timestep_spacing == "linspace":
        return np.linspace(0, t - 1, n, dtype=np.float64)[::-1].copy()
    if cfg.timestep_spacing == "leading":
        return (np.arange(n) * (t // n)).round()[::-1].copy() + cfg.steps_offset
    if cfg.timestep_spacing == "trailing":
        return np.round(np.arange(t, 0, -t / n)).astype(np.float64) - 1
    raise ValueError(f"Unknown timestep spacing: {cfg.timestep_spacing}")


class Scheduler:
    """Config + fp32 tables after :meth:`set_timesteps`.

    Usage::

        sched = Scheduler(SchedulerConfig()).set_timesteps(36)
        t = sched.timestep_of(t_index, is_cond)
        x_in = sched.scale_model_input(x, t_index)
        x = sched.step(eps, t_index, x, mask=~is_cond)
        x, aux = sched.step_with_aux(eps, t_index, x, aux, mask=~is_cond)  # dpm++
    """

    def __init__(self, config: SchedulerConfig, device: torch.device | str = "cpu"):
        self.config = config
        self.device = torch.device(device)
        alphas_cumprod = np.cumprod(1.0 - _make_betas(config))
        self.alphas_cumprod = torch.tensor(alphas_cumprod, dtype=torch.float32, device=self.device)
        self.final_alpha_cumprod = float(
            np.float32(1.0 if config.set_alpha_to_one else alphas_cumprod[0])
        )
        self.num_inference_steps: int | None = None
        self.timesteps: torch.Tensor | None = None
        self.sigmas: torch.Tensor | None = None

    def set_timesteps(self, num_inference_steps: int,
                      device: torch.device | str | None = None) -> "Scheduler":
        """A new scheduler with ``num_inference_steps`` timesteps, its
        tables on ``device`` (default: this scheduler's). Euler keeps float
        timesteps and sigmas interpolated at them, with one trailing 0."""
        cfg = self.config
        new = Scheduler(cfg, self.device if device is None else device)
        new.num_inference_steps = num_inference_steps
        if cfg.kind == "euler":
            ts = _euler_timesteps(cfg, num_inference_steps)
            new.timesteps = torch.tensor(ts, dtype=torch.float32, device=new.device)
            ac = np.cumprod(1.0 - _make_betas(cfg))
            sig_all = np.sqrt((1 - ac) / ac)
            sig = np.interp(ts, np.arange(len(sig_all)), sig_all)
            new.sigmas = torch.tensor(np.concatenate([sig, [0.0]]), dtype=torch.float32,
                                      device=new.device)
        else:
            ts = _spaced_timesteps(cfg, num_inference_steps)
            new.timesteps = torch.tensor(ts, dtype=torch.int64, device=new.device)
        return new

    @property
    def init_noise_sigma(self) -> float:
        """The initial noise scale, an fp32 value (about 14.6 for Euler
        under ``leading`` spacing, 1 for the other kinds)."""
        if self.config.kind != "euler":
            return 1.0
        m = np.float32(self.sigmas.max().item())
        if self.config.timestep_spacing in ("linspace", "trailing"):
            return float(m)
        return float(np.sqrt(m * m + np.float32(1.0)))

    def timestep_of(self, t_index: torch.Tensor, is_cond: torch.Tensor) -> torch.Tensor:
        """Per-sample training timestep; conditional rows forced to 0."""
        idx = torch.where(is_cond, torch.zeros_like(t_index), t_index)
        t = self.timesteps[idx.clamp(0, self.num_inference_steps - 1).long()]
        return torch.where(is_cond, torch.zeros_like(t), t)

    def _clamped(self, t_index: torch.Tensor) -> torch.Tensor:
        return t_index.clamp(0, self.num_inference_steps - 1).long()

    def scale_model_input(self, sample: torch.Tensor, t_index: torch.Tensor) -> torch.Tensor:
        """Euler divides by sqrt(sigma^2 + 1) in fp32; the other kinds
        return ``sample``."""
        if self.config.kind != "euler":
            return sample
        sigma = self.sigmas[self._clamped(t_index)]
        scale = 1.0 / torch.sqrt(sigma**2 + 1.0)
        return (sample.float() * _bcast(scale, sample)).to(sample.dtype)

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
        model_output: torch.Tensor,  # (B, ...) network prediction
        t_index: torch.Tensor,  # (B,) index into self.timesteps
        sample: torch.Tensor,  # (B, ...) current latents
        mask: torch.Tensor | None = None,  # (B,) True = step this row
        noise: torch.Tensor | None = None,  # DDPM / DDIM eta > 0 noise
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """One reverse step per row at its own timestep; rows with
        ``mask == False`` pass through unchanged. DDPM and DDIM with eta > 0
        draw their noise from ``noise`` or ``generator`` and raise
        ``ValueError`` without either, as the JAX package does without a
        key."""
        if self.num_inference_steps is None:
            raise ValueError("call set_timesteps first")
        kind = self.config.kind
        if kind == "dpm++":
            raise ValueError("dpm++ is multistep: use step_with_aux")
        dtype = sample.dtype
        x = sample.float()
        eps = model_output.float()
        idx = self._clamped(t_index)
        if kind == "euler":
            out = self._euler_step(eps, idx, x)
        elif kind == "ddim":
            out = self._ddim_step(eps, idx, x, noise, generator)
        elif kind == "ddpm":
            out = self._ddpm_step(eps, idx, x, noise, generator)
        else:
            raise ValueError(kind)
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
        return _bcast(a_t, x), _bcast(a_prev, x), t, prev_t

    @staticmethod
    def _noise(x, noise, generator, what: str) -> torch.Tensor:
        if noise is None:
            if generator is None:
                raise ValueError(f"{what} requires a key (or explicit noise)")
            noise = torch.randn(x.shape, generator=generator, device=generator.device)
        return noise.to(x.device, torch.float32)

    def _ddim_step(self, model_output, idx, x, noise, generator):
        a_t, a_prev, _, _ = self._alpha_pair(idx, x)
        x0, eps = self._pred_x0(model_output, x, a_t)
        eta = self.config.ddim_eta
        if eta > 0:
            var = (1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)
            std = eta * torch.sqrt(var)
            noise = self._noise(x, noise, generator, "ddim with eta > 0")
        else:
            std = torch.zeros_like(a_t)
            noise = torch.zeros_like(x)
        dir_xt = torch.sqrt((1.0 - a_prev - std**2).clamp(min=0.0)) * eps
        return torch.sqrt(a_prev) * x0 + dir_xt + std * noise

    def _ddpm_step(self, model_output, idx, x, noise, generator):
        a_t, a_prev, t, prev_t = self._alpha_pair(idx, x)
        # diffusers' DDPMScheduler takes alpha_prev = 1 past the schedule's
        # end, where DDIM takes final_alpha_cumprod
        a_prev = torch.where(_bcast(prev_t >= 0, x), a_prev, torch.ones_like(a_prev))
        x0, _ = self._pred_x0(model_output, x, a_t)
        current_alpha = a_t / a_prev
        current_beta = 1.0 - current_alpha
        coef_x0 = torch.sqrt(a_prev) * current_beta / (1.0 - a_t)
        coef_xt = torch.sqrt(current_alpha) * (1.0 - a_prev) / (1.0 - a_t)
        mean = coef_x0 * x0 + coef_xt * x
        vt = self.config.variance_type
        if vt == "fixed_small":
            var = (1.0 - a_prev) / (1.0 - a_t) * current_beta
        elif vt == "fixed_large":
            var = current_beta
        else:
            raise NotImplementedError(f"ddpm variance_type {vt}")
        var = var.clamp(min=1e-20)
        noise = self._noise(x, noise, generator, "ddpm step")
        # variance noise only while t > 0, as in diffusers
        return mean + torch.where(_bcast(t > 0, x), torch.sqrt(var) * noise,
                                  torch.zeros_like(mean))

    def _euler_step(self, model_output, idx, x):
        sigma = _bcast(self.sigmas[idx], x)
        sigma_next = _bcast(self.sigmas[idx + 1], x)
        p = self.config.prediction_type
        if p == "epsilon":
            x0 = x - sigma * model_output
        elif p == "v_prediction":
            x0 = model_output * (-sigma / torch.sqrt(sigma**2 + 1)) + x / (sigma**2 + 1)
        elif p == "sample":
            x0 = model_output
        else:
            raise ValueError(p)
        derivative = (x - x0) / sigma
        return x + derivative * (sigma_next - sigma)

    # -- DPM-Solver++ (2M): multistep with explicit per-latent history -----
    @property
    def has_aux(self) -> bool:
        return self.config.kind == "dpm++"

    def init_aux(self, sample_shape, device: torch.device | str | None = None) -> dict:
        """Per-latent multistep history: the previous x0 prediction (fp32)
        and whether there is one (bool), on ``device`` (default: the
        scheduler's)."""
        dev = self.device if device is None else device
        return {"prev_x0": torch.zeros(tuple(sample_shape), dtype=torch.float32, device=dev),
                "has_prev": torch.zeros(tuple(sample_shape[:1]), dtype=torch.bool, device=dev)}

    def _lambda(self, t):
        a = self.alphas_cumprod[t]
        alpha, sigma = torch.sqrt(a), torch.sqrt(1.0 - a)
        return torch.log(alpha / sigma), alpha, sigma

    def step_with_aux(
        self,
        model_output: torch.Tensor,
        t_index: torch.Tensor,
        sample: torch.Tensor,
        aux: dict | None,
        mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, dict | None]:
        """DPM-Solver++(2M) step per latent: first order where a latent has
        no history, second order from its stored x0 prediction otherwise;
        the last step returns x0. Rows with ``mask == False`` keep their
        latents and their history. Other kinds step with :meth:`step` and
        pass ``aux`` through."""
        if self.config.kind != "dpm++":
            return self.step(model_output, t_index, sample, mask=mask), aux
        dtype = sample.dtype
        x = sample.float()
        idx = self._clamped(t_index)
        n = self.num_inference_steps
        t = self.timesteps[idx]
        # the schedule's neighbours (diffusers indexes sigmas by step), not
        # t -+ the train ratio
        t_prev2 = self.timesteps[(idx - 1).clamp(min=0)]
        t_next = self.timesteps[(idx + 1).clamp(max=n - 1)]
        is_last = idx == n - 1

        x0, _ = self._pred_x0(model_output.float(), x, _bcast(self.alphas_cumprod[t], x))
        lam_t, _, sig_t = self._lambda(t)
        lam_s, alp_s, sig_s = self._lambda(t_next)
        lam_p, _, _ = self._lambda(t_prev2)
        h = lam_s - lam_t
        h_prev = lam_t - lam_p
        r = h_prev / torch.where(h == 0, torch.ones_like(h), h)

        has_prev = aux["has_prev"]
        coef = 1.0 / (2.0 * r.clamp(min=1e-8))
        d = torch.where(_bcast(has_prev, x),
                        _bcast(1 + coef, x) * x0 - _bcast(coef, x) * aux["prev_x0"], x0)
        out = (_bcast(sig_s / sig_t, x) * x
               - _bcast(alp_s, x) * _bcast(torch.expm1(-h), x) * d)
        out = torch.where(_bcast(is_last, x), x0, out)

        if mask is None:
            new_aux = {"prev_x0": x0, "has_prev": torch.ones_like(has_prev)}
        else:
            out = torch.where(_bcast(mask, out), out, x)
            new_aux = {"prev_x0": torch.where(_bcast(mask, x0), x0, aux["prev_x0"]),
                       "has_prev": mask | has_prev}
        return out.to(dtype), new_aux


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, ...) matching ``like``'s rank."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))
