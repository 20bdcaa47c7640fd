"""Plain reference of the Diffuman4D family's schedulers and one window step
(zju3dv/Diffuman4D ``pipeline_diffuman4d.py``, diffusers ``DDIMScheduler``
and ``DPMSolverMultistepScheduler`` (2M, x0 prediction history), in fp32).

A window step denoises the window's rows once: the conditional rows carry
their clean VAE latents, every row its Plücker rays and, per configuration,
its pose features or skeleton latents; classifier-free guidance runs the
UNet on the conditioned rows and on a negative copy (conditional latents
white, rays zero, pose features of a black skeleton, skeleton latents -1)
and mixes ``eps_u + g (eps_c - eps_u)``; the scheduler then steps the target
rows at their own timesteps.
"""

from __future__ import annotations

import numpy as np
import torch


class Schedule:
    """DDIM or DPM-Solver++ (2M) over ``n`` inference steps of a
    scaled-linear schedule of 1000 training steps, ``leading`` spacing,
    offset 1, epsilon prediction."""

    def __init__(self, kind: str, n: int, beta_start: float = 0.00085,
                 beta_end: float = 0.012, train_steps: int = 1000, steps_offset: int = 1):
        self.kind, self.n, self.train = kind, n, train_steps
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, train_steps) ** 2
        self.ac = np.cumprod(1.0 - betas)
        m = n + 1 if kind == "dpm++" else n
        ts = (np.arange(m) * (train_steps // m)).round()[::-1][:n].astype(np.int64)
        self.timesteps = ts + steps_offset

    def timestep(self, t_idx: np.ndarray, is_cond: np.ndarray) -> np.ndarray:
        t = self.timesteps[np.clip(t_idx, 0, self.n - 1)]
        return np.where(is_cond, 0, t)

    def step(self, eps: torch.Tensor, t_idx: np.ndarray, x: torch.Tensor, mask: np.ndarray,
             aux: dict | None):
        """(new latents, new history) of fp32 rows ``x``; rows off ``mask``
        keep their latents and history."""
        dev = x.device
        idx = np.clip(t_idx, 0, self.n - 1)
        t = self.timesteps[idx]
        bc = (-1,) + (1,) * (x.dim() - 1)

        def col(v):
            return torch.as_tensor(np.asarray(v, np.float64)).reshape(bc).to(dev)

        a_t = self.ac[t]
        x0 = (x.double() - col(np.sqrt(1 - a_t)) * eps.double()) / col(np.sqrt(a_t))
        m = torch.as_tensor(mask, device=dev).reshape(bc)
        if self.kind == "ddim":
            prev_t = t - self.train // self.n
            a_prev = np.where(prev_t >= 0, self.ac[np.clip(prev_t, 0, None)], self.ac[0])
            out = col(np.sqrt(a_prev)) * x0 + col(np.sqrt(1 - a_prev)) * eps.double()
            return torch.where(m, out, x.double()).float(), aux
        lam = lambda tt: np.log(np.sqrt(self.ac[tt]) / np.sqrt(1 - self.ac[tt]))
        t_next = self.timesteps[np.clip(idx + 1, None, self.n - 1)]
        t_prev = self.timesteps[np.clip(idx - 1, 0, None)]
        h = lam(t_next) - lam(t)
        r = (lam(t) - lam(t_prev)) / np.where(h == 0, 1.0, h)
        coef = 1.0 / (2.0 * np.maximum(r, 1e-8))
        has = torch.as_tensor(aux["has_prev"], device=dev).reshape(bc)
        d = torch.where(has, col(1 + coef) * x0 - col(coef) * aux["prev_x0"].double(), x0)
        out = (col(np.sqrt(1 - self.ac[t_next]) / np.sqrt(1 - a_t)) * x.double()
               - col(np.sqrt(self.ac[t_next])) * col(np.expm1(-h)) * d)
        out = torch.where(col(idx == self.n - 1) > 0, x0, out)
        new = {"prev_x0": torch.where(m, x0, aux["prev_x0"].double()).float(),
               "has_prev": torch.as_tensor(mask, device=dev) | aux["has_prev"]}
        return torch.where(m, out, x.double()).float(), new


@torch.no_grad()
def window_step(unet, sched: Schedule, guidance: float, domain: str, x: torch.Tensor,
                t_idx: np.ndarray, is_cond: np.ndarray, cond_lat: torch.Tensor,
                rays: torch.Tensor, pose: torch.Tensor | None, neg_pose: torch.Tensor | None,
                skel_lat: torch.Tensor | None, aux: dict | None):
    """One denoising step of one window of L rows in fp32. ``x``: the rows'
    latents (L, h, w, 4); ``cond_lat``: clean latents of the conditional rows
    (others ignored). Returns (latents, history) and the same step taken
    with eps = 0: the step is affine in eps, so the difference of the two is
    the model's part of each row's update."""
    L = x.shape[0]
    dev = x.device
    sel = torch.as_tensor(is_cond, device=dev)[:, None, None, None]
    xin = torch.where(sel, cond_lat, x)
    mask_plane = (~sel).float().expand(L, x.shape[1], x.shape[2], 1)
    t = torch.as_tensor(sched.timestep(t_idx, is_cond), device=dev)
    tem = (torch.arange(L // 2, device=dev).repeat(2) if domain == "temporal"
           else torch.zeros(L, dtype=torch.int64, device=dev))

    def eps_of(xh, rh, ph, sh):
        parts = [xh, rh] + ([sh] if sh is not None else []) + [mask_plane]
        return unet(torch.cat(parts, -1), t, tem, L, pose_features=ph)

    eps_u = eps_of(torch.where(sel, torch.ones_like(xin), xin), torch.zeros_like(rays),
                   None if pose is None else neg_pose.expand_as(pose),
                   None if skel_lat is None else -torch.ones_like(skel_lat))
    eps_c = eps_of(xin, rays, pose, skel_lat)
    eps = eps_u + guidance * (eps_c - eps_u)
    mask = ~np.asarray(is_cond)
    return sched.step(eps, t_idx, x, mask, aux), sched.step(torch.zeros_like(eps), t_idx, x,
                                                          mask, aux)
