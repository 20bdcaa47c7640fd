"""Rays, Plücker embeddings and relative poses, fp32, channels-last
(counterpart of ``diffuman4d_tpu/data/rays.py``).

:func:`get_rays` gives pixel-centre rays at full resolution and
:func:`calc_plucker_embeds` the full-resolution embedding (ray_d, ray_o x
ray_d). :func:`calc_plucker_embeds_lowres` equals bilinearly downsampling
the full-resolution embedding (torch ``F.interpolate``, no antialias) but
evaluates rays only at the 2x2 bilinear taps of each output pixel.
"""

from __future__ import annotations

import torch

from diffuman4d_torch.ops.resize import bilinear_taps


def normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + eps)


def _rays_at_coords(ii, jj, K, R, T):
    """Rays at the outer product of pixel-centre coords; (B, H', W', 3) each."""
    K, R, T = K.float(), R.float(), T.float()
    invK = torch.linalg.inv(K)
    Rt = R.transpose(-1, -2)
    ray_o = -torch.einsum("bij,bjk->bik", Rt, T)[..., 0]  # (B, 3)
    ig, jg = torch.meshgrid(ii, jj, indexing="ij")  # (H', W')
    xy1 = torch.stack([jg, ig, torch.ones_like(ig)], dim=-1)
    pix_cam = torch.einsum("bij,hwj->bhwi", invK, xy1)
    pix_world = torch.einsum("bij,bhwj->bhwi", Rt, pix_cam - T[:, None, None, :, 0])
    ray_d = normalize(pix_world - ray_o[:, None, None, :])
    return ray_o[:, None, None, :].expand_as(ray_d), ray_d


def get_rays(H: int, W: int, K: torch.Tensor, R: torch.Tensor, T: torch.Tensor):
    """Full-resolution pixel-centre rays of world-to-camera ``R`` (B, 3, 3)
    and ``T`` (B, 3, 1): (ray_o, ray_d), each (B, H, W, 3)."""
    ii = torch.arange(H, dtype=torch.float32, device=K.device) + 0.5
    jj = torch.arange(W, dtype=torch.float32, device=K.device) + 0.5
    return _rays_at_coords(ii, jj, K, R, T)


def _pose_to_extrinsics(pose: torch.Tensor):
    extrinsic = torch.linalg.inv(pose.float())
    return extrinsic[:, :3, :3], extrinsic[:, :3, 3:]


def _plucker_from_rays(ray_o: torch.Tensor, ray_d: torch.Tensor) -> torch.Tensor:
    return torch.cat([ray_d, torch.linalg.cross(ray_o, ray_d, dim=-1)], dim=-1)


def calc_plucker_embeds(h: int, w: int, K: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Full-resolution Plücker embeddings of camera-to-world ``pose``
    (B, 4, 4), channels-last (B, h, w, 6)."""
    R, T = _pose_to_extrinsics(pose)
    return _plucker_from_rays(*get_rays(h, w, K, R, T))


def calc_plucker_embeds_lowres(h: int, w: int, K: torch.Tensor, pose: torch.Tensor,
                               out_h: int, out_w: int) -> torch.Tensor:
    """Plücker embeddings (ray_d, ray_o x ray_d) of an (h, w) image,
    bilinearly downsampled to (out_h, out_w). Output (B, out_h, out_w, 6)."""
    R, T = _pose_to_extrinsics(pose)
    dev = pose.device
    i0, i1, wi = bilinear_taps(h, out_h, dev)
    j0, j1, wj = bilinear_taps(w, out_w, dev)
    ii = torch.cat([i0, i1]).float() + 0.5
    jj = torch.cat([j0, j1]).float() + 0.5
    emb = _plucker_from_rays(*_rays_at_coords(ii, jj, K, R, T))
    e00, e01 = emb[:, :out_h, :out_w], emb[:, :out_h, out_w:]
    e10, e11 = emb[:, out_h:, :out_w], emb[:, out_h:, out_w:]
    wi = wi[None, :, None, None]
    wj = wj[None, None, :, None]
    top = e00 * (1 - wj) + e01 * wj
    bot = e10 * (1 - wj) + e11 * wj
    return top * (1 - wi) + bot * wi


def calc_relative_poses(poses: torch.Tensor) -> torch.Tensor:
    """Poses relative to the first camera of the sample."""
    poses = poses.float()
    return torch.einsum("ij,bjk->bik", torch.linalg.inv(poses[0]), poses)
