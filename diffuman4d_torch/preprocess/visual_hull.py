"""Visual-hull carving from foreground masks (counterpart of
``diffuman4d_tpu/preprocess/visual_hull.py``; reference:
scripts/preprocess/carve_visual_hull.py).

Voxel-centre projection into all cameras is one (B, 3, 4) x (4, M) product
plus a mask gather; voxels are kept when inside the mask in all (or >=
min_views) cameras. Batched over 1e6-voxel chunks like the reference
(:103-150), on the card unless ``device`` says otherwise. The first frame's
hull becomes the 3DGS-init ``sparse_pcd.ply`` (preprocess.sh:47).

The JAX package's ``_carve_chunk`` is an XLA-jitted function, not a Pallas
kernel, so :func:`_carve_chunk` here is stock torch: the same fp32 einsum
and projective divide, and ``torch.round`` (round half to even, as
``jnp.round`` and the reference's ``torch.round``).
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
import torch


def make_projection_matrix(K: np.ndarray, w2c: np.ndarray) -> np.ndarray:
    """K (B,3,3), w2c (B,4,4) -> P (B,3,4)."""
    return K @ w2c[:, :3, :]


def _carve_chunk(points: torch.Tensor, P: torch.Tensor, fmasks: torch.Tensor,
                 min_views: int) -> torch.Tensor:
    """points (M, 3), P (B, 3, 4), fmasks (B, H, W) bool -> keep (M,)."""
    B, H, W = fmasks.shape
    ph = torch.cat([points, torch.ones((points.shape[0], 1), dtype=points.dtype,
                                       device=points.device)], -1)
    x = torch.einsum("bij,mj->bmi", P, ph)  # (B, M, 3)
    z = x[..., 2]
    uv = x[..., :2] / torch.clamp(z[..., None], min=1e-8)
    u = torch.round(uv[..., 0]).to(torch.int64)
    v = torch.round(uv[..., 1]).to(torch.int64)
    valid = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    uc = u.clamp(0, W - 1)
    vc = v.clamp(0, H - 1)
    inside = torch.gather(fmasks.reshape(B, -1), 1, vc * W + uc)  # (B, M)
    inside = inside & valid
    if min_views <= 0:
        return inside.all(dim=0)
    return inside.sum(dim=0) >= min_views


def carve_visual_hull(
    fmasks: np.ndarray,  # (B, H, W) bool
    Ps: np.ndarray,  # (B, 3, 4)
    bounds: tuple[float, ...] = (-3.0, 3.0, -3.0, 3.0, -3.0, 3.0),
    voxel_size: float = 0.025,
    batch_size: int = 1_000_000,
    min_views: int | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """-> (M, 3) hull voxel centers."""
    xmin, xmax, ymin, ymax, zmin, zmax = bounds
    xs = np.arange(xmin, xmax, voxel_size, dtype=np.float32)
    ys = np.arange(ymin, ymax, voxel_size, dtype=np.float32)
    zs = np.arange(zmin, zmax, voxel_size, dtype=np.float32)
    nx, ny, nz = len(xs), len(ys), len(zs)
    N = nx * ny * nz

    P = torch.as_tensor(np.asarray(Ps, np.float32), device=device)
    fm = torch.as_tensor(np.asarray(fmasks, bool), device=device)
    kept = []
    for start in range(0, N, int(batch_size)):
        end = min(start + int(batch_size), N)
        idx = np.arange(start, end, dtype=np.int64)
        iz = idx % nz
        iy = (idx // nz) % ny
        ix = idx // (ny * nz)
        pts = np.stack([xs[ix], ys[iy], zs[iz]], axis=-1)
        keep = _carve_chunk(torch.from_numpy(pts).to(device), P, fm,
                            int(min_views or 0)).cpu().numpy()
        if keep.any():
            kept.append(pts[keep])
    if not kept:
        return np.empty((0, 3), np.float32)
    return np.concatenate(kept, axis=0)


def save_pcd_ply(path: str, pts: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY with white vertex colors (matches the
    reference's plyfile output schema, carve_visual_hull.py:40-74)."""
    pts = np.asarray(pts, np.float32)
    if colors is None:
        colors = np.full((len(pts), 3), 255, np.uint8)
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(pts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.empty(
        len(pts),
        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
               ("red", "u1"), ("green", "u1"), ("blue", "u1")],
    )
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]
    with open(path, "wb") as f:
        f.write(header.encode())
        rec.tofile(f)


def carve_scene(
    fmasks_dir: str,
    cameras_path: str,
    out_vhull_dir: str,
    bounds=(-3.0, 3.0, -3.0, 3.0, -3.0, 3.0),
    voxel_size: float = 0.025,
    min_views: int | None = None,
    frame_range: tuple = (0, None, 1),
    device: str | torch.device = "cuda",
) -> list[str]:
    """Per-frame hulls + running bounds json (carve_visual_hull.py:153-235).
    Camera poses are used UN-normalized (the hull lives in raw world space)."""
    from PIL import Image

    from diffuman4d_torch.data.cameras import parse_cameras

    cams = parse_cameras(cameras_path, coord_system="opencv", normalize_scene=False)
    cam_labels = sorted(os.listdir(fmasks_dir))
    frm_labels = sorted(
        osp.splitext(f)[0] for f in os.listdir(osp.join(fmasks_dir, cam_labels[0]))
    )
    b, e, s = frame_range
    frm_labels = frm_labels[b:e:s]

    Ks = np.stack([cams[c].K for c in cam_labels]).astype(np.float64)
    w2cs = np.stack([np.linalg.inv(cams[c].pose.astype(np.float64)) for c in cam_labels])
    P = make_projection_matrix(Ks, w2cs).astype(np.float32)

    out_paths = []
    bmin = np.full(3, np.inf)
    bmax = np.full(3, -np.inf)
    for frm in frm_labels:
        masks = np.stack(
            [
                np.asarray(
                    Image.open(osp.join(fmasks_dir, c, f"{frm}.png")).convert("L")
                )
                > 127
                for c in cam_labels
            ]
        )
        pts = carve_visual_hull(
            masks, P, bounds=bounds, voxel_size=voxel_size, min_views=min_views,
            device=device,
        )
        out = osp.join(out_vhull_dir, f"{frm}.ply")
        save_pcd_ply(out, pts)
        out_paths.append(out)
        if len(pts):
            bmin = np.minimum(bmin, pts.min(axis=0))
            bmax = np.maximum(bmax, pts.max(axis=0))

    with open(f"{out_vhull_dir}_bounds.json", "w") as f:
        json.dump([bmin.tolist(), bmax.tolist()], f)
    return out_paths
