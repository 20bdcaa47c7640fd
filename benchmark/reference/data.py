"""Plain reference of the inputs a task's rows see: the frames of the scene
as the DNA-Rendering loader prepares them (crop around the person, bicubic
resize, white background, [-1, 1]), the cameras (nerfstudio
``transforms.json``, OpenGL to OpenCV, scene normalised), the Plücker rays at
latent resolution, and the seeded noise of the sampler (initial latents per
grid cell, VAE posterior noise per frame label).

These follow zju3dv/Diffuman4D ``spatem_dataset.py`` / ``crop_utils.py`` /
``camera_parser.py`` / ``ray_utils.py`` and the seeding that the port
documents (one CPU generator per grid cell or frame, seeded from a SHA-256
of the integers). Numpy, PIL and plain torch; nothing of the program.
"""

from __future__ import annotations

import hashlib
import json
import math
import os.path as osp
import zlib

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

SKELETON_NOISE_TAG = 1


def cell_seed(*parts: int) -> int:
    digest = hashlib.sha256(repr(tuple(int(p) for p in parts)).encode()).digest()
    return int.from_bytes(digest[:8], "little") & 0x7FFFFFFFFFFFFFFF


def init_noise(seed: int, cells, latent: int, channels: int = 4) -> torch.Tensor:
    """fp32 (N, h, w, c) initial latents of grid cells ``(spa_idx, tem_idx)``."""
    rows = []
    for s, t in cells:
        g = torch.Generator().manual_seed(cell_seed(seed, s, t))
        rows.append(torch.randn((latent, latent, channels), generator=g))
    return torch.stack(rows)


def label_noise(cond_seed: int, labels, latent: int, *tag: int) -> torch.Tensor:
    """fp32 posterior noise per frame label (scene, spa, tem); ``tag`` 1 is
    the skeleton's stream."""
    rows = []
    for lb in labels:
        g = torch.Generator().manual_seed(cell_seed(cond_seed, zlib.crc32(repr(lb).encode()), *tag))
        rows.append(torch.randn((latent, latent, 4), generator=g))
    return torch.stack(rows)


def parse_cameras(path: str) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """{label: (K, camera-to-world pose)}, OpenCV axes, camera centres moved
    to their bounding box's centre and scaled by 1 / its diagonal."""
    with open(path) as f:
        frames = json.load(f)["frames"]
    labels, Ks, poses = [], [], []
    for cam in frames:
        Ks.append(np.array([[cam["fl_x"], 0, cam["cx"]], [0, cam["fl_y"], cam["cy"]],
                            [0, 0, 1]], np.float64))
        pose = np.array(cam["transform_matrix"], np.float64)
        pose[:3, 1:3] *= -1
        poses.append(pose)
        labels.append(str(cam["camera_label"]))
    poses = np.stack(poses)
    lo, hi = poses[:, :3, 3].min(0), poses[:, :3, 3].max(0)
    poses[:, :3, 3] = (poses[:, :3, 3] - (lo + hi) / 2) / float(np.linalg.norm(hi - lo))
    return {lb: (K.astype(np.float32), p.astype(np.float32))
            for lb, K, p in zip(labels, Ks, poses)}


def nearest_input(cams, target: str, inputs: list[str]) -> str:
    t = cams[target][1][:3, 3]
    return inputs[int(np.argmin([np.linalg.norm(cams[s][1][:3, 3] - t) for s in inputs]))]


def _crop_box(mask: np.ndarray) -> list[int]:
    """Square crop centred on the mask's bounding box (grown by 1 pixel),
    at least 70% of the image height: [top, left, h, w]."""
    h, w = mask.shape
    rows = np.nonzero(mask.any(axis=1))[0]
    cols = np.nonzero(mask.any(axis=0))[0]
    xmin, ymin, xmax, ymax = cols[0] - 1, rows[0] - 1, cols[-1] + 1, rows[-1] + 1
    xc, yc = (xmin + xmax) / 2, (ymin + ymax) / 2
    side = max(2 * max(yc - ymin, ymax - yc, xc - xmin, xmax - xc), 0.7 * h)
    width = int(side)
    x0, y0 = math.floor(xc - width / 2), math.floor(yc - side / 2)
    x1, y1 = math.ceil(xc + width / 2), math.ceil(yc + side / 2)
    return [y0, x0, y1 - y0, x1 - x0]


def _resize(img: Image.Image, box, size: int) -> np.ndarray:
    top, left, ch, cw = box
    return np.asarray(img.crop((left, top, left + cw, top + ch)).resize(
        (size, size), resample=Image.BICUBIC))


def load_rows(scene_dir: str, labels, size: int):
    """(pixels [-1, 1] fp32 (N, H, W, 3), skeletons uint8 (N, H, W, 3),
    K (N, 3, 3), poses relative to the first row (N, 4, 4)) of ``labels``."""
    cams = parse_cameras(osp.join(scene_dir, "transforms.json"))
    pix, skel, Ks, poses = [], [], [], []
    for _, spa, tem in labels:
        img = Image.open(osp.join(scene_dir, "images", spa, f"{tem}.webp")).convert("RGB")
        fm = np.asarray(Image.open(osp.join(scene_dir, "fmasks", spa, f"{tem}.png")))
        fm = fm.astype(np.float32) / 255.0
        fm = fm.mean(-1) if fm.ndim == 3 else fm
        box = _crop_box(fm != 0)
        rgb = _resize(img, box, size).astype(np.float32) / 255.0
        m = _resize(Image.fromarray((np.clip(fm, 0, 1) * 255).astype(np.uint8)), box, size)
        m = (m.astype(np.float32) / 255.0)[..., None]
        pix.append((rgb * m + (1.0 - m)) * 2.0 - 1.0)
        sk = Image.open(osp.join(scene_dir, "skeletons", spa, f"{tem}.webp")).convert("RGB")
        skel.append(_resize(sk, box, size))
        K, pose = cams[spa]
        K = K.astype(np.float64).copy()
        K[0, 2] -= box[1]
        K[1, 2] -= box[0]
        K *= size / box[2]
        K[2, 2] = 1.0
        Ks.append(K.astype(np.float32))
        poses.append(pose)
    poses = np.stack(poses)
    rel = (np.linalg.inv(poses[0]) @ poses).astype(np.float32)
    return np.stack(pix), np.stack(skel), np.stack(Ks), rel


def plucker(K: torch.Tensor, pose: torch.Tensor, size: int, latent: int) -> torch.Tensor:
    """(N, latent, latent, 6) Plücker embedding (ray direction, origin x
    direction) of pixel-centre rays at full resolution, bilinearly
    downsampled (no antialias)."""
    K, pose = K.double(), pose.double()
    w2c = torch.linalg.inv(pose)
    R, T = w2c[:, :3, :3], w2c[:, :3, 3:]
    Rt = R.transpose(1, 2)
    origin = -(Rt @ T)[..., 0]  # (N, 3)
    c = torch.arange(size, dtype=torch.float64, device=K.device) + 0.5
    ii, jj = torch.meshgrid(c, c, indexing="ij")
    xy1 = torch.stack([jj, ii, torch.ones_like(ii)], -1)  # (H, W, 3)
    cam = torch.einsum("nij,hwj->nhwi", torch.linalg.inv(K), xy1)
    world = torch.einsum("nij,nhwj->nhwi", Rt, cam - T[:, None, None, :, 0])
    d = world - origin[:, None, None]
    d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-8)
    o = origin[:, None, None].expand_as(d)
    emb = torch.cat([d, torch.linalg.cross(o, d, dim=-1)], -1).float()
    emb = F.interpolate(emb.permute(0, 3, 1, 2), size=(latent, latent), mode="bilinear",
                        align_corners=False, antialias=False)
    return emb.permute(0, 2, 3, 1)
