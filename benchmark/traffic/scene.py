"""Synthetic DNA-Rendering-style scene generator: the benchmark's frozen
copy of the port's ``data/synthetic.py``, so that the scenes every cell
reads stay the same whatever later changes the program makes.

Writes the exact on-disk layout the reference's downloader produces
(scripts/download/download_dataset.py:44-153):

    {scene}/transforms.json
    {scene}/images/{cam}/{frame}.webp
    {scene}/fmasks/{cam}/{frame}.png
    {scene}/skeletons/{cam}/{frame}.webp

Content is a camera ring around a moving ellipsoidal "person" blob, enough
to drive the full sampling stack end-to-end (tests, demos, benchmarks)
without the real 1TB dataset — which cannot be downloaded in this
environment anyway.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
from PIL import Image


def _ring_camera(i: int, n: int, radius: float = 2.5, height: float = 0.0):
    th = 2 * np.pi * i / n
    c = np.array([radius * np.cos(th), height, radius * np.sin(th)])
    fwd = -c / np.linalg.norm(c)  # +z looks at origin (OpenCV)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, up2, fwd, c
    return pose


def make_synthetic_scene(
    data_dir: str,
    scene_label: str = "synth_00",
    num_cams: int = 8,
    num_frames: int = 4,
    image_size: int = 64,
    seed: int = 0,
    unique_frames: int | None = None,
) -> str:
    """Create the scene tree; returns the scene directory.

    ``unique_frames``: render only this many frames per camera and hardlink
    the rest cyclically — large-grid workload runs (e.g. the 48x150
    demo_4d shape) keep real per-frame file IO/decode without hours of
    1-core rendering. Pipeline behavior is content-independent, so the
    schedule, caches, and transfer paths are exercised identically."""
    rng = np.random.default_rng(seed)
    scene_dir = osp.join(data_dir, scene_label)
    h = w = image_size
    f = image_size * 1.2

    frames_meta = []
    for i in range(num_cams):
        pose_cv = _ring_camera(i, num_cams)
        pose_gl = pose_cv.copy()
        pose_gl[:3, 1:3] *= -1  # store OpenGL like nerfstudio
        frames_meta.append(
            {
                "fl_x": f,
                "fl_y": f,
                "cx": w / 2,
                "cy": h / 2,
                "h": h,
                "w": w,
                "transform_matrix": pose_gl.tolist(),
                "camera_label": f"{i:02d}",
            }
        )
    os.makedirs(scene_dir, exist_ok=True)
    with open(osp.join(scene_dir, "transforms.json"), "w") as fp:
        json.dump({"frames": frames_meta}, fp)

    # a "person": three blobs (head/torso/legs) orbiting slowly over time
    for i in range(num_cams):
        cam = f"{i:02d}"
        pose = _ring_camera(i, num_cams)
        K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
        w2c = np.linalg.inv(pose)
        n_render = min(unique_frames or num_frames, num_frames)
        for t in range(num_frames):
            tem = f"{t:06d}"
            if t >= n_render:
                # hardlink the cyclically-matching rendered frame
                src_tem = f"{t % n_render:06d}"
                for sub, ext in (("images", "webp"), ("fmasks", "png"),
                                 ("skeletons", "webp")):
                    d = osp.join(scene_dir, sub, cam)
                    dst = osp.join(d, f"{tem}.{ext}")
                    if not osp.exists(dst):
                        os.link(osp.join(d, f"{src_tem}.{ext}"), dst)
                continue
            phase = 2 * np.pi * t / max(num_frames, 1) * 0.25
            centers = np.array(
                [
                    [0.15 * np.sin(phase), -0.45, 0.15 * np.cos(phase)],  # head
                    [0.0, 0.0, 0.0],  # torso
                    [0.05 * np.sin(phase), 0.5, 0.0],  # legs
                ]
            )
            radii = np.array([0.18, 0.33, 0.28])
            colors = np.array([[0.9, 0.7, 0.6], [0.2, 0.4, 0.8], [0.3, 0.3, 0.3]])

            yy, xx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
            img = np.ones((h, w, 3), np.float32)
            mask = np.zeros((h, w), np.float32)
            skel = np.zeros((h, w, 3), np.float32)
            for c3, r3, col in zip(centers, radii, colors):
                pc = w2c[:3, :3] @ c3 + w2c[:3, 3]
                if pc[2] <= 0.05:
                    continue
                uv = K @ (pc / pc[2])
                pr = f * r3 / pc[2]
                d2 = (xx - uv[0]) ** 2 + (yy - uv[1]) ** 2
                inside = d2 <= pr**2
                shade = 1.0 - 0.5 * np.sqrt(np.clip(d2 / (pr**2 + 1e-6), 0, 1))
                img[inside] = (col[None] * shade[inside, None]).astype(np.float32)
                mask[inside] = 1.0
                core = d2 <= (pr * 0.3) ** 2
                skel[core] = np.array([0.0, 1.0, 0.3]) * rng.uniform(0.8, 1.0)

            for sub, arr, ext in (
                ("images", img, "webp"),
                ("fmasks", mask[..., None].repeat(3, -1), "png"),
                ("skeletons", skel, "webp"),
            ):
                d = osp.join(scene_dir, sub, cam)
                os.makedirs(d, exist_ok=True)
                pil = Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8))
                kwargs = {"lossless": True} if ext == "webp" else {}
                pil.save(osp.join(d, f"{tem}.{ext}"), **kwargs)
    return scene_dir
