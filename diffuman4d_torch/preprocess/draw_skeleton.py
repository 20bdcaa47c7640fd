"""Skeleton-map rendering (reference: scripts/preprocess/draw_skeleton.py).

Renders 133-keypoint COCO-WholeBody skeletons into the RGB condition maps
the diffusion model consumes:

  * drawn at 2048p then downsampled for anti-aliasing (:73-74)
  * painter's algorithm: lines sorted by mean endpoint depth (far first)
    when depths exist, else by score (:148-156)
  * score -> color dimming between low/high thresholds (:18-23)
  * 2x radius/thickness for the 25 major body links (:106-107)
  * torso cross-links (left shoulder <-> right hip etc., :93-98)

Keypoint JSON format matches the reference's triangulation output:
{"instance_info": [{"keypoints": [[x, y], ...], "keypoint_scores": [...],
"keypoint_depths": [...]}]}.

The port's own copy of ``diffuman4d_tpu/preprocess/draw_skeleton.py`` (numpy
only), held bit-equal to it by ``tests/test_torch_port_preprocess.py``.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

from diffuman4d_torch.preprocess.skeleton_data import (
    EXTRA_CROSS_LINKS,
    coco_wholebody_keypoint_colors,
    coco_wholebody_skeleton,
)

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


def score_to_color(rgb, score, low=0.5, high=0.9):
    score = float(np.clip(score, low, high))
    norm = (score - low) / (high - low)
    return [int(round(c * norm)) for c in rgb]


def _draw_line(canvas, p1, p2, color, thickness):
    if _HAS_CV2:
        cv2.line(canvas, p1, p2, color, thickness)
        return
    _rasterize_capsule(canvas, p1, p2, color, thickness / 2.0)


def _draw_circle(canvas, p, radius, color):
    if _HAS_CV2:
        cv2.circle(canvas, p, int(radius), color, -1)
        return
    _rasterize_capsule(canvas, p, p, color, float(radius))


def _rasterize_capsule(canvas, p1, p2, color, r):
    """Fallback rasterizer: fill pixels within distance r of segment p1-p2."""
    h, w = canvas.shape[:2]
    x0 = max(int(min(p1[0], p2[0]) - r - 1), 0)
    x1 = min(int(max(p1[0], p2[0]) + r + 2), w)
    y0 = max(int(min(p1[1], p2[1]) - r - 1), 0)
    y1 = min(int(max(p1[1], p2[1]) + r + 2), h)
    if x1 <= x0 or y1 <= y0:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    a = np.array(p1, np.float32)
    b = np.array(p2, np.float32)
    ab = b - a
    denom = float(ab @ ab) or 1.0
    t = np.clip(((xx - a[0]) * ab[0] + (yy - a[1]) * ab[1]) / denom, 0, 1)
    dx = xx - (a[0] + t * ab[0])
    dy = yy - (a[1] + t * ab[1])
    mask = dx * dx + dy * dy <= r * r
    canvas[y0:y1, x0:x1][mask] = color


def draw_one_skeleton(
    kp2d_path: str,
    out_kpmap_path: str,
    kp2d_score_path: str | None = None,
    kp2d_canvas_shape: tuple[int, int] = (1024, 1024),
    out_kpmap_shape: tuple[int, int] = (1024, 1024),
    low_thr: float = 0.5,
    high_thr: float = 0.9,
    radius: int = 2,
    thickness: int = 2,
    image_quality: int = 85,
    skip_exists: bool = False,
) -> None:
    if skip_exists and osp.exists(out_kpmap_path):
        try:
            Image.open(out_kpmap_path).verify()
            return
        except Exception:
            pass  # corrupt -> re-draw

    info = json.load(open(kp2d_path))["instance_info"][0]
    kpts = np.asarray(info["keypoints"], np.float32)
    if kp2d_score_path is not None:
        scores = np.asarray(
            json.load(open(kp2d_score_path))["instance_info"][0]["keypoint_scores"],
            np.float32,
        )
    elif "keypoint_scores" in info:
        scores = np.asarray(info["keypoint_scores"], np.float32)
    else:
        scores = np.ones(len(kpts), np.float32)
    depths = np.asarray(info.get("keypoint_depths", np.zeros_like(scores)), np.float32)
    scores = scores.copy()
    scores[kpts.min(axis=1) < 0] = 0.0

    # draw at 2048p for anti-aliasing, downsample at the end
    drawing_scale = 2048 / max(out_kpmap_shape)
    out_shape = (np.asarray(out_kpmap_shape) * drawing_scale).astype(np.int64)
    canvas_shape = np.asarray(kp2d_canvas_shape, np.float64)
    scale_ratio = out_shape.min() / canvas_shape.min()
    kpts = kpts * scale_ratio
    kpts += (out_shape.min() - canvas_shape.min() * scale_ratio) / 2

    canvas = np.zeros((out_shape[0], out_shape[1], 3), np.uint8)
    colors = coco_wholebody_keypoint_colors()
    skeleton = dict(coco_wholebody_skeleton())
    skeleton.update(EXTRA_CROSS_LINKS)

    n_links = len(skeleton)
    radii = np.full(n_links, int(round(radius * scale_ratio)), np.int64)
    thick = np.full(n_links, int(round(thickness * scale_ratio)), np.int64)
    radii[:25] *= 2  # major body links doubled
    thick[:25] *= 2

    lines = []
    for skid, link in skeleton.items():
        i1, i2 = link["link"]
        line_score = min(scores[i1], scores[i2])
        if line_score < low_thr:
            continue
        lines.append(
            {
                "p1": (int(round(kpts[i1][0])), int(round(kpts[i1][1]))),
                "p2": (int(round(kpts[i2][0])), int(round(kpts[i2][1]))),
                "depth": (float(depths[i1]) + float(depths[i2])) / 2,
                "score": float(line_score),
                "p1_color": score_to_color(colors[i1], scores[i1], low_thr, high_thr),
                "p2_color": score_to_color(colors[i2], scores[i2], low_thr, high_thr),
                "line_color": score_to_color(link["color"], line_score, low_thr, high_thr),
                "radius": int(radii[skid]),
                "thickness": int(thick[skid]),
            }
        )

    if (depths != 0.0).any():
        lines.sort(key=lambda x: x["depth"], reverse=True)  # far first
    elif (scores != 1.0).any():
        lines.sort(key=lambda x: x["score"])

    for ln in lines:
        _draw_line(canvas, ln["p1"], ln["p2"], ln["line_color"], ln["thickness"])
        _draw_circle(canvas, ln["p1"], ln["radius"], ln["p1_color"])
        _draw_circle(canvas, ln["p2"], ln["radius"], ln["p2_color"])

    os.makedirs(osp.dirname(out_kpmap_path), exist_ok=True)
    img = Image.fromarray(canvas)
    img = img.resize(
        (int(out_shape[1] / drawing_scale), int(out_shape[0] / drawing_scale))
    )
    img.save(out_kpmap_path, quality=image_quality)


def draw_skeletons(
    kp2d_dir: str,
    out_kpmap_dir: str,
    kp2d_canvas_shape=(1024, 1024),
    out_kpmap_shape=(1024, 1024),
    image_ext: str = ".webp",
    num_workers: int = 8,
    skip_exists: bool = True,
) -> int:
    """Directory walk + parallel drawing (draw_skeleton.py:183-220)."""
    jobs = []
    for spa in sorted(os.listdir(kp2d_dir)):
        for f in sorted(os.listdir(osp.join(kp2d_dir, spa))):
            if not f.endswith(".json"):
                continue
            src = osp.join(kp2d_dir, spa, f)
            dst = osp.join(out_kpmap_dir, spa, f.replace(".json", image_ext))
            jobs.append((src, dst))
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        list(
            pool.map(
                lambda j: draw_one_skeleton(
                    j[0],
                    j[1],
                    kp2d_canvas_shape=kp2d_canvas_shape,
                    out_kpmap_shape=out_kpmap_shape,
                    skip_exists=skip_exists,
                ),
                jobs,
            )
        )
    return len(jobs)
