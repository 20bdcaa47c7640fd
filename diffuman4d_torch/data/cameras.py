"""Camera parsing and scene normalization.

Behavioral parity targets (reference: src/data/utils/camera_parser.py):
  * parse nerfstudio ``transforms.json`` with per-frame or global intrinsics
    keyed by ``camera_label`` (camera_parser.py:29-46)
  * OpenGL -> OpenCV handedness flip of columns 1:3 (camera_parser.py:43)
  * easyvolcap ``intri/extri.yml`` directories (camera_parser.py:49-68)
  * scene normalization: center = bbox center of camera positions,
    scale = 1/||bbox diagonal|| (camera_parser.py:7-17), optionally pinned
    by a persisted ``scene_norm.json`` (camera_parser.py:78-85)

Everything here is host-side NumPy (float64 for pose inverses, cast to
float32 at the boundary); no torch.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from dataclasses import dataclass

import numpy as np


@dataclass
class Camera:
    """A single camera: OpenCV-convention intrinsics + camera-to-world pose."""

    K: np.ndarray  # (3, 3) float32
    pose: np.ndarray  # (4, 4) float32 camera-to-world
    height: int
    width: int


def calc_scene_scale(points: np.ndarray) -> tuple[np.ndarray, float]:
    """Center and scale from the bounding box of ``points`` (N, 3).

    center = bbox midpoint; scale = 1 / ||bbox diagonal||.
    Mirrors camera_parser.py:8-13.
    """
    min_bound = points.min(axis=0)
    max_bound = points.max(axis=0)
    center = (min_bound + max_bound) / 2.0
    scale = 1.0 / float(np.linalg.norm(max_bound - min_bound))
    return center, scale


def normalize_poses(
    poses: np.ndarray,
    center: np.ndarray | None = None,
    scale: float | None = None,
) -> np.ndarray:
    """Translate/scale camera centers so the scene fits a unit-ish box.

    Returns a new array (the reference mutates in place; we stay functional).
    Mirrors camera_parser.py:7-17.
    """
    poses = np.array(poses, copy=True)
    if center is None or scale is None:
        center, scale = calc_scene_scale(poses[:, :3, 3])
    poses[:, :3, 3] = (poses[:, :3, 3] - center) * scale
    return poses


def _parse_nerfstudio(camera_path: str) -> tuple[list[str], list, list, list]:
    with open(camera_path, "r") as f:
        tfs = json.load(f)

    labels, Ks, hws, poses = [], [], [], []
    for cam in tfs["frames"]:
        if all(k in cam for k in ("fl_x", "fl_y", "cx", "cy")):
            fx, fy, cx, cy = cam["fl_x"], cam["fl_y"], cam["cx"], cam["cy"]
        else:
            fx, fy, cx, cy = tfs["fl_x"], tfs["fl_y"], tfs["cx"], tfs["cy"]
        Ks.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64))
        hws.append((int(cam["h"]), int(cam["w"])))
        pose = np.array(cam["transform_matrix"], dtype=np.float64)
        # nerfstudio transforms are OpenGL; flip to OpenCV (camera_parser.py:43)
        pose[:3, 1:3] *= -1
        poses.append(pose)
        labels.append(str(cam["camera_label"]))
    return labels, Ks, hws, poses


def _parse_easyvolcap(camera_path: str) -> tuple[list[str], list, list, list]:
    # easyvolcap intri.yml/extri.yml (camera_parser.py:49-68). We parse the
    # OpenCV-YAML files directly instead of importing easyvolcap.
    from diffuman4d_torch.data.easyvolcap_io import read_easyvolcap_cameras

    cams = read_easyvolcap_cameras(camera_path)
    labels, Ks, hws, poses = [], [], [], []
    for label, cam in cams.items():
        h, w = cam["H"], cam["W"]
        if h < 0 or w < 0:
            raise ValueError(f"Invalid camera height or width: {h}, {w}")
        Ks.append(np.asarray(cam["K"], dtype=np.float64).reshape(3, 3))
        hws.append((int(h), int(w)))
        w2c = np.eye(4, dtype=np.float64)
        w2c[:3, :] = np.asarray(cam["RT"], dtype=np.float64)
        poses.append(np.linalg.inv(w2c))
        labels.append(str(label))
    return labels, Ks, hws, poses


def parse_cameras(
    camera_path: str,
    coord_system: str = "opencv",
    normalize_scene: bool = True,
) -> dict[str, Camera]:
    """Parse nerfstudio/easyvolcap cameras into ``{label: Camera}``.

    Mirrors camera_parser.py:20-91 (OpenCV is the internal convention;
    ``coord_system='opengl'`` flips back).
    """
    if camera_path.endswith(".json"):
        labels, Ks, hws, poses = _parse_nerfstudio(camera_path)
    elif osp.isdir(camera_path) or camera_path.endswith(".yml"):
        labels, Ks, hws, poses = _parse_easyvolcap(camera_path)
    else:
        raise ValueError(f"Unsupported camera file: {camera_path}")

    poses = np.stack(poses)
    if coord_system == "opengl":
        poses[:, 0:3, 1:3] *= -1
    elif coord_system != "opencv":
        raise ValueError(f"Unknown coord_system: {coord_system}")

    if normalize_scene:
        # parity with camera_parser.py:78: the probe path is joined onto
        # camera_path itself, so persisted normalization is only ever found
        # for easyvolcap DIRECTORY inputs (for transforms.json inputs the
        # reference also never finds it)
        norm_json = f"{camera_path}/scene_norm.json"
        center = scale = None
        if os.path.isfile(norm_json):
            with open(norm_json) as f:
                norm_data = json.load(f)
            center = np.asarray(norm_data["center"], dtype=np.float64)
            scale = float(norm_data["scale"])
        poses = normalize_poses(poses, center=center, scale=scale)

    data: dict[str, Camera] = {}
    for label, K, hw, pose in zip(labels, Ks, hws, poses):
        data[label] = Camera(
            K=K.astype(np.float32),
            pose=pose.astype(np.float32),
            height=hw[0],
            width=hw[1],
        )
    return data


def nearest_input_camera(
    target_pose: np.ndarray, input_poses: list[np.ndarray]
) -> int:
    """Index of the input camera whose center is closest to the target's.

    The reference prepends this camera's frames as the condition track of
    every temporal sample (spatem_dataset.py:98-104).
    """
    tpos = np.asarray(target_pose)[:3, 3]
    ipos = np.stack([np.asarray(p)[:3, 3] for p in input_poses])
    d = np.linalg.norm(ipos - tpos[None], axis=1)
    return int(np.argmin(d))


def transform_intrinsic_for_crop(
    K: np.ndarray, crop: tuple[int, int, int, int, int, int], out_size: int
) -> np.ndarray:
    """Adjust K for a (top,left,h,w,...) crop followed by a resize to
    ``out_size`` square. Mirrors spatem_dataset.py:68-75."""
    top, left, height = crop[0], crop[1], crop[2]
    K = np.array(K, copy=True, dtype=np.float64)
    K[0, 2] -= left
    K[1, 2] -= top
    K = K * (out_size / height)
    K[2, 2] = 1.0
    return K.astype(np.float32)
