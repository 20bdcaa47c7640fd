"""Multi-view skeleton triangulation (reference:
scripts/preprocess/utils/triang_utils.py + triangulate_skeleton.py).

Per keypoint: score-thresholded view selection (top-`max_views` by
percentile, absolute threshold 0.6, >=3 views), score-weighted linear DLT,
Huber-robust nonlinear refinement (scipy trf), weighted reprojection error;
then reprojection of the 3D skeleton to all cameras *with depth* — the
depths drive the painter's-algorithm ordering in the skeleton drawer.

Score massaging parity: finger scores are damped by the squared hand-root
score (triangulate_skeleton.py:27-29); face keypoint scores are reweighted
by the cosine between face normal and camera axis (triang_utils.py:34-48).

The DLT here is vectorized over views (no per-view Python loop); the
per-keypoint loop remains (133 independent small problems, scipy-bound).

The port's own copy of ``diffuman4d_tpu/preprocess/triangulate.py`` (numpy
only), held bit-equal to it by ``tests/test_torch_port_preprocess.py``.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
from scipy.optimize import least_squares

INVALID = -1e6


def project_points(
    kp3d: np.ndarray,  # (k, 3) world
    Ks: np.ndarray,  # (m, 3, 3)
    Ts: np.ndarray,  # (m, 4, 4) world -> camera
) -> tuple[np.ndarray, np.ndarray]:
    """-> kp2d (m, k, 2), depth (m, k); invalid keypoints propagate."""
    P = Ks @ Ts[:, :3]  # (m, 3, 4)
    kph = np.concatenate([kp3d, np.ones((len(kp3d), 1))], axis=1)  # (k, 4)
    proj = np.einsum("mij,kj->mki", P, kph)  # (m, k, 3)
    depth = proj[..., 2]
    kp2d = proj[..., :2] / (depth[..., None] + 1e-9)
    bad = (kp3d == INVALID).any(axis=1)  # (k,)
    kp2d[:, bad] = INVALID
    depth[:, bad] = INVALID
    return kp2d, depth


def face_view_scores(kp3d: np.ndarray, Ts: np.ndarray) -> np.ndarray:
    """Per-camera face visibility in [0, 1] from the face-plane normal
    (nose, eyes) vs camera optical axis (triang_utils.py:34-48)."""
    nose, left_eye, right_eye = kp3d[0], kp3d[1], kp3d[2]
    eye_mid = (left_eye + right_eye) / 2
    normal = np.cross(right_eye - left_eye, nose - eye_mid)
    normal = normal / (np.linalg.norm(normal) + 1e-12)
    cam_axis = Ts[:, 2, :3]  # camera z in world
    return -cam_axis @ normal * 0.5 + 0.5


def damp_finger_scores(scores: np.ndarray) -> np.ndarray:
    """Fingers inherit the squared hand-root confidence
    (triangulate_skeleton.py:27-29). scores: (133,)"""
    out = scores.copy()
    out[92:112] *= scores[91] ** 2
    out[113:133] *= scores[112] ** 2
    return out


def triangulate_one_point(
    Ks: np.ndarray,
    Ts: np.ndarray,
    kp2d: np.ndarray,  # (m, 2)
    kp2d_score: np.ndarray | None = None,
    min_views: int = 3,
    max_views: int = 24,
    score_thr: float = 0.6,
):
    """-> (kp3d (3,) | None, weighted reproj error | None, n_views)."""
    m = len(kp2d)
    score = np.ones(m) if kp2d_score is None else np.asarray(kp2d_score, float)

    thr = score_thr
    if max_views is not None:
        mv = min(max_views, m)
        thr = max(thr, np.percentile(score, 100 * (1 - mv / m)))
    mask = score >= thr
    n_views = int(mask.sum())
    if n_views < min_views:
        return None, None, n_views

    Ks, Ts = Ks[mask], Ts[mask]
    uv = kp2d[mask]
    s = score[mask]
    valid = (s > 0) & (uv >= 0).all(axis=1)
    Ks, Ts, uv, s = Ks[valid], Ts[valid], uv[valid], s[valid]
    if len(uv) < min_views:
        return None, None, int(valid.sum())

    # weighted linear DLT, vectorized: rows u*P3 - P1 and v*P3 - P2
    P = Ks @ Ts[:, :3]  # (v, 3, 4)
    rows_u = uv[:, 0, None] * P[:, 2] - P[:, 0]  # (v, 4)
    rows_v = uv[:, 1, None] * P[:, 2] - P[:, 1]
    A = np.concatenate([rows_u, rows_v], axis=0)
    w = np.sqrt(np.concatenate([s, s]))
    _, _, Vt = np.linalg.svd(A * w[:, None])
    h = Vt[-1]
    x0 = h[:3] / (h[3] + 1e-9)

    # Huber-robust refinement
    cw = np.repeat(np.sqrt(s), 2)

    def residual(x):
        kh = np.append(x, 1.0)
        pr = np.einsum("vij,j->vi", P, kh)
        pr2 = pr[:, :2] / (pr[:, 2:3] + 1e-9)
        return ((pr2 - uv).reshape(-1)) * cw

    sol = least_squares(residual, x0, method="trf", loss="huber", f_scale=1.0, max_nfev=50)
    x = sol.x

    kh = np.append(x, 1.0)
    pr = np.einsum("vij,j->vi", P, kh)
    pr2 = pr[:, :2] / (pr[:, 2:3] + 1e-9)
    err = np.linalg.norm(pr2 - uv, axis=1)
    reproj = float((err * s).sum() / (s.sum() + 1e-9))
    return x, reproj, n_views


def triangulate_points(Ks, Ts, kp2d, kp2d_score=None, min_views=3, score_thr=0.6):
    """kp2d (n, k, 2), kp2d_score (n, k) -> kp3d (k, 3), reproj (k,),
    n_views (k,); INVALID fill for untriangulable keypoints."""
    n, k, _ = kp2d.shape
    if min_views < 3:
        raise ValueError(f"min_views must be >= 3, got {min_views}")
    if kp2d_score is None:
        kp2d_score = np.ones((n, k))

    kp3d = np.full((k, 3), INVALID)
    reproj = np.full((k,), INVALID)
    n_views = np.full((k,), INVALID)
    for i in range(k):
        x, r, v = triangulate_one_point(
            Ks, Ts, kp2d[:, i], kp2d_score[:, i], min_views=min_views, score_thr=score_thr
        )
        if x is not None:
            kp3d[i] = x
            reproj[i] = r
        n_views[i] = v
    return kp3d, reproj, n_views


# ---------------------------------------------------------------------------
# file-level pipeline (triangulate_skeleton.py)
# ---------------------------------------------------------------------------

def read_kp2d(path: str):
    with open(path) as f:
        inst = json.load(f)["instance_info"][0]
    kp = np.asarray(inst["keypoints"], float)
    score = np.asarray(inst.get("keypoint_scores", np.ones(len(kp))), float)
    score = damp_finger_scores(score) if len(score) == 133 else score
    return kp, score


def write_kp2d(path: str, kp, kp_depth=None, kp_score=None) -> None:
    inst = {"keypoints": np.asarray(kp).tolist()}
    if kp_depth is not None:
        inst["keypoint_depths"] = np.asarray(kp_depth).tolist()
    if kp_score is not None:
        inst["keypoint_scores"] = np.asarray(kp_score).tolist()
    os.makedirs(osp.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"instance_info": [inst]}, f)


def write_ply(path: str, points: np.ndarray) -> None:
    """Minimal ASCII PLY writer (no open3d dependency)."""
    points = np.asarray(points, float)
    points = points[(points != INVALID).all(axis=1)]
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
        )
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def triangulate_skeleton_dir(
    camera_path: str,
    kp2d_dir: str,
    out_kp3d_dir: str,
    out_kp2d_proj_dir: str | None = None,
    out_pcd_dir: str | None = None,
    skip_exists: bool = True,
) -> int:
    """Triangulate every frame's skeleton and reproject to all cameras
    (writes poses_3d/ and poses_2d/ trees, triangulate_skeleton.py:129-168)."""
    from diffuman4d_torch.data.cameras import parse_cameras

    cams = parse_cameras(camera_path, coord_system="opencv", normalize_scene=False)
    spa_labels = sorted(os.listdir(kp2d_dir))
    Ks = np.stack([cams[s].K for s in spa_labels]).astype(float)
    Ts = np.stack([np.linalg.inv(cams[s].pose.astype(float)) for s in spa_labels])
    tem_labels = sorted(
        f.split(".")[0] for f in os.listdir(osp.join(kp2d_dir, spa_labels[0]))
    )

    count = 0
    for tem in tem_labels:
        out_kp3d = osp.join(out_kp3d_dir, f"{tem}.json")
        if skip_exists and osp.isfile(out_kp3d):
            try:
                json.load(open(out_kp3d))
                continue
            except Exception:
                pass
        obs = [read_kp2d(osp.join(kp2d_dir, s, f"{tem}.json")) for s in spa_labels]
        kp2d = np.stack([o[0] for o in obs])
        score = np.stack([o[1] for o in obs])
        kp3d, reproj, _ = triangulate_points(Ks, Ts, kp2d, score)

        os.makedirs(out_kp3d_dir, exist_ok=True)
        with open(out_kp3d, "w") as f:
            json.dump(
                {
                    "instance_info": [
                        {"keypoints": kp3d.tolist(), "keypoint_reproj": reproj.tolist()}
                    ]
                },
                f,
            )
        if out_pcd_dir is not None:
            write_ply(osp.join(out_pcd_dir, f"{tem}.ply"), kp3d)

        if out_kp2d_proj_dir is not None:
            kp2d_proj, depth = project_points(kp3d, Ks, Ts)
            for i, s in enumerate(spa_labels):
                write_kp2d(
                    osp.join(out_kp2d_proj_dir, s, f"{tem}.json"),
                    kp2d_proj[i],
                    kp_depth=depth[i],
                )
        count += 1
    return count
