"""Result writing: final per-(camera, frame) images, debug grids,
completeness checks (reference: src/samplers/utils/sampling_utils.py:54-129).

Differences by design:
  * the reference VAE-decodes the *entire* sequence after every task to
    build debug grids (sampling_utils.py:70-93) — here debug grids are
    opt-in, and only fully-denoised target rows are decoded for final
    output, saving one full VAE decode pass per non-final round
  * final images are crop-restored to the original camera resolution and
    saved as JPEG quality 95, skipping files that already exist
    (sampling_utils.py:96-111)
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
from diffuman4d_torch.data.images import restore_cropped_image, to_pil


def save_final_images(
    images: np.ndarray,  # (N, H, W, 3) in [0, 1] — decoded rows
    labels: list[tuple[str, str, str]],
    crops: list[list[int]],
    output_dir: str,
    skip_exists: bool = True,
) -> list[str]:
    """Write images/{spa}/{tem}.jpg with crop restoration. Returns paths."""
    paths = []
    for img, (_, spa, tem), crop in zip(images, labels, crops):
        path = osp.join(output_dir, "images", spa, f"{tem}.jpg")
        paths.append(path)
        if skip_exists and osp.isfile(path):
            continue
        os.makedirs(osp.dirname(path), exist_ok=True)
        restored = restore_cropped_image(to_pil(img), crop)
        to_pil(restored).save(path, quality=95)
    return paths


def save_debug_grid(
    rows: dict[str, np.ndarray],  # name -> (N, H, W, 3) in [0, 1]
    output_dir: str,
    task_label: str,
    max_cols: int = 12,
    thumb: int = 128,
) -> str:
    """Stack named image rows into one debug grid JPEG
    (sampling_utils.py:70-93 writes skeleton/input/output/error rows)."""
    import PIL.Image as PILImage

    names = list(rows)
    n = min(min(v.shape[0] for v in rows.values()), max_cols)
    grid = np.concatenate(
        [
            np.concatenate(
                [
                    np.asarray(
                        to_pil(rows[name][i]).resize((thumb, thumb), PILImage.BILINEAR),
                        dtype=np.float32,
                    )
                    / 255.0
                    for i in range(n)
                ],
                axis=1,
            )
            for name in names
        ],
        axis=0,
    )
    path = osp.join(output_dir, "grids", f"{task_label}.jpg")
    os.makedirs(osp.dirname(path), exist_ok=True)
    to_pil(grid).save(path, quality=90)
    return path


def check_sampling_results(
    spa_labels: list[str], tem_labels: list[str], output_dir: str
) -> bool:
    """All |cams| x |frames| images present? (sampling_utils.py:117-129)."""
    expected = len(spa_labels) * len(tem_labels)
    found = 0
    for spa in spa_labels:
        d = osp.join(output_dir, "images", spa)
        if osp.isdir(d):
            found += sum(1 for f in os.listdir(d) if f.endswith(".jpg"))
    if found != expected:
        print(f"[outputs] found {found} images, expected {expected}")
    return found == expected


def save_json(obj, path: str) -> None:
    os.makedirs(osp.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
