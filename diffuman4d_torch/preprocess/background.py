"""Foreground-mask prediction / background removal (the port's own numpy
and PIL copy of ``diffuman4d_tpu/preprocess/background.py``, reference:
scripts/preprocess/remove_background.py).

The matting model is a pluggable stage with the reference's file contract:

* ``BiRefNetMatting`` loads a *local* BiRefNet checkpoint directory through
  ``transformers`` (no download: point ``model_dir`` at a local copy) and
  runs on the card unless ``device`` says otherwise (the JAX package's
  default is the CPU);
* ``ChromaKeyMatting`` is the dependency-free matting for synthetic /
  studio data: foreground = pixels far from the dominant border color.

Any callable image -> mask can be passed as ``matting``.

Outputs: fmasks/{cam}/{frame}.png (uint8), optional alpha composites
images_alpha/{cam}/{frame}.png (RGBA), resumable via skip_exists
(remove_background.py:57-70).
"""

from __future__ import annotations

import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image


class ChromaKeyMatting:
    """Border-color distance matting — checkpoint-free fallback."""

    def __init__(self, threshold: float = 0.12):
        self.threshold = threshold

    def __call__(self, image: np.ndarray) -> np.ndarray:
        # image (H, W, 3) in [0, 1] -> mask (H, W) in [0, 1]
        border = np.concatenate(
            [image[0], image[-1], image[:, 0], image[:, -1]], axis=0
        )
        bg = np.median(border, axis=0)
        dist = np.linalg.norm(image - bg[None, None], axis=-1)
        return (dist > self.threshold).astype(np.float32)


class BiRefNetMatting:
    """BiRefNet via transformers AutoModelForImageSegmentation (the exact
    model the reference loads, remove_background.py:15-21). Requires a local
    checkpoint directory; raises a clear error otherwise."""

    def __init__(self, model_dir: str, image_size: int = 1024, device: str = "cuda"):
        if not osp.isdir(model_dir):
            raise FileNotFoundError(
                f"BiRefNet checkpoint not found at {model_dir}. This environment "
                "has no network egress; place a local copy there or use "
                "ChromaKeyMatting."
            )
        import torch
        from transformers import AutoModelForImageSegmentation

        self.torch = torch
        self.device = device
        self.image_size = image_size
        self.model = (
            AutoModelForImageSegmentation.from_pretrained(model_dir, trust_remote_code=True)
            .to(device)
            .eval()
        )

    def __call__(self, image: np.ndarray) -> np.ndarray:
        torch = self.torch
        h, w = image.shape[:2]
        x = torch.from_numpy(image).permute(2, 0, 1)[None].float()
        x = torch.nn.functional.interpolate(x, (self.image_size, self.image_size),
                                            mode="bilinear")
        mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
        std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
        x = ((x - mean) / std).to(self.device)
        with torch.no_grad():
            pred = self.model(x)[-1].sigmoid()
        pred = torch.nn.functional.interpolate(pred, (h, w), mode="bilinear")
        return pred[0, 0].cpu().numpy().astype(np.float32)


def remove_background(
    images_dir: str,
    out_fmasks_dir: str,
    out_alpha_dir: str | None = None,
    matting=None,
    skip_exists: bool = True,
    num_workers: int = 4,
) -> int:
    """Walk images/{cam}/{frame}.*, write fmasks (and alpha composites)."""
    matting = matting or ChromaKeyMatting()

    jobs = []
    for cam in sorted(os.listdir(images_dir)):
        cam_dir = osp.join(images_dir, cam)
        if not osp.isdir(cam_dir):
            continue
        for f in sorted(os.listdir(cam_dir)):
            stem = osp.splitext(f)[0]
            jobs.append((osp.join(cam_dir, f), cam, stem))

    def process(job):
        src, cam, stem = job
        out_mask = osp.join(out_fmasks_dir, cam, f"{stem}.png")
        if skip_exists and osp.isfile(out_mask):
            try:
                Image.open(out_mask).verify()
                return
            except Exception:
                pass
        img = np.asarray(Image.open(src).convert("RGB"), np.float32) / 255.0
        mask = matting(img)
        os.makedirs(osp.dirname(out_mask), exist_ok=True)
        Image.fromarray((np.clip(mask, 0, 1) * 255).astype(np.uint8)).save(out_mask)
        if out_alpha_dir is not None:
            rgba = np.concatenate([img, mask[..., None]], axis=-1)
            out_alpha = osp.join(out_alpha_dir, cam, f"{stem}.png")
            os.makedirs(osp.dirname(out_alpha), exist_ok=True)
            Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(out_alpha)

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        list(pool.map(process, jobs))
    return len(jobs)
