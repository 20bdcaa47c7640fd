"""Quality metrics: masked + bbox-cropped PSNR / SSIM / LPIPS (the port's
counterpart of ``diffuman4d_tpu/data/metrics.py``; reference:
src/data/utils/metric_utils.py:14-235).

Protocol parity:
  * both pred and GT composited onto the same background with the
    foreground mask (:48-57, default black)
  * nearest-resize so the smaller edge is ``canvas_size`` (:104-112)
  * crop to the union foreground bbox with 8px padding (:22-46, 114-123);
    raise if the crop is tiny (<2% of pixels)
  * PSNR data_range 1.0; SSIM 11x11 gaussian (sigma 1.5), torchmetrics
    defaults; LPIPS(VGG, normalize=True) -- LPIPS needs pretrained VGG16
    weights; when none are available it returns NaN and the aggregate
    reports it as null instead of failing the run.

The masking and cropping are numpy (copied); PSNR, SSIM and LPIPS run in
torch on the caller's device, per image, as the reference loops
(:134-137). SSIM's gaussian blur is two banded matrix products in fp64
(the JAX package convolves at full fp32 precision).
"""

from __future__ import annotations

import logging
import os
import os.path as osp

import numpy as np
import torch
from PIL import Image

from diffuman4d_torch.data.images import to_float

log = logging.getLogger(__name__)


def psnr(pred: torch.Tensor, gt: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred.float() - gt.float()) ** 2)
    return 10.0 * torch.log10(data_range**2 / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _band(n: int, g: torch.Tensor) -> torch.Tensor:
    """(n - k + 1, n) matrix whose product with a length-n signal is the
    signal's 'valid' correlation with the k taps ``g``."""
    k = g.shape[0]
    rows = torch.arange(n - k + 1, device=g.device)[:, None] + torch.arange(k, device=g.device)
    band = torch.zeros((n - k + 1, n), dtype=g.dtype, device=g.device)
    return band.scatter_(1, rows, g.expand(n - k + 1, k))


def ssim(
    pred: torch.Tensor,  # (H, W, C) in [0, 1]
    gt: torch.Tensor,
    data_range: float = 1.0,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Gaussian-window SSIM, torchmetrics defaults (11x11, sigma 1.5),
    'valid' padding mean over the SSIM map."""
    x = pred.double().permute(2, 0, 1)
    y = gt.double().permute(2, 0, 1)
    g = torch.from_numpy(_gaussian_kernel()).to(x)  # symmetric: correlation = convolution
    bh, bw = _band(x.shape[1], g), _band(x.shape[2], g)

    def blur(t):  # separable gaussian, valid padding
        return bh @ t @ bw.T

    mu_x, mu_y = blur(x), blur(y)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = blur(x * x) - mu_x2
    sigma_y = blur(y * y) - mu_y2
    sigma_xy = blur(x * y) - mu_xy
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    ssim_map = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sigma_x + sigma_y + c2)
    )
    return torch.mean(ssim_map).float()


class LPIPS:
    """LPIPS(VGG16) -- architecture implemented, weights loadable from a
    local file (``$LPIPS_WEIGHTS``). Returns NaN when weights are
    unavailable; no pretrained VGG16 weights ship with the repo
    (docs/LPIPS_WEIGHTS.md gives the npz schema)."""

    def __init__(self, weights_path: str | None = None, device: torch.device | str = "cpu"):
        self.model = None
        path = weights_path or os.environ.get("LPIPS_WEIGHTS", "")
        if path and osp.isfile(path):
            from diffuman4d_torch.data.lpips_vgg import VGG16LPIPS

            # validated: loud, not a silent NaN downstream
            self.model = VGG16LPIPS.from_weights(dict(np.load(path)), device)
        else:
            log.warning(
                "LPIPS weights unavailable (looked at %s) -- metrics.json "
                "will report lpips=null. Produce lpips_vgg.npz with "
                "scripts/extract_lpips_weights.py on a host with "
                "torchvision VGG16 + LPIPS lin heads and point "
                "$LPIPS_WEIGHTS at it; schema: docs/LPIPS_WEIGHTS.md",
                path or "$LPIPS_WEIGHTS (unset)",
            )

    @property
    def available(self) -> bool:
        return self.model is not None

    def __call__(self, pred: np.ndarray, gt: np.ndarray) -> float:
        if not self.available:
            return float("nan")
        from diffuman4d_torch.data.lpips_vgg import lpips_distance

        return lpips_distance(self.model, pred, gt)


class ImageEvaluator:
    def __init__(self, lpips_weights: str | None = None, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.lpips = LPIPS(lpips_weights, self.device)

    @staticmethod
    def mask_to_bbox(fmask: np.ndarray, padding: int = 8):
        if fmask.ndim == 3:
            fmask = fmask[..., 0]
        rows = np.nonzero(np.any(fmask != 0, axis=1))[0]
        cols = np.nonzero(np.any(fmask != 0, axis=0))[0]
        if rows.size == 0 or cols.size == 0:
            return None
        return (
            max(int(cols[0]) - padding, 0),
            max(int(rows[0]) - padding, 0),
            min(int(cols[-1]) + 1 + padding, fmask.shape[1]),
            min(int(rows[-1]) + 1 + padding, fmask.shape[0]),
        )

    @staticmethod
    def _apply_fmask(image, fmask, background_color):
        if background_color == "black":
            return image * fmask
        if background_color == "white":
            return image * fmask + (1.0 - fmask)
        if background_color == "grey":
            return image * fmask + (1.0 - fmask) * 0.5
        raise ValueError(f"Invalid background color: {background_color}")

    @staticmethod
    def _nearest_resize_short_edge(img: np.ndarray, size: int) -> np.ndarray:
        h, w = img.shape[:2]
        if min(h, w) == size:
            return img
        if h < w:
            nh, nw = size, int(size * w / h)
        else:
            nh, nw = int(size * h / w), size
        ii = np.minimum((np.arange(nh) * h / nh).astype(np.int64), h - 1)
        jj = np.minimum((np.arange(nw) * w / nw).astype(np.int64), w - 1)
        return img[ii][:, jj]

    def __call__(
        self,
        pred,
        gt,
        pred_fmask=None,
        gt_fmask=None,
        canvas_size: int = 1024,
        crop_with_fmask: bool = True,
        background_color: str = "black",
    ) -> tuple[float, float, float]:
        load = lambda x: to_float(Image.open(x)) if isinstance(x, str) else x
        pred, gt = load(pred), load(gt)
        pred_fmask, gt_fmask = load(pred_fmask), load(gt_fmask)

        if gt.shape != pred.shape:
            raise ValueError("The GT and predicted images must share a shape.")
        if crop_with_fmask and pred_fmask is None and gt_fmask is None:
            raise ValueError("crop_with_fmask requires a foreground mask.")

        if gt_fmask is not None:
            gt = self._apply_fmask(gt, gt_fmask[..., :1], background_color)
        if pred_fmask is not None:
            pred = self._apply_fmask(pred, pred_fmask[..., :1], background_color)

        if canvas_size != gt.shape[1]:
            gt = self._nearest_resize_short_edge(gt, canvas_size)
            pred = self._nearest_resize_short_edge(pred, canvas_size)
            if gt_fmask is not None:
                gt_fmask = self._nearest_resize_short_edge(gt_fmask, canvas_size)
            if pred_fmask is not None:
                pred_fmask = self._nearest_resize_short_edge(pred_fmask, canvas_size)

        if crop_with_fmask:
            obbs = [
                self.mask_to_bbox(m) for m in (gt_fmask, pred_fmask) if m is not None
            ]
            obbs = [b for b in obbs if b is not None]
            if obbs:
                left = min(b[0] for b in obbs)
                top = min(b[1] for b in obbs)
                right = max(b[2] for b in obbs)
                bottom = max(b[3] for b in obbs)
                # NOTE: gt.size includes the channel axis, so this is
                # effectively a 6%-of-pixels threshold — intentional parity
                # with the reference, which compares against gt.numel()
                # on a (3, H, W) tensor (metric_utils.py:120)
                if (right - left) * (bottom - top) < gt.size * 0.02:
                    raise ValueError("Cropped region too small; check the data.")
                gt = gt[top:bottom, left:right]
                pred = pred[top:bottom, left:right]

        if gt.min() < -1e-6 or gt.max() > 1 + 1e-6:
            raise ValueError("GT image must be in [0, 1].")
        if pred.min() < -1e-6 or pred.max() > 1 + 1e-6:
            raise ValueError("Predicted image must be in [0, 1].")

        p_t = torch.as_tensor(np.asarray(pred, np.float32), device=self.device)
        g_t = torch.as_tensor(np.asarray(gt, np.float32), device=self.device)
        p = float(psnr(p_t, g_t))
        s = float(ssim(p_t, g_t))
        l = self.lpips(pred, gt)
        return p, s, l


def evaluate_results(
    data_dir: str,
    scene_label: str,
    output_dir: str,
    input_spa_labels: list[str],
    canvas_size: int = 1024,
    lpips_weights: str | None = None,
    device: torch.device | str = "cpu",
) -> dict:
    """Evaluate generated images vs GT (metric_utils.py:140-235) on
    ``device``. Returns {"mean": {...}, "values": [...]} and writes
    metrics.json."""
    from diffuman4d_torch.sampling.outputs import save_json

    pred_dir = osp.join(output_dir, "images")
    gt_dir = osp.join(data_dir, scene_label, "images")
    fmask_dir = osp.join(data_dir, scene_label, "fmasks")

    spa_labels = sorted(os.listdir(pred_dir))
    evaluator = ImageEvaluator(lpips_weights, device)

    jobs = []
    for spa in spa_labels:
        if spa in input_spa_labels:
            continue
        for f in sorted(os.listdir(osp.join(pred_dir, spa))):
            tem = f.split(".")[0]
            gt_path = None
            for ext in (".webp", ".jpg", ".png"):
                cand = osp.join(gt_dir, spa, tem + ext)
                if osp.isfile(cand):
                    gt_path = cand
                    break
            if gt_path is None:
                continue
            fmask_path = osp.join(fmask_dir, spa, tem + ".png")
            fmask = fmask_path if osp.isfile(fmask_path) else None
            jobs.append((spa, tem, osp.join(pred_dir, spa, f), gt_path, fmask))

    # IO-parallel evaluation (the reference splits across GPUs,
    # metric_utils.py:195-220; here decode/IO threads overlap the metric
    # compute)
    from concurrent.futures import ThreadPoolExecutor

    def one(job):
        spa, tem, pred_path, gt_path, fmask = job
        p, s, l = evaluator(
            pred=pred_path, gt=gt_path, pred_fmask=fmask, gt_fmask=fmask,
            canvas_size=canvas_size,
        )
        return {"key": f"{spa}/{tem}", "psnr": p, "ssim": s, "lpips": l}

    with ThreadPoolExecutor(max_workers=4) as pool:
        values = list(pool.map(one, jobs))

    values.sort(key=lambda x: x["key"])
    lp = [v["lpips"] for v in values if not np.isnan(v["lpips"])]
    metrics = {
        "mean": {
            "psnr": round(float(np.mean([v["psnr"] for v in values])), 3) if values else None,
            "ssim": round(float(np.mean([v["ssim"] for v in values])), 3) if values else None,
            "lpips": round(float(np.mean(lp)), 3) if lp else None,
        },
        "values": values,
    }
    save_json(metrics, osp.join(output_dir, "metrics.json"))
    return metrics
