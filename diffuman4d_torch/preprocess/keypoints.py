"""2D keypoint prediction (reference: scripts/preprocess/predict_keypoints.py
+ the vendored sapiens-lite demo pipeline).

The reference chain is RTMDet person detection -> Sapiens-2B top-down pose
(torchscript) -> UDP/DARK heatmap decode -> 133 COCO-WholeBody keypoints
JSON per image. The detector/pose networks are external checkpoints; they
are pluggable stages here with the same JSON file contract. The pure math —
UDP bbox warping, heatmap argmax, DARK Taylor-refinement decode
(pose_utils.py:55-180) — is implemented natively and unit-testable without
checkpoints.

The port's own copy of ``diffuman4d_tpu/preprocess/keypoints.py``, held
bit-equal to it by ``tests/test_torch_port_preprocess.py``; the torchscript
models run on the card unless ``device`` says otherwise (the JAX package's
default is the CPU).
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np


# ---------------------------------------------------------------------------
# pure math: UDP warp + DARK decode
# ---------------------------------------------------------------------------

def udp_warp_matrix(center: np.ndarray, scale: np.ndarray, rot_deg: float,
                    output_size: tuple[int, int]) -> np.ndarray:
    """Unbiased (UDP) affine from bbox space to network input space.
    center (2,), scale (2,) = bbox w/h, output_size (w, h) -> (2, 3)."""
    w_out, h_out = output_size
    rot = np.deg2rad(rot_deg)
    # unbiased scale: (out - 1) / scale
    sx = (w_out - 1) / scale[0]
    sy = (h_out - 1) / scale[1]
    cos, sin = np.cos(rot), np.sin(rot)
    m = np.array(
        [
            [cos * sx, -sin * sx, sx * (-center[0] * cos + center[1] * sin + 0.5 * scale[0])],
            [sin * sy, cos * sy, sy * (-center[0] * sin - center[1] * cos + 0.5 * scale[1])],
        ]
    )
    return m


def get_heatmap_maximum(heatmaps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(K, H, W) -> argmax locations (K, 2) xy and scores (K,); negative
    scores get location (-1, -1)."""
    K, H, W = heatmaps.shape
    flat = heatmaps.reshape(K, -1)
    idx = flat.argmax(axis=1)
    scores = flat[np.arange(K), idx]
    keypoints = np.stack([idx % W, idx // W], axis=-1).astype(np.float32)
    keypoints[scores <= 0] = -1
    return keypoints, scores


def _gaussian_blur_heatmaps(heatmaps: np.ndarray, kernel: int) -> np.ndarray:
    """Max-preserving per-channel gaussian modulation (pose_utils
    gaussian_blur): blur, then rescale so each channel keeps its max."""
    from scipy.ndimage import gaussian_filter

    sigma = (kernel - 1) / 6.0  # opencv kernel-size -> sigma relationship
    out = np.empty_like(heatmaps)
    for k in range(heatmaps.shape[0]):
        origin_max = heatmaps[k].max()
        blurred = gaussian_filter(heatmaps[k], sigma, mode="constant")
        bmax = blurred.max()
        out[k] = blurred * (origin_max / bmax) if bmax > 0 else blurred
    return out


def refine_keypoints_dark_udp(
    keypoints: np.ndarray, heatmaps: np.ndarray, blur_kernel_size: int = 11
) -> np.ndarray:
    """DARK-UDP Taylor refinement (pose_utils.py:100-151): log-modulated
    heatmaps, 2nd-order Taylor step at the integer argmax."""
    keypoints = keypoints.copy()
    K, H, W = heatmaps.shape
    hm = _gaussian_blur_heatmaps(heatmaps, blur_kernel_size)
    hm = np.log(np.clip(hm, 1e-3, 50.0))
    pad = np.pad(hm, ((0, 0), (1, 1), (1, 1)), mode="edge").reshape(-1)

    index = keypoints[:, 0] + 1 + (keypoints[:, 1] + 1) * (W + 2)
    index += (W + 2) * (H + 2) * np.arange(K)
    index = index.astype(int)
    i_ = pad[index]
    ix1 = pad[index + 1]
    iy1 = pad[index + W + 2]
    ix1y1 = pad[index + W + 3]
    ix1_y1_ = pad[index - W - 3]
    ix1_ = pad[index - 1]
    iy1_ = pad[index - 2 - W]

    dx = 0.5 * (ix1 - ix1_)
    dy = 0.5 * (iy1 - iy1_)
    dxx = ix1 - 2 * i_ + ix1_
    dyy = iy1 - 2 * i_ + iy1_
    dxy = 0.5 * (ix1y1 - ix1 - iy1 + 2 * i_ - ix1_ - iy1_ + ix1_y1_)

    grad = np.stack([dx, dy], axis=-1)[..., None]  # (K, 2, 1)
    hess = np.stack(
        [np.stack([dxx, dxy], -1), np.stack([dxy, dyy], -1)], axis=-2
    )  # (K, 2, 2)
    hess_inv = np.linalg.inv(hess + np.finfo(np.float32).eps * np.eye(2))
    keypoints -= (hess_inv @ grad)[..., 0]
    return keypoints


def udp_decode(
    heatmaps: np.ndarray,
    input_size: tuple[int, int],
    heatmap_size: tuple[int, int],
    blur_kernel_size: int = 11,
) -> tuple[np.ndarray, np.ndarray]:
    """(K, H, W) heatmaps -> keypoints (K, 2) in input-space pixels, scores
    (K,) (pose_utils.py:153-180)."""
    keypoints, scores = get_heatmap_maximum(heatmaps)
    keypoints = refine_keypoints_dark_udp(keypoints, heatmaps, blur_kernel_size)
    W, H = heatmap_size
    # parity with pose_utils.py:178: the reference rescales by
    # input_size/(heatmap_size - 1) (not the unbiased (in-1)/(hm-1)); the
    # sapiens checkpoints are trained under this convention
    keypoints = keypoints / np.array([W - 1, H - 1]) * np.array(input_size)
    return keypoints, scores


# ---------------------------------------------------------------------------
# model stages (external checkpoints, pluggable)
# ---------------------------------------------------------------------------

class TorchscriptPoseModel:
    """Sapiens-lite torchscript pose estimator (vis_pose.py:188-212 loads
    torchscript / torch.export checkpoints). Needs a local .pt2/.pt file."""

    def __init__(self, checkpoint_path: str, input_size=(768, 1024), device="cuda"):
        if not osp.isfile(checkpoint_path):
            raise FileNotFoundError(
                f"pose checkpoint not found: {checkpoint_path} (zero-egress "
                "environment; provide a local sapiens-lite torchscript file)"
            )
        import torch

        self.torch = torch
        if checkpoint_path.endswith(".pt2"):
            self.model = torch.export.load(checkpoint_path).module()
        else:
            self.model = torch.jit.load(checkpoint_path, map_location=device).eval()
        self.input_size = input_size  # (w, h)
        self.device = device

    def __call__(self, crops: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) [or (H, W, 3)] in [0,1] -> heatmaps (B, K, h, w)
        [or (K, h, w)]."""
        torch = self.torch
        single = crops.ndim == 3
        if single:
            crops = crops[None]
        mean = np.array([0.485, 0.456, 0.406], np.float32)
        std = np.array([0.229, 0.224, 0.225], np.float32)
        x = (crops - mean) / std
        x = torch.from_numpy(x.transpose(0, 3, 1, 2)).to(self.device)
        with torch.no_grad():
            hm = self.model(x)
        hm = hm.float().cpu().numpy()
        return hm[0] if single else hm


def nms_boxes(boxes: np.ndarray, iou_thr: float) -> np.ndarray:
    """Greedy NMS over (N, 5) xyxy+score boxes; returns kept indices
    (detector_utils.py:nms semantics: score-descending, IoU suppress)."""
    if len(boxes) == 0:
        return np.zeros(0, np.int64)
    x1, y1, x2, y2, sc = boxes.T
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    order = np.argsort(-sc)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-9)
        order = rest[iou <= iou_thr]
    return np.asarray(keep, np.int64)


class TorchscriptDetector:
    """Person detector from a local torchscript export. The exported model
    maps a (1, 3, H, W) float image to (boxes (N, 5) xyxy+score,
    labels (N,)); person boxes are kept at ``score_thr`` then NMS'd —
    the same post-processing the reference applies to RTMDet output
    (detector_utils.py:process_images_detector: cat_id=0, bbox_thr=0.3,
    nms_thr=0.3)."""

    def __init__(self, checkpoint_path: str, score_thr=0.3, nms_thr=0.3,
                 cat_id=0, device="cuda"):
        if not osp.isfile(checkpoint_path):
            raise FileNotFoundError(
                f"detector checkpoint not found: {checkpoint_path} "
                "(zero-egress environment; provide a local torchscript file)"
            )
        import torch

        self.torch = torch
        self.model = torch.jit.load(checkpoint_path, map_location=device).eval()
        self.score_thr, self.nms_thr, self.cat_id = score_thr, nms_thr, cat_id
        self.device = device

    def __call__(self, image: np.ndarray) -> np.ndarray:
        """(H, W, 3) in [0,1] -> (N, 5) person boxes, xyxy+score."""
        torch = self.torch
        x = torch.from_numpy(image.transpose(2, 0, 1))[None].to(self.device)
        with torch.no_grad():
            boxes, labels = self.model(x)
        boxes = boxes.float().cpu().numpy().reshape(-1, 5)
        labels = labels.cpu().numpy().reshape(-1)
        boxes = boxes[(labels == self.cat_id) & (boxes[:, 4] > self.score_thr)]
        return boxes[nms_boxes(boxes, self.nms_thr)]


class MaskDetector:
    """Foreground-mask bbox as the person detection — exact for studio
    captures where the subject is the only foreground (the reference runs
    RTMDet even there; masks make it redundant)."""

    def __call__(self, image: np.ndarray, mask: np.ndarray | None = None):
        from diffuman4d_torch.data.crops import mask_to_bbox

        if mask is None:
            return np.zeros((0, 5), np.float32)
        bb = mask_to_bbox(mask)
        if bb is None:
            return np.zeros((0, 5), np.float32)
        x0, y0, x1, y1 = bb
        return np.asarray([[max(x0, 0), max(y0, 0), x1, y1, 1.0]], np.float32)


def _udp_crop(image: np.ndarray, bbox, input_size, bbox_padding=1.25):
    """bbox -> aspect-matched UDP affine + warped crop (top-down prep,
    vis_pose.py's top_down_affine_transform equivalent)."""
    x0, y0, x1, y1 = bbox
    center = np.array([(x0 + x1) / 2, (y0 + y1) / 2])
    in_w, in_h = input_size
    bw, bh = (x1 - x0) * bbox_padding, (y1 - y0) * bbox_padding
    if bw / bh > in_w / in_h:
        bh = bw * in_h / in_w
    else:
        bw = bh * in_w / in_h
    m = udp_warp_matrix(center, np.array([bw, bh]), 0.0, (in_w, in_h))
    return m, _affine_sample(image, m, (in_w, in_h))


def _decode_to_image_space(heatmaps, m, input_size, heatmap_size=None):
    if heatmap_size is None:  # derive from the network output itself
        heatmap_size = (heatmaps.shape[-1], heatmaps.shape[-2])
    kpts, scores = udp_decode(heatmaps, input_size, heatmap_size)
    m_inv = np.linalg.inv(np.vstack([m, [0, 0, 1]]))
    kph = np.concatenate([kpts, np.ones((len(kpts), 1))], axis=1)
    kpts_img = (m_inv @ kph.T).T[:, :2]
    return {
        "instance_info": [
            {"keypoints": kpts_img.tolist(), "keypoint_scores": scores.tolist()}
        ]
    }


def predict_keypoints_for_image(
    image: np.ndarray,  # (H, W, 3) in [0, 1]
    pose_model,
    bbox: tuple[float, float, float, float] | None = None,
    heatmap_size: tuple[int, int] | None = None,
    bbox_padding: float = 1.25,
) -> dict:
    """Top-down single-person pose: bbox (or full image) -> UDP crop ->
    heatmaps -> DARK decode -> image-space keypoints JSON dict."""
    h, w = image.shape[:2]
    if bbox is None:
        bbox = (0.0, 0.0, float(w), float(h))
    in_size = pose_model.input_size
    m, crop = _udp_crop(image, bbox, in_size, bbox_padding)
    heatmaps = np.asarray(pose_model(crop))
    return _decode_to_image_space(heatmaps, m, in_size, heatmap_size)


def predict_keypoints_batch(
    images: list[np.ndarray],
    bboxes: list[tuple[float, float, float, float] | None],
    pose_model,
    batch_size: int = 4,
    heatmap_size: tuple[int, int] | None = None,
    bbox_padding: float = 1.25,
) -> list[dict]:
    """Batched top-down pose: warp every image's bbox crop, run the pose
    network in fixed-size batches (last batch zero-padded like the
    reference's fake_pad_images_to_batchsize, vis_pose.py:184-185), decode
    each heatmap back to its own image space."""
    in_size = pose_model.input_size
    ms, crops = [], []
    for img, bb in zip(images, bboxes):
        h, w = img.shape[:2]
        if bb is None:
            bb = (0.0, 0.0, float(w), float(h))
        m, crop = _udp_crop(img, bb, in_size, bbox_padding)
        ms.append(m)
        crops.append(crop)
    out: list[dict] = []
    for i in range(0, len(crops), batch_size):
        chunk = crops[i : i + batch_size]
        n = len(chunk)
        if n < batch_size:  # fixed batch => one compiled program
            chunk = chunk + [np.zeros_like(chunk[0])] * (batch_size - n)
        hms = np.asarray(pose_model(np.stack(chunk)))[:n]
        for j in range(n):
            out.append(
                _decode_to_image_space(hms[j], ms[i + j], in_size, heatmap_size)
            )
    return out


def _affine_sample(image: np.ndarray, m: np.ndarray, out_wh: tuple[int, int]) -> np.ndarray:
    """Bilinear warp of (H, W, C) by 2x3 affine (dst <- src mapping)."""
    w_out, h_out = out_wh
    m_full = np.vstack([m, [0, 0, 1]])
    inv = np.linalg.inv(m_full)
    ys, xs = np.mgrid[0:h_out, 0:w_out]
    ones = np.ones_like(xs)
    dst = np.stack([xs, ys, ones], axis=-1).reshape(-1, 3).T
    src = (inv @ dst)[:2].T.reshape(h_out, w_out, 2)
    x = np.clip(src[..., 0], 0, image.shape[1] - 1)
    y = np.clip(src[..., 1], 0, image.shape[0] - 1)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    x1 = np.minimum(x0 + 1, image.shape[1] - 1)
    y1 = np.minimum(y0 + 1, image.shape[0] - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    out = (
        image[y0, x0] * (1 - wx) * (1 - wy)
        + image[y0, x1] * wx * (1 - wy)
        + image[y1, x0] * (1 - wx) * wy
        + image[y1, x1] * wx * wy
    )
    return out.astype(np.float32)


def predict_keypoints_dir(
    images_dir: str,
    out_kp2d_dir: str,
    pose_model,
    detector=None,
    fmasks_dir: str | None = None,
    skip_exists: bool = True,
    batch_size: int = 4,
    num_workers: int = 4,
) -> int:
    """Walk images/{cam}/{frame}, write poses JSON per image — the full
    detector->pose driver the reference vendors (vis_pose.py:396-462):
    image/mask loading on a thread pool, a pluggable detection stage
    (``detector``; defaults to the fmask bbox when masks exist — exact for
    studio captures — else the full frame), fixed-size pose batches, and
    resume probes that re-run any unreadable JSON (skip_exists)."""
    import concurrent.futures as cf

    from PIL import Image as PILImage

    # resume probe: collect only the frames whose JSON is missing/corrupt
    todo: list[tuple[str, str, str]] = []  # (cam, file, out_path)
    for cam in sorted(os.listdir(images_dir)):
        cam_dir = osp.join(images_dir, cam)
        if not osp.isdir(cam_dir):
            continue
        for f in sorted(os.listdir(cam_dir)):
            stem = osp.splitext(f)[0]
            out = osp.join(out_kp2d_dir, cam, f"{stem}.json")
            if skip_exists and osp.isfile(out):
                try:
                    json.load(open(out))
                    continue
                except Exception:
                    pass
            todo.append((cam, f, out))

    def load(item):
        cam, f, out = item
        stem = osp.splitext(f)[0]
        img = np.asarray(
            PILImage.open(osp.join(images_dir, cam, f)).convert("RGB"),
            np.float32,
        ) / 255.0
        mask = None
        if fmasks_dir is not None:
            mpath = osp.join(fmasks_dir, cam, f"{stem}.png")
            if osp.isfile(mpath):
                mask = np.asarray(
                    PILImage.open(mpath).convert("L"), np.float32
                ) / 255.0
        return img, mask, out

    def detect(img, mask):
        if detector is not None:
            try:
                boxes = detector(img, mask)
            except TypeError:  # detectors that don't take masks
                boxes = detector(img)
            if len(boxes):  # highest-score person
                b = boxes[np.argmax(boxes[:, 4])]
                return (float(b[0]), float(b[1]), float(b[2]), float(b[3]))
            return None  # no detection -> full frame
        if mask is not None:
            bb = MaskDetector()(img, mask)
            if len(bb):
                return tuple(float(v) for v in bb[0, :4])
        return None

    count = 0
    workers = max(1, min(num_workers, os.cpu_count() or 1))
    with cf.ThreadPoolExecutor(workers) as pool:
        # IO-prefetch one batch ahead of the pose network
        for i in range(0, len(todo), batch_size):
            loaded = list(pool.map(load, todo[i : i + batch_size]))
            images = [im for im, _, _ in loaded]
            bboxes = [detect(im, mk) for im, mk, _ in loaded]
            results = predict_keypoints_batch(
                images, bboxes, pose_model, batch_size=batch_size
            )
            for (_, _, out), res in zip(loaded, results):
                os.makedirs(osp.dirname(out), exist_ok=True)
                with open(out, "w") as fp:
                    json.dump(res, fp)
                count += 1
    return count
