"""Host-side image transforms — NumPy/PIL, channels-last float32.

Behavioral parity targets (reference: src/data/utils/image_utils.py):
  * [0,1] <-> [-1,1] VAE normalization (image_utils.py:9-14)
  * foreground-mask compositing onto white/black/random backgrounds
    (image_utils.py:25-59)
  * crop+resize inversion: bicubic back-resize, paste into a full-res
    canvas (image_utils.py:62-93)

All image arrays here are (H, W, C) float32. PIL performs the actual
resampling (the reference routes through torchvision's PIL backend, so
PIL bicubic with antialias is the exact reference behavior).
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def norm_vae(img: np.ndarray) -> np.ndarray:
    """[0, 1] -> [-1, 1] (image_utils.py:13-14)."""
    return img * 2.0 - 1.0


def denorm_vae(img: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 1] (image_utils.py:9-10)."""
    return img * 0.5 + 0.5


def to_float(img: Image.Image | np.ndarray) -> np.ndarray:
    """PIL/uint8 -> (H, W, C) float32 in [0, 1]."""
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def to_pil(img: np.ndarray) -> Image.Image:
    """(H, W, C) float in [0, 1] — or already-quantized uint8 — -> PIL."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    return Image.fromarray(arr)


def crop_resize(
    img: Image.Image, crop: list[int], out_h: int, out_w: int, resample=Image.BICUBIC
) -> Image.Image:
    """Crop (top, left, h, w) then resize to (out_h, out_w).

    Mirrors spatem_dataset.py:56-62 (torchvision TF.crop + TF.resize bicubic
    antialias=True on PIL == PIL crop + PIL bicubic resize)."""
    top, left, ch, cw = crop[0], crop[1], crop[2], crop[3]
    img = img.crop((left, top, left + cw, top + ch))
    return img.resize((out_w, out_h), resample=resample)


def apply_fmask(
    image: np.ndarray,
    fmask: np.ndarray,
    background_color: str = "white",
    vae_normalized: bool = False,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Composite foreground onto a constant background (image_utils.py:25-59).

    image: (..., H, W, 3); fmask: (..., H, W, 1); both [0,1] (or [-1,1] when
    vae_normalized).
    """
    # materialize the channel broadcast: numpy's stride-0 inner loop for
    # (H, W, 3) * (H, W, 1) runs far slower than contiguous elementwise
    if fmask.shape[-1] == 1 and image.shape[-1] != 1:
        fmask = np.repeat(fmask, image.shape[-1], axis=-1)

    if background_color in ("white", "black"):
        # fused, allocation-lean forms of norm(denorm(I)*denorm(M) + bg):
        # fresh multi-MB temporaries page-fault on small hosts, so the
        # composite runs in two buffers with in-place ops.
        #   white, vae:  O = (M+1)(I-1)/2 + 1
        #   black, vae:  O = (M+1)(I+1)/2 - 1
        if vae_normalized:
            out = image - 1.0 if background_color == "white" else image + 1.0
            out *= fmask + 1.0
            out *= 0.5
            out += 1.0 if background_color == "white" else -1.0
            return out
        out = image * fmask
        if background_color == "white":
            out += 1.0
            out -= fmask
        return out

    if background_color != "random":
        raise ValueError(f"Invalid background color: {background_color}")
    if vae_normalized:
        image = denorm_vae(image)
        fmask = denorm_vae(fmask)
    rng = rng or np.random.default_rng()
    color = np.clip(rng.normal(0.0, 0.3, size=(3,)), 0.0, 1.0).astype(np.float32)
    out = image * fmask + color * (1.0 - fmask)
    if vae_normalized:
        out = norm_vae(out)
    return out


def restore_cropped_image(
    image: Image.Image | np.ndarray,
    crop_param: list[int],
    background_color: str = "white",
) -> np.ndarray:
    """Invert crop+resize: back-resize to the crop size, paste into an
    original-resolution canvas. Handles crops that extend out of bounds by
    padding with the background (image_utils.py:62-93).

    Returns (orig_h, orig_w, C) float32 in [0, 1].
    """
    if len(crop_param) != 6:
        raise ValueError(f"Invalid crop_param: {crop_param}")
    ct, cl, ch, cw, h, w = [int(v) for v in crop_param]

    if isinstance(image, np.ndarray):
        image = to_pil(image)
    image = image.resize((cw, ch), resample=Image.BICUBIC)
    arr = to_float(image)

    canvas = np.zeros((h * 2, w * 2, arr.shape[-1]), dtype=np.float32)
    if background_color == "white":
        canvas[...] = 1.0

    left = w // 2 + cl
    top = h // 2 + ct
    canvas[top : top + ch, left : left + cw] = arr
    return canvas[h // 2 : h * 3 // 2, w // 2 : w * 3 // 2]
