"""Mask-driven square cropping — host-side NumPy/PIL.

Behavioral parity targets (reference: src/data/utils/crop_utils.py):
  * bbox from any-nonzero rows/cols, expanded by 1px (crop_utils.py:7-19)
  * square crop centered on the bbox, min 70% of image height, clamped
    in-bounds, returned as [top, left, h, w, orig_h, orig_w]
    (crop_utils.py:22-66)
  * pseudo-mask from a skeleton map with padded bbox (crop_utils.py:69-80)
"""

from __future__ import annotations

import math

import numpy as np
from PIL import Image


def _to_float_mask(fmask) -> np.ndarray:
    """PIL image or array -> (H, W) float mask in [0, 1]."""
    if isinstance(fmask, Image.Image):
        fmask = np.asarray(fmask, dtype=np.float32) / 255.0
    else:
        fmask = np.asarray(fmask, dtype=np.float32)
    if fmask.ndim == 3:
        fmask = fmask.mean(axis=-1)
    return fmask


def _mask_2d(fmask) -> np.ndarray:
    """(H, W) mask with the same nonzero set as ``_to_float_mask``.

    2-D uint8 arrays pass through unconverted: the bbox logic below only
    tests ``!= 0``, and a nonnegative channel mean is nonzero iff any
    channel is — so callers may hand in raw u8 masks (or a u8 per-pixel
    channel max) and skip the fp32 conversion of a full frame."""
    if isinstance(fmask, np.ndarray) and fmask.ndim == 2 and fmask.dtype == np.uint8:
        return fmask
    return _to_float_mask(fmask)


def mask_to_bbox(fmask) -> tuple[int, int, int, int] | None:
    """(xmin, ymin, xmax, ymax) of nonzero mask pixels, expanded by 1px.

    Mirrors crop_utils.py:7-19 (returns None on an empty mask)."""
    m = _mask_2d(fmask)
    rows = np.nonzero(np.any(m != 0, axis=1))[0]
    cols = np.nonzero(np.any(m != 0, axis=0))[0]
    if rows.size == 0 or cols.size == 0:
        return None
    return int(cols[0]) - 1, int(rows[0]) - 1, int(cols[-1]) + 1, int(rows[-1]) + 1


def mask_crop_aspect_ratio(
    fmask,
    aspect_ratio: float = 1.0,
    center_principal_point: bool = False,
    min_crop_ratio: float = 0.7,
    crop_padding: int = 0,
) -> list[int]:
    """Square (or ``aspect_ratio``) crop around the mask bbox.

    Returns [top, left, height, width, orig_h, orig_w].
    Mirrors crop_utils.py:22-66. The reference draws ``padding`` from
    torch.randint(0, 1) == always 0 at inference; we expose it as the
    deterministic ``crop_padding`` argument instead.
    """
    m = _mask_2d(fmask)
    h, w = m.shape

    bbox = mask_to_bbox(m)
    if bbox is None:
        raise ValueError("mask_crop_aspect_ratio: empty foreground mask")
    return bbox_crop_aspect_ratio(
        bbox, h, w, aspect_ratio, center_principal_point, min_crop_ratio,
        crop_padding,
    )


def bbox_crop_aspect_ratio(
    bbox: tuple[int, int, int, int],
    h: int,
    w: int,
    aspect_ratio: float = 1.0,
    center_principal_point: bool = False,
    min_crop_ratio: float = 0.7,
    crop_padding: int = 0,
) -> list[int]:
    """:func:`mask_crop_aspect_ratio` from a precomputed ``mask_to_bbox``
    box — for callers that already know the bbox and can skip building a
    full-resolution mask."""
    xmin, ymin, xmax, ymax = bbox

    if center_principal_point:
        xctr, yctr = w / 2, h / 2
    else:
        xctr, yctr = (xmin + xmax) / 2, (ymin + ymax) / 2
    height = 2 * max(
        yctr - ymin, ymax - yctr, (xctr - xmin) * aspect_ratio, (xmax - xctr) * aspect_ratio
    )

    height = max(height, min_crop_ratio * h)

    if center_principal_point:
        max_height = 2 * min(h - yctr, yctr)
        max_width = 2 * min(w - xctr, xctr)
        height = min(height, max_height, max_width * aspect_ratio)
    width = int(height / aspect_ratio)
    xmin, ymin = xctr - width / 2, yctr - height / 2
    xmax, ymax = xctr + width / 2, yctr + height / 2

    padding = max(min(crop_padding, xmin, ymin, w - xmax, h - ymax), 0)
    xmin, ymin, xmax, ymax = xmin - padding, ymin - padding, xmax + padding, ymax + padding
    xmin, ymin = math.floor(xmin), math.floor(ymin)
    xmax, ymax = math.ceil(xmax), math.ceil(ymax)

    top, left = ymin, xmin
    return [top, left, ymax - ymin, xmax - xmin, h, w]


def skeleton_to_mask(skeleton, padding_ratio: float = 0.03) -> np.ndarray:
    """Pseudo foreground mask from a skeleton map: padded bbox filled with 1.

    Used when no GT target exists (spatem_dataset.py:124-127). Padding is
    3x larger at the top (head room). Mirrors crop_utils.py:69-80.
    Returns a float32 (H, W) mask in [0, 1].
    """
    if isinstance(skeleton, Image.Image):
        w, h = skeleton.size
    else:
        h, w = np.asarray(skeleton).shape[:2]
    py, px = int(h * padding_ratio), int(w * padding_ratio)
    pt = int(py * 3)

    fmask = _to_float_mask(skeleton)
    bbox = mask_to_bbox(fmask)
    if bbox is None:
        raise ValueError("skeleton_to_mask: empty skeleton map")
    xmin, ymin, xmax, ymax = bbox
    xmin, ymin = max(xmin - px, 0), max(ymin - pt, 0)
    xmax, ymax = min(xmax + px, w), min(ymax + py, h)
    fmask[ymin:ymax, xmin:xmax] = 1.0
    return fmask


def skeleton_crop_box(
    skeleton, padding_ratio: float = 0.03, **crop_kwargs
) -> list[int]:
    """``mask_crop_aspect_ratio(skeleton_to_mask(skeleton))`` in closed
    form, without materializing the full-resolution pseudo-mask.

    The pseudo-mask's nonzero set is exactly the padded-bbox rectangle
    (every nonzero skeleton pixel lies inside it), so the outer crop's
    ``mask_to_bbox`` of that rectangle is just the rectangle's corners
    expanded by 1px — computable from the skeleton bbox alone. Returns a
    bit-identical crop list; saves an (H, W) fp32 mask round-trip per
    frame."""
    skel = np.asarray(skeleton) if not isinstance(skeleton, Image.Image) else None
    if skel is not None and skel.ndim == 3 and skel.dtype == np.uint8:
        # u8 channel max has the same nonzero set as the fp channel mean
        nz = skel.max(axis=-1)
    else:
        nz = skeleton
    bbox = mask_to_bbox(nz)
    if bbox is None:
        raise ValueError("skeleton_to_mask: empty skeleton map")
    if isinstance(skeleton, Image.Image):
        w, h = skeleton.size
    else:
        h, w = skel.shape[:2]
    py, px = int(h * padding_ratio), int(w * padding_ratio)
    pt = int(py * 3)
    xmin, ymin, xmax, ymax = bbox
    # the filled rectangle of skeleton_to_mask...
    rxmin, rymin = max(xmin - px, 0), max(ymin - pt, 0)
    rxmax, rymax = min(xmax + px, w), min(ymax + py, h)
    # ...whose own mask_to_bbox is its corners expanded by 1px (slice
    # semantics: nonzero cols run rxmin..rxmax-1)
    return bbox_crop_aspect_ratio(
        (rxmin - 1, rymin - 1, rxmax, rymax), h, w, **crop_kwargs
    )
