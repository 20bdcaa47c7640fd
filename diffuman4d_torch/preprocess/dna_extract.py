"""DNA-Rendering raw-capture extraction (reference:
scripts/download/extract_dnar_images.py + utils/SMCReader.py).

Raw ``.smc`` HDF5 capture files -> calibrated, undistorted, unified-
intrinsics 1024^2 webp images:

  * per-camera quadratic color-correction (CCM): rgb' = a*rgb^2 + b*rgb + c
    per channel (extract_dnar_images.py:90-105) — here a single vectorized
    numpy expression
  * OpenCV-model undistortion via cv2.undistort
  * resize to a unified focal (5MP cams 0-47: f = 2496*(s/1920);
    12MP cams 48-59: f = 3648*(s/1920)) then center-crop around the
    principal point (:20-86)

``SMCReader`` is a compact h5py reader for the DNA-Rendering capture
schema: calibration, JPEG-encoded color/mask frames, 2D/3D keypoints.

The port's own copy of ``diffuman4d_tpu/preprocess/dna_extract.py`` (numpy
only), held bit-equal to it by ``tests/test_torch_port_preprocess.py``.
"""

from __future__ import annotations

import io
import os
import os.path as osp

import numpy as np


class SMCReader:
    """Reader for DNA-Rendering ``.smc`` HDF5 files (reference
    SMCReader.py). Lazy: keeps the h5py handle, decodes on access."""

    def __init__(self, path: str):
        import h5py

        self.h5 = h5py.File(path, "r")

    def close(self):
        self.h5.close()

    # -- calibration ----------------------------------------------------
    def get_calibration(self, cam_group: str = "Camera_Parameter") -> dict[str, dict]:
        """-> {cam_label: {K (3,3), D (5,), RT (4,4), ccm (3,3)}}."""
        out = {}
        grp = self.h5[cam_group]
        for label in grp:
            c = grp[label]
            entry = {}
            for key_src, key_dst in (
                ("K", "K"),
                ("D", "D"),
                ("RT", "RT"),
                ("Color_Calibration", "ccm"),
            ):
                if key_src in c:
                    entry[key_dst] = np.asarray(c[key_src])
            out[label] = entry
        return out

    # -- frames ----------------------------------------------------------
    def _decode_image(self, data) -> np.ndarray:
        from PIL import Image

        arr = np.asarray(data)
        if arr.ndim == 1:  # encoded bytes
            return np.asarray(Image.open(io.BytesIO(arr.tobytes())))
        return arr

    def get_img(self, group: str, cam_label: str, frame: int | str) -> np.ndarray:
        """group: 'Camera_5mp'/'Camera_12mp'/'Mask'; returns HWC uint8."""
        node = self.h5[group][str(cam_label)]
        sub = "color" if "color" in node else "mask"
        return self._decode_image(node[sub][str(frame)])

    def get_num_frames(self, group: str, cam_label: str) -> int:
        node = self.h5[group][str(cam_label)]
        sub = "color" if "color" in node else "mask"
        return len(node[sub])

    def get_keypoints2d(self, cam_label: str, frame: int | str) -> np.ndarray:
        return np.asarray(self.h5["Keypoints_2D"][str(cam_label)][str(frame)])

    def get_keypoints3d(self, frame: int | str) -> np.ndarray:
        return np.asarray(self.h5["Keypoints_3D"]["keypoints3d"][int(frame)])


# ---------------------------------------------------------------------------
# calibration math
# ---------------------------------------------------------------------------

def apply_ccm(image: np.ndarray, ccm: np.ndarray) -> np.ndarray:
    """Quadratic per-channel color correction. image uint8/float (H, W, 3)
    RGB; ccm (3, 3) rows ordered BGR like the capture files
    (extract_dnar_images.py:96-100 permutes [2,1,0])."""
    img = image.astype(np.float32)
    coef = ccm[[2, 1, 0], :]  # BGR rows -> RGB order
    out = (
        coef[None, None, :, 0] * img**2
        + coef[None, None, :, 1] * img
        + coef[None, None, :, 2]
    )
    return np.clip(out, 0, 255)


def unified_intrinsics(
    K: np.ndarray, h: int, w: int, cam_id: int, image_size: int = 1024
) -> tuple[np.ndarray, tuple[int, int], tuple[int, int, int, int]]:
    """Unified-focal resize + principal-point center crop
    (extract_dnar_images.py:20-86). Returns (K', (rw, rh), (l, t, r, b))."""
    if 0 <= cam_id <= 47:
        tar_f = 2496 * (image_size / 1920)
        tar_h = tar_w = image_size
    elif 48 <= cam_id <= 59:
        tar_f = 3648 * (image_size / 1920)
        tar_h = tar_w = int(2880 * (image_size / 1920))
    else:
        raise ValueError(f"Unknown camera id: {cam_id}")

    K = np.array(K, copy=True, dtype=np.float64)
    scale_w = tar_f / K[0, 0]
    scale_h = tar_f / K[1, 1]
    rw, rh = int(round(w * scale_w)), int(round(h * scale_h))
    K[0, 0] *= scale_w
    K[0, 2] *= scale_w
    K[1, 1] *= scale_h
    K[1, 2] *= scale_h

    cx, cy = K[0, 2], K[1, 2]
    left = int(round(cx - tar_w // 2))
    top = int(round(cy - tar_h // 2))
    right = left + tar_w
    bottom = top + tar_h
    if left < 0 or top < 0 or right > rw or bottom > rh:
        raise ValueError(
            f"center crop out of bounds for cam {cam_id}: "
            f"({left},{top},{right},{bottom}) vs ({rw},{rh})"
        )
    K[0, 2], K[1, 2] = tar_w / 2, tar_h / 2
    return K, (rw, rh), (left, top, right, bottom)


def calib_undist_image(
    image: np.ndarray,
    K: np.ndarray,
    D: np.ndarray,
    ccm: np.ndarray | None,
    resized_wh: tuple[int, int],
    cropped_ltrb: tuple[int, int, int, int],
) -> np.ndarray:
    """CCM -> undistort -> resize -> center crop (extract_dnar_images.py:
    90-120). Returns uint8 (tar_h, tar_w, C)."""
    import cv2

    img = image
    if ccm is not None:
        img = apply_ccm(img, ccm)
    img = img.astype(np.uint8)
    img = cv2.undistort(img, K.astype(np.float64), np.asarray(D, np.float64))
    img = cv2.resize(img, resized_wh, interpolation=cv2.INTER_AREA)
    l, t, r, b = cropped_ltrb
    return img[t:b, l:r]


def extract_scene(
    smc_path: str,
    out_dir: str,
    image_size: int = 1024,
    cam_group: str = "Camera_5mp",
    frames: list[int] | None = None,
    skip_exists: bool = True,
) -> int:
    """Full extraction of one capture: calibrated webp images per
    (camera, frame) under {out_dir}/images/{cam}/{frame}.webp."""
    from PIL import Image

    reader = SMCReader(smc_path)
    calib = reader.get_calibration()
    count = 0
    cams = sorted(reader.h5[cam_group].keys(), key=lambda s: int(s))
    for cam in cams:
        cam_id = int(cam)
        c = calib[cam]
        n = reader.get_num_frames(cam_group, cam)
        frame_ids = frames if frames is not None else range(n)
        K2, resized_wh, ltrb = unified_intrinsics(
            c["K"], *_image_hw(reader, cam_group, cam), cam_id, image_size
        )
        for fr in frame_ids:
            out = osp.join(out_dir, "images", f"{cam_id:02d}", f"{int(fr):06d}.webp")
            if skip_exists and osp.isfile(out):
                continue
            img = reader.get_img(cam_group, cam, fr)
            img = calib_undist_image(
                img, c["K"], c.get("D", np.zeros(5)), c.get("ccm"), resized_wh, ltrb
            )
            os.makedirs(osp.dirname(out), exist_ok=True)
            Image.fromarray(img).save(out, quality=95)
            count += 1
    reader.close()
    return count


def _image_hw(reader: SMCReader, group: str, cam: str) -> tuple[int, int]:
    img = reader.get_img(group, cam, 0)
    return img.shape[0], img.shape[1]
