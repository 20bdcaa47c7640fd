"""ctypes bindings for the d4dio native data-path library.

d4dio (native/d4dio/) is the C++ replacement for the host image hot loop:
decode (jpeg/png/webp) + crop + PIL-compatible bicubic resize fused in one
call, thread-pooled batch loads, and JPEG encoding. The Python dataset uses
it when the shared library is available and falls back to PIL otherwise —
behavior is identical (the C++ resampler reimplements PIL's bicubic filter
exactly).

Build: ``make -C native/d4dio`` (libjpeg/libpng/libwebp are system libs).
"""

from __future__ import annotations

import ctypes
import os
import os.path as osp
import threading

import numpy as np

_LIB = None
_SEARCHED = False
# the dataset's loader threads all ask on their first frame: without the
# lock, a thread arriving while another is still loading the library would
# see "searched, none found" and take the PIL path for that frame
_SEARCH_LOCK = threading.Lock()


class _DecodeResult(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("height", ctypes.c_int),
        ("width", ctypes.c_int),
        ("channels", ctypes.c_int),
    ]


def _find_lib():
    with _SEARCH_LOCK:
        return _find_lib_locked()


def _find_lib_locked():
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    candidates = [
        os.environ.get("D4DIO_LIB", ""),
        osp.join(osp.dirname(__file__), "..", "..", "native", "d4dio", "libd4dio.so"),
    ]
    for cand in candidates:
        if cand and osp.isfile(cand):
            try:
                lib = ctypes.CDLL(osp.abspath(cand))
            except OSError:
                continue
            lib.d4dio_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(_DecodeResult)]
            lib.d4dio_decode.restype = ctypes.c_int
            lib.d4dio_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
            lib.d4dio_crop_resize.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                ctypes.c_int,
            ]
            lib.d4dio_crop_resize.restype = ctypes.c_int
            lib.d4dio_load_frame.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
            ]
            lib.d4dio_load_frame.restype = ctypes.c_int
            lib.d4dio_load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.d4dio_load_batch.restype = ctypes.c_int
            lib.d4dio_encode_jpeg.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.d4dio_encode_jpeg.restype = ctypes.c_int
            # fused u8 -> vae-normalized fp32 (may be absent in an older
            # prebuilt library; gate on presence)
            try:
                lib.d4dio_u8_to_vae.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
                    ctypes.POINTER(ctypes.c_float),
                ]
                lib.d4dio_u8_to_vae.restype = ctypes.c_int
                lib.d4dio_composite_white_vae.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
                    ctypes.POINTER(ctypes.c_float),
                ]
                lib.d4dio_composite_white_vae.restype = ctypes.c_int
                lib._has_vae_fused = True
            except AttributeError:
                lib._has_vae_fused = False
            _LIB = lib
            break
    return _LIB


def available() -> bool:
    return _find_lib() is not None


def decode(path: str) -> np.ndarray:
    """Decode an image file -> (H, W, C) uint8."""
    lib = _find_lib()
    if lib is None:
        raise RuntimeError("d4dio library not available")
    res = _DecodeResult()
    if lib.d4dio_decode(path.encode(), ctypes.byref(res)) != 0:
        raise IOError(f"d4dio: failed to decode {path}")
    n = res.height * res.width * res.channels
    arr = np.ctypeslib.as_array(res.data, shape=(n,)).copy()
    lib.d4dio_free(res.data)
    return arr.reshape(res.height, res.width, res.channels)


def load_frame(
    path: str, crop: list[int], out_h: int, out_w: int, channels: int = 3
) -> np.ndarray:
    """Decode + crop (top, left, h, w) + bicubic resize -> (out_h, out_w, C)
    uint8 in one native call."""
    lib = _find_lib()
    if lib is None:
        raise RuntimeError("d4dio library not available")
    out = np.empty((out_h, out_w, channels), np.uint8)
    rc = lib.d4dio_load_frame(
        path.encode(), int(crop[0]), int(crop[1]), int(crop[2]), int(crop[3]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_h, out_w, channels,
    )
    if rc != 0:
        raise IOError(f"d4dio: failed to load {path} (rc={rc})")
    return out


def crop_resize(img: np.ndarray, crop: list[int], out_h: int, out_w: int) -> np.ndarray:
    """In-memory crop (top, left, h, w) + PIL-bicubic resize of a
    (H, W, C) uint8 array."""
    lib = _find_lib()
    if lib is None:
        raise RuntimeError("d4dio library not available")
    img = np.ascontiguousarray(img)
    c = img.shape[2] if img.ndim == 3 else 1
    out = np.empty((out_h, out_w, c), np.uint8)
    rc = lib.d4dio_crop_resize(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        img.shape[0], img.shape[1], c,
        int(crop[0]), int(crop[1]), int(crop[2]), int(crop[3]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_h, out_w,
    )
    if rc != 0:
        raise IOError("d4dio: crop_resize failed")
    return out


def load_batch(
    paths: list[str], crops: np.ndarray, out_h: int, out_w: int,
    channels: int = 3, num_threads: int = 0,
) -> np.ndarray:
    """Thread-pooled batch load -> (N, out_h, out_w, C) uint8."""
    lib = _find_lib()
    if lib is None:
        raise RuntimeError("d4dio library not available")
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    crops = np.ascontiguousarray(np.asarray(crops, np.int32)[:, :4])
    out = np.empty((n, out_h, out_w, channels), np.uint8)
    nt = num_threads or min(8, os.cpu_count() or 1)
    rc = lib.d4dio_load_batch(
        c_paths, crops.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_h, out_w,
        channels, nt,
    )
    if rc != 0:
        raise IOError("d4dio: batch load had failures")
    return out


def has_vae_fused() -> bool:
    lib = _find_lib()
    return lib is not None and getattr(lib, "_has_vae_fused", False)


def u8_to_vae(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, C) -> float32 in [-1, 1]; bit-parity with
    norm_vae(to_float(img))."""
    lib = _find_lib()
    img = np.ascontiguousarray(img)
    out = np.empty(img.shape, np.float32)
    rc = lib.d4dio_u8_to_vae(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_longlong(img.size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise IOError("d4dio: u8_to_vae failed")
    return out


def composite_white_vae(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """uint8 image (H, W, 3) + uint8 mask (H, W, 1|none) -> white-composited
    float32 in VAE [-1, 1] space; bit-parity with
    apply_fmask(norm_vae(to_float(img)), norm_vae(to_float(mask)), "white",
    vae_normalized=True)."""
    lib = _find_lib()
    img = np.ascontiguousarray(img)
    mask = np.ascontiguousarray(mask)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) uint8 image, got {img.shape}")
    if mask.size != img.shape[0] * img.shape[1]:
        raise ValueError(f"mask size {mask.shape} != image hw {img.shape[:2]}")
    out = np.empty(img.shape, np.float32)
    rc = lib.d4dio_composite_white_vae(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_longlong(img.shape[0] * img.shape[1]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise IOError("d4dio: composite_white_vae failed")
    return out


def encode_jpeg(path: str, image: np.ndarray, quality: int = 95) -> None:
    """(H, W, C) uint8 -> JPEG file."""
    lib = _find_lib()
    if lib is None:
        raise RuntimeError("d4dio library not available")
    image = np.ascontiguousarray(image)
    rc = lib.d4dio_encode_jpeg(
        path.encode(), image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        image.shape[0], image.shape[1], image.shape[2], quality,
    )
    if rc != 0:
        raise IOError(f"d4dio: failed to encode {path}")
