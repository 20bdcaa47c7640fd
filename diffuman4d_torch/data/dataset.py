"""Spatio-temporal dataset (reference: src/data/spatem_dataset.py).

Loads per-(scene, camera, frame) image / foreground-mask / skeleton files,
crops around the person, resizes to the working resolution, and assembles
spatial (one frame, many cameras) or temporal (one camera pair, many
frames) sequences.

Parity notes:
  * temporal samples prepend the nearest input camera's track as the
    condition half (spatem_dataset.py:98-107)
  * when ``has_gt_target`` is False, targets use the skeleton map as both
    image and mask source (spatem_dataset.py:124-127)
  * white-background compositing, relative poses, [-1, 1] ranges and the
    same runtime invariants (:166-228) — enforced here as exceptions

Differences from the reference:
  * channels-last numpy outputs
  * Plücker embeddings are NOT precomputed at full resolution here; the
    sample carries K (crop-adjusted) and relative poses, and the pipeline
    evaluates Plücker directly at latent resolution on device
    (see diffuman4d_torch.data.rays.calc_plucker_embeds_lowres)
  * cond masks are per-frame scalars (the reference's mask images are
    constant per frame; nearest-resize of a constant is the constant)
  * multi-threaded file loading (the reference loads serially)
"""

from __future__ import annotations

import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
from PIL import Image

from diffuman4d_torch.data.cameras import (
    Camera,
    nearest_input_camera,
    parse_cameras,
    transform_intrinsic_for_crop,
)
from diffuman4d_torch.data.crops import (
    mask_crop_aspect_ratio,
    skeleton_crop_box,
    skeleton_to_mask,
)
from diffuman4d_torch.data.images import apply_fmask, crop_resize, norm_vae, to_float
from diffuman4d_torch.utils.arrays import fast_stack


@dataclass
class Sample:
    """One spatial or temporal sequence, channels-last numpy."""

    domain: str  # "spatial" | "temporal"
    labels: list[tuple[str, str, str]]  # (scene, spa, tem) per frame
    pixel_values: np.ndarray  # (N, H, W, 3) in [-1, 1], white background
    # (fp16 when the frame cache is on; rows of skipped target views —
    # target_pixels=False / no-GT generation — are zeros)
    skeletons: np.ndarray  # (N, H, W, 3): fp32 in [-1, 1], or uint8 when
    # the dataset runs with ``skeletons_uint8=True`` (u8/127.5-1 == fp path)
    cond_masks: np.ndarray  # (N,) float32: 1 = target, 0 = input
    Ks: np.ndarray  # (N, 3, 3) crop-adjusted intrinsics
    poses: np.ndarray  # (N, 4, 4) relative to frame 0
    crops: list[list[int]]  # per-frame [top, left, h, w, oh, ow]
    hws: list[tuple[int, int]]
    extra: dict = field(default_factory=dict)


class SpaTemDataset:
    def __init__(
        self,
        data_dir: str,
        camera_path_pat: str = "{data_dir}/{scene_label}/transforms.json",
        image_path_pat: str = "{data_dir}/{scene_label}/images/{spa_label}/{tem_label}.webp",
        fmask_path_pat: str = "{data_dir}/{scene_label}/fmasks/{spa_label}/{tem_label}.png",
        skeleton_path_pat: str = "{data_dir}/{scene_label}/skeletons/{spa_label}/{tem_label}.webp",
        scene_label: str | None = None,
        height: int = 1024,
        width: int = 1024,
        has_gt_target: bool = True,
        target_pixels: bool = True,
        io_workers: int = 8,
        cache_frames: bool = True,
        frame_cache_mb: int = 16384,
        skeletons_uint8: bool = False,
    ):
        self.data_dir = osp.expandvars(data_dir)
        self.camera_path_pat = camera_path_pat
        self.image_path_pat = image_path_pat
        self.fmask_path_pat = fmask_path_pat
        self.skeleton_path_pat = skeleton_path_pat
        self.scene_label = scene_label or ""
        self.height = height
        self.width = width
        self.has_gt_target = has_gt_target
        # target_pixels=False skips decoding target-view IMAGES (generation
        # never consumes them — only cond rows are VAE-encoded and only
        # input rows are saved; pipeline.py:446-476, sampler.py:399-407):
        # target rows return zero pixels while keeping the real fmask-derived
        # crop and the skeleton, so generated outputs are bit-identical to
        # target_pixels=True, and a cold first-task load decodes fewer files.
        # Keep True for debug grids / training / metrics-over-sample paths.
        self.target_pixels = target_pixels
        # skeletons_uint8=True keeps Sample.skeletons as the crop-resized
        # uint8 maps; the [-1,1] normalization (u8/127.5-1) happens on
        # device (pipeline._skel_norm_j). Bit-identical to the fp path:
        # the fp chain u8 -> fp32 -> fp16 cache -> rint((x+1)*127.5) is an
        # exact u8 round-trip (fp16 error < 0.5/127.5), and both paths end
        # in the same device-side normalize. Skips ~4 fp passes over
        # ~600 MB per cold 48-frame task and halves skeleton cache bytes.
        # Leave False when a consumer needs fp skeletons on host (training
        # batcher; metrics over Sample fields).
        self.skeletons_uint8 = skeletons_uint8
        # IO threads beyond the core count are poison on small hosts: numpy
        # releases the GIL, so N threads allocating multi-MB buffers on one
        # core turn into a kernel mmap/page-fault storm
        import os as _os

        io_workers = max(1, min(io_workers, _os.cpu_count() or 1))
        self._pool = ThreadPoolExecutor(max_workers=io_workers)
        # large numpy temporaries dominate load cost when glibc munmaps
        # them (first-touch faults are far slower than warm pages)
        from diffuman4d_torch.utils.host_alloc import tune_host_allocator

        tune_host_allocator()
        # Processed-frame cache: alternation rounds revisit every frame
        # several times (each spatial AND temporal task re-reads its
        # cameras; sliding_iterative_sampler.py reloads per task), and
        # decode+crop+resize+composite costs seconds per frame on small
        # hosts. Frames are cached fp16 (~13 MB per 1024^2 frame) up to
        # ``frame_cache_mb``, then the cache stops growing (no eviction —
        # task order revisits old frames, LRU would thrash).
        self.cache_frames = cache_frames
        self._frame_cache: dict = {}
        self._frame_cache_budget = frame_cache_mb * (1 << 20)
        self._frame_cache_bytes = 0

        camera_path = self.camera_path_pat.format(
            data_dir=self.data_dir, scene_label=self.scene_label
        )
        self.cameras: dict[str, dict[str, Camera]] = {
            self.scene_label: parse_cameras(
                camera_path, coord_system="opencv", normalize_scene=True
            )
        }

    def clear_frame_cache(self) -> None:
        """Drop the fp16 processed-frame cache (bench.py cold tier)."""
        self._frame_cache.clear()
        self._frame_cache_bytes = 0

    # ------------------------------------------------------------------
    def get_file_path(self, pat: str, scene: str, spa: str, tem: str) -> str:
        return pat.format(
            data_dir=self.data_dir, scene_label=scene, spa_label=spa, tem_label=tem
        )

    def _load_frame_cached(
        self, label: tuple[str, str, str], input_spa_labels: list[str]
    ) -> dict:
        """fp16-cached :meth:`_load_frame`. fp16 carries more mantissa than
        the bf16 the model computes in; cached replays match the uncached
        inputs to within one bf16 ulp (double rounding on boundary values)
        and halve cache RAM."""
        if not self.cache_frames:
            return self._load_frame(label, input_spa_labels)
        key = (label, tuple(sorted(input_spa_labels)))
        hit = self._frame_cache.get(key)
        if hit is not None:
            return hit
        f = self._load_frame(label, input_spa_labels)
        if f["pixel"] is not None:  # None = skipped target pixels
            f["pixel"] = f["pixel"].astype(np.float16)
        if f["skeleton"].dtype != np.uint8:  # u8 mode caches u8 directly
            f["skeleton"] = f["skeleton"].astype(np.float16)
        nbytes = (
            0 if f["pixel"] is None else f["pixel"].nbytes
        ) + f["skeleton"].nbytes
        if self._frame_cache_bytes + nbytes <= self._frame_cache_budget:
            self._frame_cache[key] = f
            self._frame_cache_bytes += nbytes
        return f

    def _load_frame(
        self, label: tuple[str, str, str], input_spa_labels: list[str]
    ) -> dict:
        from diffuman4d_torch.io import native

        scene, spa, tem = label
        skeleton_path = self.get_file_path(self.skeleton_path_pat, scene, spa, tem)
        use_native = native.available()

        def _decode(path):
            if use_native:
                return native.decode(path)
            return np.asarray(Image.open(path))

        skeleton_raw = _decode(skeleton_path)
        skip_pixel = not self.target_pixels and spa not in input_spa_labels
        fmask_arr = None  # fp32 (H, W, 1); only built when compositing
        if not self.has_gt_target and spa not in input_spa_labels:
            # no GT for targets: skeleton stands in for image; pseudo-mask
            # from the skeleton bbox (spatem_dataset.py:124-127)
            image_raw = skeleton_raw
            if skip_pixel:
                # pixels never consumed: only the crop box is needed, and
                # skeleton_crop_box computes it bit-identically without
                # the full-resolution fp32 pseudo-mask
                crop = skeleton_crop_box(skeleton_raw)
            else:
                fmask_arr = skeleton_to_mask(to_float(skeleton_raw))[..., None]
        else:
            fmask_raw = _decode(self.get_file_path(self.fmask_path_pat, scene, spa, tem))
            image_raw = (
                skeleton_raw
                if skip_pixel
                else _decode(self.get_file_path(self.image_path_pat, scene, spa, tem))
            )
            if not (image_raw.shape[:2] == fmask_raw.shape[:2] == skeleton_raw.shape[:2]):
                raise AssertionError(
                    f"image size {image_raw.shape} != fmask {fmask_raw.shape} "
                    f"!= skeleton {skeleton_raw.shape} for {label}"
                )
            if skip_pixel:
                # crop-only fast path (the 2% check below applies to input
                # views, which never skip): the u8 channel max has the
                # same nonzero set as the fp32 channel mean, so the bbox
                # — and therefore the crop — is identical, without the
                # fp32 conversion + reduction of a full frame
                nz = fmask_raw if fmask_raw.ndim == 2 else fmask_raw.max(axis=-1)
                crop = mask_crop_aspect_ratio(nz)
            else:
                fmask_arr = to_float(fmask_raw)
                if fmask_arr.ndim == 3 and fmask_arr.shape[-1] > 1:
                    fmask_arr = fmask_arr.mean(axis=-1, keepdims=True)
                if (
                    self.has_gt_target
                    and spa in input_spa_labels
                    and fmask_arr.mean() <= 0.02
                ):
                    raise AssertionError(
                        f"foreground mask < 2% for input view {label}; check the data"
                    )

        camera = self.cameras[scene][spa]
        if fmask_arr is not None:
            crop = mask_crop_aspect_ratio(fmask_arr[..., 0])

        h, w = self.height, self.width
        if use_native:
            # fused native crop+bicubic-resize (d4dio); PIL-equivalent
            to_rgb = lambda a: (
                a if a.ndim == 3 and a.shape[-1] == 3
                else np.repeat(a.reshape(a.shape[0], a.shape[1], 1)[..., :1], 3, -1)
            )
            image_u8 = None if skip_pixel else native.crop_resize(
                to_rgb(image_raw), crop, h, w
            )
            skeleton_u8 = native.crop_resize(to_rgb(skeleton_raw), crop, h, w)
            # the resized mask only feeds compositing — skipped pixels
            # (pixel None, see below) never need it
            fm_u8 = None if skip_pixel else native.crop_resize(
                (np.clip(fmask_arr[..., 0], 0, 1) * 255)
                .astype(np.uint8)[..., None],
                crop, h, w,
            )
            if native.has_vae_fused():
                # u8 -> fp32 vae norm + white compositing in one native
                # pass (bit-parity with the numpy chain below, which costs
                # ~250 MB of temporaries per frame vs ~16 MB here)
                pixel = (
                    None
                    if skip_pixel
                    else native.composite_white_vae(image_u8, fm_u8)
                )
                skeleton = (
                    skeleton_u8 if self.skeletons_uint8
                    else native.u8_to_vae(skeleton_u8)
                )
                K = transform_intrinsic_for_crop(camera.K, crop, h)
                checks = [] if skip_pixel else [("pixel_values", pixel)]
                if not self.skeletons_uint8:  # u8 is in range by type
                    checks.append(("skeletons", skeleton))
                for name, arr in checks:
                    if arr.min() < -1.0 - 1e-6 or arr.max() > 1.0 + 1e-6:
                        raise ValueError(
                            f"{name} out of [-1, 1] for {label}: "
                            f"[{arr.min()}, {arr.max()}]"
                        )
                return {
                    "pixel": pixel,
                    "skeleton": skeleton,
                    "K": K,
                    "pose": camera.pose,
                    "hw": (camera.height, camera.width),
                    "crop": crop,
                }
            image = None if skip_pixel else norm_vae(to_float(image_u8))
            skeleton = (
                skeleton_u8 if self.skeletons_uint8
                else norm_vae(to_float(skeleton_u8))
            )
            fmask = None if skip_pixel else norm_vae(to_float(fm_u8))
        else:
            image_img = Image.fromarray(image_raw) if isinstance(image_raw, np.ndarray) else image_raw
            skeleton_img = Image.fromarray(skeleton_raw) if isinstance(skeleton_raw, np.ndarray) else skeleton_raw
            image = None if skip_pixel else norm_vae(
                to_float(crop_resize(image_img.convert("RGB"), crop, h, w))
            )
            fmask = None if skip_pixel else norm_vae(
                to_float(crop_resize(Image.fromarray(
                    (np.clip(fmask_arr[..., 0], 0, 1) * 255).astype(np.uint8)
                ), crop, h, w))
            )
            skel_rs = np.asarray(
                crop_resize(skeleton_img.convert("RGB"), crop, h, w)
            )
            skeleton = (
                skel_rs if self.skeletons_uint8 else norm_vae(to_float(skel_rs))
            )
        K = transform_intrinsic_for_crop(camera.K, crop, h)

        pixel = (
            None
            if skip_pixel
            else apply_fmask(image, fmask, "white", vae_normalized=True)
        )
        # range invariant (spatem_dataset.py:191-228) checked per frame at
        # load time: cache hits skip the re-scan, and get_item avoids
        # whole-batch reductions over hundreds of MB (slow on small hosts)
        range_checks = [] if skip_pixel else [("pixel_values", pixel)]
        if not self.skeletons_uint8:
            range_checks.append(("skeletons", skeleton))
        for name, arr in range_checks:
            if arr.min() < -1.0 - 1e-6 or arr.max() > 1.0 + 1e-6:
                raise ValueError(
                    f"{name} out of [-1, 1] for {label}: "
                    f"[{arr.min()}, {arr.max()}]"
                )
        return {
            "pixel": None if pixel is None else pixel.astype(np.float32),
            "skeleton": skeleton if self.skeletons_uint8
            else skeleton.astype(np.float32),
            "K": K,
            "pose": camera.pose,
            "hw": (camera.height, camera.width),
            "crop": crop,
        }

    # ------------------------------------------------------------------
    def get_item(
        self,
        scene_label: str,
        spa_labels: list[str],
        tem_labels: list[str],
        input_spa_labels: list[str],
    ) -> Sample:
        if len(spa_labels) > 1 and len(tem_labels) == 1:
            domain = "spatial"
        elif len(spa_labels) == 1 and len(tem_labels) > 1:
            domain = "temporal"
        else:
            raise ValueError(
                f"invalid spa_labels and tem_labels: {spa_labels} / {tem_labels}"
            )

        cameras = self.cameras[scene_label]
        if domain == "spatial":
            labels = [(scene_label, spa, tem_labels[0]) for spa in spa_labels]
        else:
            # nearest input camera becomes the condition track
            target_pose = cameras[spa_labels[0]].pose
            input_poses = [cameras[s].pose for s in input_spa_labels]
            cond_spa = input_spa_labels[nearest_input_camera(target_pose, input_poses)]
            labels = [
                (scene_label, spa, tem)
                for spa in [cond_spa] + spa_labels
                for tem in tem_labels
            ]

        frames = list(
            self._pool.map(
                lambda lb: self._load_frame_cached(lb, input_spa_labels), labels
            )
        )

        # fast_stack: np.stack's concatenate path can be much slower than a
        # strided memcpy — the image stacks are the dominant
        # cost of a warm get_item. Skipped target pixels (pixel None under
        # target_pixels=False / no-GT) stay zero rows: np.zeros is lazy
        # (calloc zero pages), so the 44-of-48 untouched rows of a
        # generation task cost no memory writes at all.
        pix = [f["pixel"] for f in frames]
        first = next((p for p in pix if p is not None), None)
        pix_dtype = (
            first.dtype
            if first is not None
            else (np.float16 if self.cache_frames else np.float32)
        )
        pixel_values = np.zeros(
            (len(pix), self.height, self.width, 3), pix_dtype
        )
        for i, p in enumerate(pix):
            if p is not None:
                pixel_values[i] = p
        skeletons = fast_stack([f["skeleton"] for f in frames])
        Ks = np.stack([f["K"] for f in frames])
        poses = np.stack([f["pose"] for f in frames]).astype(np.float32)

        # poses relative to frame 0 (== nearest cond camera for temporal /
        # first spatial label for spatial; ray_utils.py:115-119)
        rel_poses = np.linalg.inv(poses[0]) @ poses

        # default cond assignment (second half targets); the sampler
        # overrides per task (sliding_iterative_sampler.py:134-139)
        cond_masks = np.ones(len(labels), np.float32)
        cond_masks[: len(labels) // 2] = 0.0 if domain == "temporal" else 1.0
        if domain == "spatial":
            cond_masks = np.asarray(
                [0.0 if spa in input_spa_labels else 1.0 for (_, spa, _) in labels],
                np.float32,
            )

        sample = Sample(
            domain=domain,
            labels=labels,
            pixel_values=pixel_values,
            skeletons=skeletons,
            cond_masks=cond_masks,
            Ks=Ks,
            poses=rel_poses.astype(np.float32),
            crops=[f["crop"] for f in frames],
            hws=[f["hw"] for f in frames],
        )
        _check_sample(sample)
        return sample


def _check_sample(s: Sample) -> None:
    """Runtime invariants (spatem_dataset.py:191-228)."""
    if s.domain == "temporal":
        half = len(s.labels) // 2
        spa = [lb[1] for lb in s.labels]
        if any(x != spa[0] for x in spa[:half]):
            raise ValueError("temporal labels inconsistent in condition half")
        if any(x != spa[-1] for x in spa[half:]):
            raise ValueError("temporal labels inconsistent in target half")
    elif s.domain == "spatial":
        tem = [lb[2] for lb in s.labels]
        if any(x != tem[0] for x in tem):
            raise ValueError("spatial labels inconsistent")

    # pixel/skeleton [-1, 1] ranges are validated per frame at load time
    # (see _load_frame) — re-scanning the assembled stacks here costs
    # seconds per task on slow-memory hosts
    if s.cond_masks.min() < 0.0 or s.cond_masks.max() > 1.0:
        raise ValueError("cond masks out of range")
