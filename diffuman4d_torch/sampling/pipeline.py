"""Diffuman4D pipeline: condition preparation, sliding-window denoising and
decode (counterpart of ``diffuman4d_tpu/sampling/pipeline.py``).

* :meth:`Diffuman4DPipeline.prepare_conditions` -- VAE-encode the input
  (conditional) rows only, Plücker rays at latent resolution, pose features
  plus the constant black-skeleton negative -- or, for the skeleton-latent
  UNet (``enable_pose_encoder=False``), every row's skeleton VAE-encoded
  with its own posterior noise. Conditional latents, uint8
  skeleton rows and pose features are kept per frame in byte-budgeted LRU
  caches (``cond_cache``, ``*_cache_mb``), so a frame revisited by a later
  task is not encoded again. ``pose_cache_mb`` is also the materialise
  threshold: a task whose pose features for every row fit it gets them
  once; a larger task (demo_4d's 300-row temporal tasks) carries its uint8
  skeleton rows instead, and :meth:`sliding_denoise` computes the features
  per window chunk for the chunk's rows. Its parts are phases
  (``utils/tracing.py``): ``cond/upload`` on the host clock (the host's
  inputs and posterior noise copied to the device; pageable copies block),
  ``cond/vae_encode``, ``cond/pose_encode`` and ``cond/plucker`` on the
  card's. The caches count their lookups as ``cond/{pix,skel,pose}_cache_hit``
  and ``..._miss``, by which ``*_cache_mb`` are sized.
* :meth:`Diffuman4DPipeline.sliding_denoise` -- a Python loop over the
  precomputed window matrix in chunks of ``window_chunk`` windows; each
  window runs ``num_denoising_steps`` CFG denoising steps with the
  vectorized per-latent scheduler step. A multistep scheduler's per-latent
  history (``aux``) is gathered and scattered by the windows' rows beside
  the latents. Each window step is a ``denoise/window_step`` phase and each
  streamed chunk's conditions a ``cond/chunk`` phase, both timed on the
  card.
* :meth:`Diffuman4DPipeline.decode` -- micro-batched VAE decode to uint8.
* :meth:`Diffuman4DPipeline.enable_context_parallel` -- route each window
  step's UNet forward through ``parallel/cp_unet.py`` over a mesh's
  ``model`` axis, for fused CFG (two groups) and split CFG (one).

The JAX package's ``sliding_denoise_batch`` vmaps a wave's tasks over the
mesh's ``data`` axis; in the port each rank runs its own task of the wave
through :meth:`sliding_denoise` (streamed chunks and multistep history
included) and the sampler gathers the wave's rows. Every rank holds its
own weights, so ``commit_mesh_params`` has no counterpart.

The VAE and the pose encoder always run on micro-batches of exactly
``vae_batch`` (``vae_decode_batch``) rows, the last one padded, and a
streamed chunk's rows are padded to one count per task, as in the JAX
package: a row's value then does not depend on which rows share its batch,
so cache hits, streamed chunks and resumed runs equal recomputation bit for
bit (on the card too, where another batch size may pick another algorithm).

CFG follows the JAX package: the negative half replaces conditional-row
latents with ones (white), Plücker with zeros, pose features with the
black-skeleton feature and skeleton latents with -1; the UNet input channel
order is ``[latents 4 | plucker 6 | skeleton latents 4 | cond mask 1]``,
the skeleton latents only without the pose encoder.

Randomness has three sources, each overridable so tests can inject the JAX
package's numbers: :meth:`init_noise` (one generator per grid cell),
:meth:`posterior_noise` (one generator per conditional frame) and
:meth:`skeleton_noise` (one generator per skeleton frame, another stream
than the frame's pixels). A posterior draw is a function of the frame's
label alone, with the caches on or off.
"""

from __future__ import annotations

import hashlib
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from diffuman4d_torch.sampling.windows import step_counts
from diffuman4d_torch.data.rays import calc_plucker_embeds_lowres
from diffuman4d_torch.models.unet import UNetMultiviewCondition
from diffuman4d_torch.models.vae import AutoencoderKL
from diffuman4d_torch.schedulers.diffusion import Scheduler
from diffuman4d_torch.utils.arrays import ByteLRU
from diffuman4d_torch.utils.tracing import count, phase


def _skel_u8(sk: np.ndarray) -> np.ndarray:
    """Skeleton rows -> uint8 (identity for uint8; [-1, 1] floats are
    re-quantised exactly as the JAX package's device cache stores them)."""
    sk = np.asarray(sk)
    if sk.dtype == np.uint8:
        return sk
    return np.clip(np.rint((sk.astype(np.float32) + 1.0) * 127.5), 0, 255).astype(np.uint8)


# the skeleton posterior noise's tag in _cell_seed (the pixels' has none)
SKELETON_NOISE_TAG = 1


def _cell_seed(*parts: int) -> int:
    """A 63-bit generator seed from a tuple of ints (stable across runs)."""
    digest = hashlib.sha256(repr(tuple(int(p) for p in parts)).encode()).digest()
    return int.from_bytes(digest[:8], "little") & 0x7FFFFFFFFFFFFFFF


@dataclass(frozen=True)
class SlidingConfig:
    """Sliding-denoise parameters (same fields as the JAX package's)."""

    window_size: int = 12
    sliding_stride: int = 1
    sliding_shift: int = 0
    bidirectional: bool = False
    num_denoising_steps: int = 1
    alternation_rounds: int = 3
    guidance_scale: float = 2.0
    # domains whose CFG halves run as two batch-L UNet calls instead of one
    # batch-2L call (same math, half the activation memory)
    split_cfg_domains: tuple = ()

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0

    def _counts(self) -> tuple[int, int]:
        return step_counts(self.window_size, self.sliding_stride, self.num_denoising_steps,
                           self.bidirectional, self.alternation_rounds)

    @property
    def total_steps(self) -> int:
        return self._counts()[1]

    @property
    def steps_per_alt(self) -> int:
        return self._counts()[0]


class Diffuman4DPipeline:
    def __init__(
        self,
        unet: UNetMultiviewCondition,
        vae: AutoencoderKL,
        scheduler: Scheduler,
        sliding: SlidingConfig = SlidingConfig(),
        image_size: int = 1024,
        vae_batch: int = 4,
        vae_decode_batch: int | None = None,
        window_chunk: int | None = 8,
        cond_cache: bool = True,
        skel_cache_mb: int = 3072,
        pix_cache_mb: int = 512,
        pose_cache_mb: int = 1536,
        cond_seed: int = 0,
        device: torch.device | str | None = None,
    ):
        self.unet = unet
        self.vae = vae
        self.device = torch.device(device) if device is not None else unet.conv_in.weight.device
        self.sliding = sliding
        self.image_size = image_size
        self.latent_size = image_size // vae.config.downscale_factor
        self.latent_channels = vae.config.latent_channels
        self.vae_batch = vae_batch
        self.vae_decode_batch = vae_decode_batch or max(1, vae_batch // 2)
        # windows per chunk of a streamed task (its row union is what one
        # chunk's pose features cover)
        self.window_chunk = window_chunk
        self.cond_seed = cond_seed
        self.scheduler = scheduler.set_timesteps(sliding.total_steps, self.device)
        # per-frame device caches, keyed by the row label; the same budgets
        # as the JAX package's, so the same tasks stream there and here
        self.cond_cache = cond_cache
        self._skel_cache = ByteLRU(skel_cache_mb << 20)
        self._pix_cache = ByteLRU(pix_cache_mb << 20)
        self._pose_cache = ByteLRU(pose_cache_mb << 20)
        self._neg_pose = None
        self._cp_fwd = None  # the context-parallel forward (enable_context_parallel)

    def enable_context_parallel(self, mesh, axis: str = "model") -> None:
        """Split each window step's frame axis over ``mesh``'s ``axis`` when
        it has more than one rank, so that one task's denoise uses every
        rank of its model group; with one rank, the plain forward."""
        from diffuman4d_torch.parallel.cp_unet import make_cp_unet_apply

        self._cp_fwd = make_cp_unet_apply(self.unet, mesh, axis) if mesh.shape[axis] > 1 \
            else None

    def clear_condition_caches(self) -> None:
        """Drop every per-frame condition cache (skeletons, conditional
        latents, pose features) and the black-skeleton feature."""
        self._skel_cache.clear()
        self._pix_cache.clear()
        self._pose_cache.clear()
        self._neg_pose = None

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.dtype

    @property
    def _on_card(self) -> bool:
        """The device phases are timed by CUDA events (else the host clock)."""
        return self.device.type == "cuda"

    # -- randomness ----------------------------------------------------
    def init_noise(self, spa_ids: np.ndarray, tem_ids: np.ndarray, seed: int) -> torch.Tensor:
        """Grid-indexed initial noise: cell (s, t) always draws the same
        numbers, whatever the task order (one CPU generator per cell)."""
        shape = (self.latent_size, self.latent_size, self.latent_channels)
        rows = []
        for s, t in zip(np.asarray(spa_ids).tolist(), np.asarray(tem_ids).tolist()):
            g = torch.Generator().manual_seed(_cell_seed(seed, s, t))
            rows.append(torch.randn(shape, generator=g, dtype=torch.float32))
        noise = torch.stack(rows) * self.scheduler.init_noise_sigma
        return noise.to(self.device, self.dtype)

    def _label_noise(self, labels: list, *tag: int) -> torch.Tensor:
        shape = (self.latent_size, self.latent_size, self.latent_channels)
        rows = []
        for lb in labels:
            g = torch.Generator().manual_seed(
                _cell_seed(self.cond_seed, zlib.crc32(repr(lb).encode()), *tag))
            rows.append(torch.randn(shape, generator=g, dtype=torch.float32))
        return torch.stack(rows).to(self.device)

    def posterior_noise(self, labels: list) -> torch.Tensor:
        """VAE posterior noise per conditional frame, a function of
        (cond_seed, label) only, fp32 (N, h, w, 4)."""
        return self._label_noise(labels)

    def skeleton_noise(self, labels: list) -> torch.Tensor:
        """VAE posterior noise per skeleton frame (the skeleton-latent
        UNet): a function of (cond_seed, label) only, a stream of its own
        (tag 1), so a frame's skeleton and pixels draw different numbers."""
        return self._label_noise(labels, SKELETON_NOISE_TAG)

    # -- conditions ----------------------------------------------------
    @staticmethod
    def _fixed_chunks(x: torch.Tensor, b: int):
        """Micro-batches of exactly ``b`` rows (the last padded with zeros)
        and the count of real rows in each."""
        n = x.shape[0]
        for i in range(0, n, b):
            c = x[i : i + b]
            if c.shape[0] < b:
                c = torch.cat([c, c.new_zeros((b - c.shape[0],) + tuple(c.shape[1:]))])
            yield c, min(b, n - i)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device, self.dtype)

    def _skel_norm(self, u8: torch.Tensor) -> torch.Tensor:
        """uint8 skeleton rows on the device -> [-1, 1] in the model dtype."""
        return (u8.float() / 127.5 - 1.0).to(self.dtype)

    def encode_images(self, images: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """VAE-encode (N, H, W, 3) in micro-batches of ``vae_batch`` with the
        given posterior noise (N, h, w, 4)."""
        b = self.vae_batch
        outs = []
        for (x, m), (nz, _) in zip(self._fixed_chunks(images, b), self._fixed_chunks(noise, b)):
            mean, logvar = self.vae.moments(x)
            outs.append(self.vae.sample_latents(mean, logvar, nz)[:m])
        return torch.cat(outs).to(self.dtype)

    def _pose_from_skel(self, skel_norm: torch.Tensor) -> torch.Tensor:
        """Pose-encoder forward over a normalised skeleton batch, in
        micro-batches of ``vae_batch``."""
        outs = [self.unet.pose_encoder(c)[:m]
                for c, m in self._fixed_chunks(skel_norm, self.vae_batch)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _neg_pose_feature(self, skel_shape) -> torch.Tensor:
        """Pose feature of a black skeleton, the CFG negative (computed once
        per cache generation)."""
        if self._neg_pose is None:
            with phase("cond/pose_encode", device=self._on_card):
                black = -torch.ones((1,) + tuple(skel_shape), dtype=self.dtype,
                                    device=self.device)
                self._neg_pose = self._pose_from_skel(black)
        return self._neg_pose

    def _pose_feature_bytes(self) -> int:
        """Per-row pose-feature size: (latent, latent, ch0) in model dtype."""
        ch0 = self.unet.config.block_out_channels[0]
        return self.latent_size * self.latent_size * ch0 * self.dtype.itemsize

    def _cond_latents_cached(self, sample, cond_rows) -> torch.Tensor:
        """Conditional latents of ``cond_rows`` through the per-frame cache:
        misses are encoded together (posterior noise per label), hits are
        the stored rows."""
        labels = sample.labels
        # hits first: inserting the misses may evict this task's own rows
        have = {labels[i]: self._pix_cache.value(labels[i])
                for i in cond_rows if labels[i] in self._pix_cache}
        miss = [i for i in cond_rows if labels[i] not in have]
        count("cond/pix_cache_hit", len(cond_rows) - len(miss))
        count("cond/pix_cache_miss", len(miss))
        if miss:
            z = self._encode_rows(sample, miss)
            for j, i in enumerate(miss):
                row = z[j].clone()  # owns its storage: the budget counts it alone
                have[labels[i]] = row
                self._pix_cache.put(labels[i], row, row.nbytes)
        return torch.stack([have[labels[i]] for i in cond_rows])

    def _skel_rows(self, sample, indices=None) -> list[torch.Tensor]:
        """Per-frame device-resident uint8 skeleton rows (LRU-cached), as a
        list: a cache entry and a live task share one tensor."""
        idx = range(len(sample.labels)) if indices is None else indices
        rows, misses = [], 0
        for i in idx:
            lb = sample.labels[i]
            a = self._skel_cache.value(lb)
            if a is None:
                misses += 1
                u8 = _skel_u8(sample.skeletons[i])
                a = torch.from_numpy(np.ascontiguousarray(u8)).to(self.device)
                self._skel_cache.put(lb, a, u8.nbytes)
            rows.append(a)
        count("cond/skel_cache_hit", len(rows) - misses)
        count("cond/skel_cache_miss", misses)
        return rows

    def _skeletons_to_device(self, sample, indices=None) -> torch.Tensor:
        """Stacked, normalised skeleton rows (model dtype) from the cache."""
        return self._skel_norm(torch.stack(self._skel_rows(sample, indices)))

    def _pose_features_lru(self, sample) -> torch.Tensor:
        """Pose features of every row through the per-frame cache: repeat
        visits of a frame skip the skeleton upload and the encoder."""
        labels = sample.labels
        # hits first: inserting the misses may evict this task's own rows
        have = {lb: self._pose_cache.value(lb) for lb in labels if lb in self._pose_cache}
        miss = [i for i, lb in enumerate(labels) if lb not in have]
        count("cond/pose_cache_hit", len(labels) - len(miss))
        count("cond/pose_cache_miss", len(miss))
        if miss:
            with phase("cond/upload", sync=False):
                rows = self._skel_rows(sample, miss)
            with phase("cond/pose_encode", device=self._on_card):
                fm = self._pose_from_skel(self._skel_norm(torch.stack(rows)))
            for j, i in enumerate(miss):
                row = fm[j].clone()
                have[labels[i]] = row
                self._pose_cache.put(labels[i], row, row.nbytes)
        return torch.stack([have[lb] for lb in labels])

    @torch.no_grad()
    def prepare_conditions(self, sample) -> dict:
        """Host ``Sample`` -> device condition dict. Only conditional rows
        are VAE-encoded; other rows' latents are zeros (never consumed).
        Pose features come as ``pose_features`` when every row's fit
        ``pose_cache_mb``, else as the uint8 ``skel_rows`` that
        :meth:`sliding_denoise` streams; without the pose encoder every
        row's skeleton comes as ``skeleton_latents``."""
        is_cond = sample.cond_masks == 0.0
        n = sample.pixel_values.shape[0]
        cond_rows = np.nonzero(is_cond)[0]
        pix_latents = torch.zeros(
            (n, self.latent_size, self.latent_size, self.latent_channels),
            dtype=self.dtype, device=self.device,
        )
        if cond_rows.size:
            if self.cond_cache:
                z = self._cond_latents_cached(sample, list(cond_rows))
            else:
                z = self._encode_rows(sample, cond_rows)
            pix_latents[torch.from_numpy(cond_rows).to(self.device)] = z
        with phase("cond/upload", sync=False):
            Ks = torch.from_numpy(np.asarray(sample.Ks, np.float32)).to(self.device)
            poses = torch.from_numpy(np.asarray(sample.poses, np.float32)).to(self.device)
            is_cond_t = torch.from_numpy(is_cond).to(self.device)
        with phase("cond/plucker", device=self._on_card):
            plucker = calc_plucker_embeds_lowres(
                self.image_size, self.image_size, Ks, poses, self.latent_size, self.latent_size
            ).to(self.dtype)
        cond = {"pix_latents": pix_latents, "plucker": plucker, "is_cond": is_cond_t}
        if not self.unet.config.enable_pose_encoder:
            with phase("cond/upload", sync=False):
                if self.cond_cache:
                    skel = torch.stack(self._skel_rows(sample))
                elif sample.skeletons.dtype == np.uint8:
                    skel = torch.from_numpy(np.ascontiguousarray(sample.skeletons)).to(self.device)
                else:
                    skel = self._to_device(sample.skeletons)
                noise = self.skeleton_noise(sample.labels)
            with phase("cond/vae_encode", device=self._on_card):
                if skel.dtype == torch.uint8:
                    skel = self._skel_norm(skel)
                cond["skeleton_latents"] = self.encode_images(skel, noise)
            return cond
        fits = n * self._pose_feature_bytes() <= self._pose_cache.budget
        if fits and self.cond_cache:
            cond["pose_features"] = self._pose_features_lru(sample)
        elif fits:
            with phase("cond/upload", sync=False):
                u8 = torch.from_numpy(np.ascontiguousarray(_skel_u8(sample.skeletons)))
                u8 = u8.to(self.device)
            with phase("cond/pose_encode", device=self._on_card):
                cond["pose_features"] = self._pose_from_skel(self._skel_norm(u8))
        else:
            with phase("cond/upload", sync=False):
                cond["skel_rows"] = self._skel_rows(sample) if self.cond_cache else [
                    torch.from_numpy(_skel_u8(sk)).to(self.device) for sk in sample.skeletons]
        cond["neg_pose_feature"] = self._neg_pose_feature(sample.skeletons.shape[1:])
        return cond

    def _encode_rows(self, sample, rows) -> torch.Tensor:
        """VAE latents of ``sample``'s frames ``rows``, each with its
        label's posterior noise."""
        with phase("cond/upload", sync=False):
            px = self._to_device(sample.pixel_values[np.asarray(rows)])
            noise = self.posterior_noise([sample.labels[i] for i in rows])
        with phase("cond/vae_encode", device=self._on_card):
            return self.encode_images(px, noise)

    # -- per-chunk condition streaming ---------------------------------
    def _window_chunk_size(self, n_windows: int) -> int:
        """Largest chunk <= ``window_chunk`` that divides ``n_windows``, so
        every chunk has one row count."""
        c = min(self.window_chunk or n_windows, n_windows)
        while n_windows % c:
            c -= 1
        return c

    @staticmethod
    def _chunk_rows(wchunk: np.ndarray, pad_u: int) -> tuple[np.ndarray, np.ndarray]:
        """Unique rows used by a chunk of windows, and the windows renumbered
        into that row set. The union is padded to ``pad_u`` by repeating its
        last row (pad rows are never indexed)."""
        U = np.unique(wchunk)
        wc = np.searchsorted(U, wchunk).astype(wchunk.dtype)
        if pad_u > U.size:
            U = np.concatenate([U, np.full(pad_u - U.size, U[-1], U.dtype)])
        return U, wc

    @staticmethod
    def _chunk_pad_u(windows: np.ndarray, c: int) -> int:
        return max(np.unique(windows[i : i + c]).size for i in range(0, windows.shape[0], c))

    _DENSE_COND_KEYS = ("pix_latents", "plucker", "is_cond", "skeleton_latents")

    def _chunk_cond(self, cond: dict, wchunk: np.ndarray, pad_u: int) -> tuple[dict, np.ndarray]:
        """A task's conditions for one chunk of windows: the dense per-row
        keys gathered to the chunk's row union and, for a streamed task,
        pose features computed for those rows."""
        U, wc = self._chunk_rows(np.asarray(wchunk), pad_u)
        Ut = torch.from_numpy(U.astype(np.int64)).to(self.device)
        out = {k: cond[k][Ut] for k in self._DENSE_COND_KEYS if k in cond}
        if "skel_rows" in cond:
            rows = cond["skel_rows"]
            out["pose_features"] = self._pose_from_skel(
                self._skel_norm(torch.stack([rows[i] for i in U])))
        if "neg_pose_feature" in cond:
            out["neg_pose_feature"] = cond["neg_pose_feature"]
        return out, wc

    # -- denoising -----------------------------------------------------
    def _denoise_step(self, cond_w: dict, latents_w: torch.Tensor, t_idx_w: torch.Tensor,
                      domain: str, aux_w: dict | None = None):
        """One denoising step on one window of L rows. Returns (latents,
        t_idx, aux)."""
        cfg = self.sliding
        scheduler = self.scheduler
        is_cond = cond_w["is_cond"]
        L = latents_w.shape[0]
        dtype = latents_w.dtype
        dev = latents_w.device

        t = scheduler.timestep_of(t_idx_w, is_cond)
        x = scheduler.scale_model_input(latents_w, t_idx_w)
        sel = is_cond[:, None, None, None]
        x = torch.where(sel, cond_w["pix_latents"], x)  # clean latents on cond rows
        plucker = cond_w["plucker"]
        pose = cond_w.get("pose_features")
        skel = cond_w.get("skeleton_latents")

        h, w = latents_w.shape[1:3]
        mask_plane = (~is_cond).to(dtype)[:, None, None, None].expand(L, h, w, 1)
        if domain == "temporal":
            tem = torch.arange(L // 2, dtype=torch.int32, device=dev).repeat(2)
        else:
            tem = torch.zeros((L,), dtype=torch.int32, device=dev)

        def eps_of(xh, pluckerh, poseh, skelh, th, temh, maskh):
            parts = [xh, pluckerh] + ([skelh] if skelh is not None else []) + [maskh]
            if self._cp_fwd is not None:
                return self._cp_fwd(torch.cat(parts, dim=-1), th, temh, L, pose_features=poseh)
            return self.unet(torch.cat(parts, dim=-1), th, tem_indices=temh, num_frames=L,
                             pose_features=poseh)

        if cfg.do_cfg:
            neg_x = torch.where(sel, torch.ones_like(x), x)
            neg_plucker = torch.zeros_like(plucker)
            neg_pose = None if pose is None else cond_w["neg_pose_feature"].expand_as(pose)
            neg_skel = None if skel is None else -torch.ones_like(skel)
            if domain in cfg.split_cfg_domains:
                eps_u = eps_of(neg_x, neg_plucker, neg_pose, neg_skel, t, tem, mask_plane)
                eps_c = eps_of(x, plucker, pose, skel, t, tem, mask_plane)
            else:
                def both(a, b):
                    return None if a is None else torch.cat([a, b])

                eps = eps_of(
                    both(neg_x, x), both(neg_plucker, plucker), both(neg_pose, pose),
                    both(neg_skel, skel), both(t, t), both(tem, tem),
                    both(mask_plane, mask_plane),
                )
                eps_u, eps_c = eps.chunk(2)
            eps = eps_u + cfg.guidance_scale * (eps_c - eps_u)
        else:
            eps = eps_of(x, plucker, pose, skel, t, tem, mask_plane)

        if scheduler.has_aux:
            new_latents, aux_w = scheduler.step_with_aux(eps, t_idx_w, latents_w, aux_w,
                                                         mask=~is_cond)
        else:
            # no noise or generator, as the JAX package passes no key: DDPM
            # and DDIM with eta > 0 raise here in both packages
            new_latents = scheduler.step(eps, t_idx_w, latents_w, mask=~is_cond)
        return new_latents, t_idx_w + (~is_cond).to(t_idx_w.dtype), aux_w

    @torch.no_grad()
    def sliding_denoise(self, cond: dict, latents: torch.Tensor, t_idx, windows: np.ndarray,
                        domain: str, aux: dict | None = None):
        """Run every window of one task. Returns (latents, t_idx numpy,
        aux): ``aux`` is the multistep scheduler's per-latent history of the
        task's rows (fresh when ``None``), ``None`` for the other kinds.
        Raises on the schedule invariants: all targets start at one index,
        inputs at 0; afterwards targets advanced by ``steps_per_alt``."""
        t_idx = np.asarray(t_idx)
        is_cond = cond["is_cond"].cpu().numpy()
        tgt = t_idx[~is_cond]
        if (tgt != tgt[0]).any():
            raise ValueError(f"target timestep indices differ: {t_idx}")
        if (t_idx[is_cond] != 0).any():
            raise ValueError(f"input timestep indices nonzero: {t_idx}")
        expected_end = int(tgt[0]) + self.sliding.steps_per_alt

        latents = latents.clone()
        if not self.scheduler.has_aux:
            aux = None
        elif aux is None:
            aux = self.scheduler.init_aux(latents.shape, latents.device)
        else:
            aux = {k: v.clone() for k, v in aux.items()}
        t_dev = torch.from_numpy(t_idx.astype(np.int64)).to(self.device)
        windows = np.asarray(windows)
        c = self._window_chunk_size(windows.shape[0])
        stream = "skel_rows" in cond
        pad_u = self._chunk_pad_u(windows, c) if stream else 0
        for i in range(0, windows.shape[0], c):
            wchunk = windows[i : i + c]
            cond_c, wc = cond, wchunk
            if stream:  # a streamed chunk's conditions have their own row numbering
                with phase("cond/chunk", device=self._on_card):
                    cond_c, wc = self._chunk_cond(cond, wchunk, pad_u)
            per_row = [k for k in cond_c if k != "neg_pose_feature"]
            for w, w_cond in zip(wchunk, wc):
                wi = torch.from_numpy(w.astype(np.int64)).to(self.device)
                ci = torch.from_numpy(w_cond.astype(np.int64)).to(self.device)
                cond_w = {k: cond_c[k][ci] for k in per_row}
                if "neg_pose_feature" in cond_c:
                    cond_w["neg_pose_feature"] = cond_c["neg_pose_feature"]
                lat_w, ti_w = latents[wi], t_dev[wi]
                aux_w = None if aux is None else {k: v[wi] for k, v in aux.items()}
                for _ in range(self.sliding.num_denoising_steps):
                    with phase("denoise/window_step", device=self._on_card):
                        lat_w, ti_w, aux_w = self._denoise_step(cond_w, lat_w, ti_w, domain,
                                                                aux_w)
                latents[wi] = lat_w
                t_dev[wi] = ti_w
                if aux is not None:
                    for k, v in aux_w.items():
                        aux[k][wi] = v

        t_after = t_dev.cpu().numpy().astype(np.int32)
        if (t_after[~is_cond] != expected_end).any():
            raise ValueError(f"target latents advanced to {t_after[~is_cond]}, "
                             f"expected {expected_end}")
        if (t_after[is_cond] != 0).any():
            raise ValueError("input latent timesteps changed")
        return latents, t_after, aux

    # -- outputs -------------------------------------------------------
    def _decode_u8_impl(self, latents: torch.Tensor) -> torch.Tensor:
        """Decode and quantise to uint8 on the device: clip to [0, 1],
        * 255 + 0.5, truncate."""
        x = self.vae.decode(latents)
        x01 = (x.float() * 0.5 + 0.5).clamp(0.0, 1.0)
        return torch.floor(x01 * 255.0 + 0.5).to(torch.uint8)

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> np.ndarray:
        """Latents -> uint8 images (N, H, W, 3), micro-batched."""
        if latents.shape[0] == 0:
            return np.empty((0, self.image_size, self.image_size, 3), np.uint8)
        return np.concatenate([
            self._decode_u8_impl(c)[:m].cpu().numpy()
            for c, m in self._fixed_chunks(latents, self.vae_decode_batch)
        ])
