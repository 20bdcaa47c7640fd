"""Stable Video Diffusion image-to-video sampling (diffusers
``StableVideoDiffusionPipeline``) with :class:`Diffuman4DPipeline`'s public
face, so that ``SlidingIterativeSampler``, its IO and saver threads and
``cli.build_sampler`` drive it unchanged.

A window is a clip: its conditional row is the conditioning image, its
target rows are the clip's frames in window order (an orbit of cameras in a
spatial task, a camera's frames in a temporal one).

* :meth:`SVDPipeline.prepare_conditions` -- each conditional row's image with
  pixel noise augmentation (``noise_aug_strength`` times a draw of its
  label), then the VAE posterior's mode, unscaled (a card-timed phase
  ``cond/image_latent``); and its image embedding, 1024 wide. The CLIP
  ViT-H/14 image encoder is not run: the embedding is a standard normal
  draw of the row's label (:meth:`image_embeddings`).
* :meth:`SVDPipeline.sliding_denoise` -- per window step one UNet call on
  the clip's F frames, CFG fused (2F rows: the negative half has zero image
  latents and a zero embedding), the image latent concatenated on every
  frame's channels, ``added_time_ids`` ``[fps - 1, motion_bucket_id,
  noise_aug_strength]``; guidance ``linspace(min_guidance_scale,
  guidance_scale, F)`` over the frames; then ``scheduler.step`` on every row
  of the window (the conditional row masked). Each step is a
  ``denoise/window_step`` phase; each clip adds to the counters
  ``svd/clips`` and ``svd/clip_frames``.
* :meth:`SVDPipeline.decode` -- the temporal VAE decoder over runs of at
  most ``decode_chunk_size`` consecutive rows, each run one clip of its own
  length (never padded with another clip's rows), to uint8.

The latents are carried in fp32: with Euler on Karras sigmas (700 down to
0.002) the scheduler's state is ``x / sqrt(sigma^2 + 1)``, which starts at
unit noise (``EulerKarrasConfig`` says why). The
initial draws are the port's grid noise (one generator per grid cell,
rounded to the model dtype, as every pipeline of the port draws them).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch

from diffuman4d_torch.sampling.pipeline import SlidingConfig, _cell_seed
from diffuman4d_torch.schedulers.diffusion import Scheduler
from diffuman4d_torch.utils.tracing import count, phase

# the published scheduler_config.json of stabilityai/stable-video-diffusion-img2vid-xt
SVD_SCHEDULER_CONFIG = {
    "_class_name": "EulerDiscreteScheduler", "beta_start": 0.00085, "beta_end": 0.012,
    "beta_schedule": "scaled_linear", "num_train_timesteps": 1000,
    "prediction_type": "v_prediction", "sigma_max": 700.0, "sigma_min": 0.002,
    "steps_offset": 1, "timestep_spacing": "leading", "timestep_type": "continuous",
    "use_karras_sigmas": True, "set_alpha_to_one": False, "clip_sample": False,
}
# streams of _cell_seed beside the grid noise and the posterior noise
IMAGE_NOISE_TAG = 2
EMBEDDING_TAG = 3


@dataclass(frozen=True)
class SVDConditioning:
    """The image-to-video call's settings (diffusers' defaults for SVD-xt)."""

    fps: int = 7  # fps - 1 enters the embedding
    motion_bucket_id: int = 127
    noise_aug_strength: float = 0.02
    min_guidance_scale: float = 1.0  # the first frame's; the last's is sliding.guidance_scale
    decode_chunk_size: int = 25


class SVDPipeline:
    def __init__(self, unet, vae, scheduler: Scheduler, sliding: SlidingConfig = SlidingConfig(),
                 image_size: int = 768, conditioning: SVDConditioning = SVDConditioning(),
                 cond_seed: int = 0, device: torch.device | str | None = None):
        self.unet = unet
        self.vae = vae
        self.device = torch.device(device) if device is not None else unet.conv_in.weight.device
        self.sliding = sliding
        self.image_size = image_size
        self.latent_size = image_size // vae.config.downscale_factor
        self.latent_channels = vae.config.latent_channels
        self.conditioning = conditioning
        self.cond_seed = cond_seed
        self.scheduler = scheduler.set_timesteps(sliding.total_steps, self.device)

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.dtype

    @property
    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    def clear_condition_caches(self) -> None:
        """Nothing is cached across tasks."""

    def enable_context_parallel(self, mesh, axis: str = "model") -> None:
        raise NotImplementedError("SVD sampling runs each clip on one device")

    # -- randomness ----------------------------------------------------
    def init_noise(self, spa_ids: np.ndarray, tem_ids: np.ndarray, seed: int) -> torch.Tensor:
        """Grid-indexed initial latents, fp32: cell (s, t) draws what every
        pipeline of the port draws there, rounded to the model dtype, times
        the scheduler's initial sigma (1 with Karras sigmas)."""
        shape = (self.latent_size, self.latent_size, self.latent_channels)
        rows = []
        for s, t in zip(np.asarray(spa_ids).tolist(), np.asarray(tem_ids).tolist()):
            g = torch.Generator().manual_seed(_cell_seed(seed, s, t))
            rows.append(torch.randn(shape, generator=g, dtype=torch.float32))
        noise = torch.stack(rows) * self.scheduler.init_noise_sigma
        return noise.to(self.dtype).to(self.device, torch.float32)

    def _label_draw(self, labels: list, shape: tuple, tag: int) -> torch.Tensor:
        rows = []
        for lb in labels:
            g = torch.Generator().manual_seed(
                _cell_seed(self.cond_seed, zlib.crc32(repr(lb).encode()), tag))
            rows.append(torch.randn(shape, generator=g, dtype=torch.float32))
        return torch.stack(rows).to(self.device)

    def image_noise(self, labels: list) -> torch.Tensor:
        """The noise augmentation's pixel draw per conditioning frame, fp32
        (N, H, W, 3): a function of (cond_seed, label)."""
        return self._label_draw(labels, (self.image_size, self.image_size, 3), IMAGE_NOISE_TAG)

    def image_embeddings(self, labels: list) -> torch.Tensor:
        """The image embedding per conditioning frame, fp32 (N, 1,
        cross_attention_dim): a standard normal draw of (cond_seed, label),
        in place of the CLIP image encoder's."""
        return self._label_draw(labels, (1, self.unet.config.cross_attention_dim),
                                EMBEDDING_TAG)

    # -- conditions ----------------------------------------------------
    @torch.no_grad()
    def prepare_conditions(self, sample) -> dict:
        """Host ``Sample`` -> device conditions: per row the unscaled image
        latent and the image embedding (zeros on rows that condition
        nothing), and which rows are conditional."""
        is_cond = sample.cond_masks == 0.0
        rows = np.nonzero(is_cond)[0]
        n, lat = len(sample.labels), self.latent_size
        image_latents = torch.zeros((n, lat, lat, self.latent_channels), dtype=self.dtype,
                                    device=self.device)
        embeds = torch.zeros((n, 1, self.unet.config.cross_attention_dim), dtype=self.dtype,
                             device=self.device)
        labels = [sample.labels[i] for i in rows]
        with phase("cond/upload", sync=False):
            is_cond_t = torch.from_numpy(is_cond).to(self.device)
            if rows.size:
                px = torch.from_numpy(np.ascontiguousarray(
                    sample.pixel_values[rows], np.float32)).to(self.device)
                noise = self.image_noise(labels)
        if rows.size:
            rows_t = torch.from_numpy(rows).to(self.device)
            with phase("cond/image_latent", device=self._on_card):
                aug = px + self.conditioning.noise_aug_strength * noise
                z = torch.cat([self.vae.encode_mode(aug[i:i + 1].to(self.dtype))
                               for i in range(aug.shape[0])])
                image_latents[rows_t] = z.to(self.dtype)
            embeds[rows_t] = self.image_embeddings(labels).to(self.dtype)
        return {"is_cond": is_cond_t, "image_latents": image_latents, "image_embeds": embeds}

    # -- denoising -----------------------------------------------------
    def added_time_ids(self) -> torch.Tensor:
        c = self.conditioning
        return torch.tensor([[c.fps - 1, c.motion_bucket_id, c.noise_aug_strength]],
                            dtype=torch.float32, device=self.device)

    def guidance(self, frames: int) -> torch.Tensor:
        """Per-frame guidance scales, fp32 (F,)."""
        return torch.linspace(self.conditioning.min_guidance_scale, self.sliding.guidance_scale,
                              frames, device=self.device)

    def _denoise_step(self, lat_w: torch.Tensor, t_idx_w: torch.Tensor, is_cond: torch.Tensor,
                      tgt: torch.Tensor, image_latent: torch.Tensor, embed: torch.Tensor):
        """One step of one clip: the window's rows ``lat_w`` (fp32), its
        targets at positions ``tgt``, conditioned on ``image_latent`` (h, w,
        4) and ``embed`` (1, D). Returns (latents, t_idx)."""
        sched, dtype = self.scheduler, self.dtype
        frames = tgt.shape[0]
        y, ti = lat_w[tgt], t_idx_w[tgt]
        t = sched.timestep_of(ti, torch.zeros_like(ti, dtype=torch.bool))
        x = sched.scale_model_input(y, ti).to(dtype)
        img = image_latent.expand(frames, *image_latent.shape)
        ids = self.added_time_ids()
        if self.sliding.do_cfg:
            sample = torch.cat([torch.cat([x, torch.zeros_like(img)], -1),
                                torch.cat([x, img], -1)])
            ctx = torch.stack([torch.zeros_like(embed), embed])
            out = self.unet(sample, torch.cat([t, t]), ctx, ids.expand(2, 3), frames).float()
            eps_u, eps_c = out.chunk(2)
            g = self.guidance(frames)[:, None, None, None]
            eps = eps_u + g * (eps_c - eps_u)
        else:
            eps = self.unet(torch.cat([x, img], -1), t, embed[None], ids, frames).float()
        eps_w = torch.zeros_like(lat_w)
        eps_w[tgt] = eps
        new = sched.step(eps_w, t_idx_w, lat_w, mask=~is_cond)
        return new, t_idx_w + (~is_cond).to(t_idx_w.dtype)

    @torch.no_grad()
    def sliding_denoise(self, cond: dict, latents: torch.Tensor, t_idx, windows: np.ndarray,
                        domain: str, aux: dict | None = None):
        """Run every window of one task, each a clip conditioned on its
        first conditional row. Returns (latents, t_idx numpy, None). Raises
        on the schedule invariants, as :class:`Diffuman4DPipeline` does, and
        on a window with no conditional row."""
        t_idx = np.asarray(t_idx)
        is_cond = cond["is_cond"].cpu().numpy()
        tgt = t_idx[~is_cond]
        if (tgt != tgt[0]).any():
            raise ValueError(f"target timestep indices differ: {t_idx}")
        if (t_idx[is_cond] != 0).any():
            raise ValueError(f"input timestep indices nonzero: {t_idx}")
        expected_end = int(tgt[0]) + self.sliding.steps_per_alt
        latents = latents.to(torch.float32, copy=True)
        t_dev = torch.from_numpy(t_idx.astype(np.int64)).to(self.device)
        for w in np.asarray(windows):
            inputs = w[is_cond[w]]
            if inputs.size == 0:
                raise ValueError(f"window {w.tolist()} has no conditioning row")
            wi = torch.from_numpy(w.astype(np.int64)).to(self.device)
            is_c = torch.from_numpy(is_cond[w]).to(self.device)
            pos = torch.from_numpy(np.nonzero(~is_cond[w])[0]).to(self.device)
            image_latent = cond["image_latents"][int(inputs[0])]
            embed = cond["image_embeds"][int(inputs[0])]
            lat_w, ti_w = latents[wi], t_dev[wi]
            for _ in range(self.sliding.num_denoising_steps):
                with phase("denoise/window_step", device=self._on_card):
                    lat_w, ti_w = self._denoise_step(lat_w, ti_w, is_c, pos, image_latent, embed)
            latents[wi] = lat_w
            t_dev[wi] = ti_w
            count("svd/clips")
            count("svd/clip_frames", int(pos.shape[0]))
        t_after = t_dev.cpu().numpy().astype(np.int32)
        if (t_after[~is_cond] != expected_end).any():
            raise ValueError(f"target latents advanced to {t_after[~is_cond]}, "
                             f"expected {expected_end}")
        if (t_after[is_cond] != 0).any():
            raise ValueError("input latent timesteps changed")
        return latents, t_after, None

    # -- outputs -------------------------------------------------------
    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> np.ndarray:
        """Latents -> uint8 images (N, H, W, 3): runs of at most
        ``decode_chunk_size`` consecutive rows, each decoded as one clip."""
        if latents.shape[0] == 0:
            return np.empty((0, self.image_size, self.image_size, 3), np.uint8)
        step = self.conditioning.decode_chunk_size
        outs = []
        for i in range(0, latents.shape[0], step):
            z = latents[i:i + step].to(self.device)
            x = self.vae.decode(z, num_frames=z.shape[0])
            x01 = (x.float() * 0.5 + 0.5).clamp(0.0, 1.0)
            outs.append(torch.floor(x01 * 255.0 + 0.5).to(torch.uint8).cpu().numpy())
        return np.concatenate(outs)
