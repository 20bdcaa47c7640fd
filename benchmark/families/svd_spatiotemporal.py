"""The Stable Video Diffusion family: SVD-xt's spatio-temporal UNet
(diffusers ``UNetSpatioTemporalConditionModel``), the SD encoder with the
temporal VAE decoder (``AutoencoderKLTemporalDecoder``) and Euler on Karras
sigmas with v-prediction, run by the port's ``SVDPipeline`` as
image-to-video: a window is a clip, its conditional row the conditioning
image, its target rows the frames. Its plain reference is
``benchmark/reference/svd.py``; ``families/d4d_multiview.py`` says what a
family file provides.

The output check's decode: the core hands the reference two frames of the
first decoded clip, and a frame of a temporal decoder is a function of its
whole clip. The program's ``decode`` is wrapped here, before the core's
recorder, to keep the first clip's latents (the very tensor that the chain
check holds to the finished rows), and :meth:`Reference.decode` decodes that
clip and returns the frames that match the two it is given.
"""

from __future__ import annotations

import functools
import time
import zlib

import numpy as np
import torch

from benchmark.harness import weights as W
from benchmark.harness import work as wk
from benchmark.reference import data as ref_data
from benchmark.reference import models as ref_models
from benchmark.reference import svd

KEYS = {"unet", "vae", "scheduler", "guidance_scale", "conditioning"}
IMAGE_NOISE_TAG = 2  # the program's streams of the seeded label draws (svd_pipeline.py)
EMBEDDING_TAG = 3
_CLIPS: list[torch.Tensor] = []  # the first decoded clip's latents, on the host


def reference_modules(config: dict, device="meta") -> dict[str, torch.nn.Module]:
    with torch.device(device):
        return {"unet": svd.UNet(config["unet"]), "vae": svd.VAE(config["vae"])}


def sampler_settings(config: dict) -> dict:
    return {"guidance_scale": config["guidance_scale"]}


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


# -- the program ---------------------------------------------------------------
def build_pipeline(prog):
    """``SVDPipeline`` over ``UNetSpatioTemporalConditionModel`` and
    ``AutoencoderKLTemporalDecoder`` holding the seed's weights in the
    configuration's dtype, and the configuration's Euler scheduler; its
    ``decode`` keeps the first clip's latents for the output check."""
    from diffuman4d_torch.models.unet_spatiotemporal import SVDUNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.sampling.loader import build_svd_models
    from diffuman4d_torch.sampling.svd_pipeline import SVDConditioning, SVDPipeline
    from diffuman4d_torch.schedulers.diffusion import from_config

    config = prog.config
    weights = W.make_weights(W.spec(reference_modules(config)), prog.seed, prog.device,
                             prog.dtype)
    ucfg = {k: v for k, v in config["unet"].items() if k in SVDUNetConfig.__dataclass_fields__}
    vcfg = {k: v for k, v in config["vae"].items() if k in VAEConfig.__dataclass_fields__}
    unet, vae = build_svd_models(SVDUNetConfig(**_tuples(ucfg)), VAEConfig(**_tuples(vcfg)),
                                 prog.device, prog.dtype,
                                 state=(W.split(weights, "unet"), W.split(weights, "vae")))
    del weights
    pipe = SVDPipeline(unet, vae, from_config(config["scheduler"]), sliding=prog.sliding,
                       image_size=prog.size, conditioning=SVDConditioning(**config["conditioning"]),
                       cond_seed=prog.seed, device=prog.device)
    _CLIPS.clear()
    decode = pipe.decode

    def keep_first_clip(latents):
        if not _CLIPS:
            _CLIPS.append(latents.detach().float().cpu().clone())
        return decode(latents)
    pipe.decode = keep_first_clip
    return pipe


@torch.no_grad()
def warm_up(prog) -> float:
    """Run the cell's own shapes once: the UNet on the window's clip (CFG
    fused), the conditioning encode, the decode of one clip; return the
    seconds of one warm window step."""
    p, dev, dt = prog.pipeline, prog.device, prog.dtype
    frames = prog.cell.traffic["sampler"]["window_size"]
    lat = p.latent_size
    gen = torch.Generator(device=dev).manual_seed(prog.seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows = 2 if p.sliding.do_cfg else 1
    x = rnd(rows * frames, lat, lat, p.unet.config.in_channels).to(dt)
    t = torch.full((rows * frames,), 0.5, device=dev)
    ctx = rnd(rows, 1, p.unet.config.cross_attention_dim).to(dt)
    ids = p.added_time_ids().expand(rows, 3)
    px = rnd(1, prog.size, prog.size, 3).clamp(-1, 1).to(dt)
    for _ in range(2):
        p.vae.encode_mode(px)
        if prog.shape.decodes:
            p.decode(rnd(frames, lat, lat, 4))
        prog.sync()
        t0 = time.perf_counter()
        p.unet(x, t, ctx, ids, frames)
        prog.sync()
        step_s = time.perf_counter() - t0
    _CLIPS.clear()
    return step_s


# -- the plain reference -------------------------------------------------------
def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.floor((x.float() * 0.5 + 0.5).clamp(0, 1) * 255.0 + 0.5)


def label_draw(cond_seed: int, labels, shape: tuple, tag: int) -> torch.Tensor:
    """fp32 standard normals per frame label, one generator each (the
    seeding ``benchmark/reference/data.py`` documents)."""
    rows = []
    for lb in labels:
        g = torch.Generator().manual_seed(
            ref_data.cell_seed(cond_seed, zlib.crc32(repr(lb).encode()), tag))
        rows.append(torch.randn(shape, generator=g))
    return torch.stack(rows)


class Reference:
    """The plain reference of one configuration on ``device``: fp32 weights
    from the seed, Karras Euler over ``total_steps``."""

    def __init__(self, config: dict, seed: int, device, entries, total_steps: int):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config, self.device = config, device
        mods = reference_modules(config, device)
        self.unet, self.vae = mods["unet"].eval(), mods["vae"].eval()
        w = W.make_weights(entries, seed, device, torch.bfloat16)
        for key, mod in (("unet", self.unet), ("vae", self.vae)):
            mod.load_state_dict({k: v.float() for k, v in W.split(w, key).items()}, strict=True)
        del w
        self.sched = svd.KarrasEuler(config["scheduler"], total_steps)
        c = config["conditioning"]
        self.ids = torch.tensor([[c["fps"] - 1, c["motion_bucket_id"], c["noise_aug_strength"]]],
                                dtype=torch.float32, device=device)

    def set_fp8(self, fp8: bool) -> None:
        """The control: every product in float8 e4m3 (or back to fp32)."""
        for mod in (self.unet, self.vae):
            svd.set_prec(mod, ref_models.Prec(fp8=fp8))

    @torch.no_grad()
    def conditions(self, scene_dir: str, labels, first_label, is_cond, cond_seed: int,
                   size: int, latent: int) -> dict:
        """The clip's conditioning from the raw files: the first
        conditional row's frame, noise-augmented, its posterior mode
        (unscaled); its drawn image embedding."""
        row = labels[int(np.nonzero(is_cond)[0][0])]
        pix = torch.from_numpy(ref_data.load_rows(scene_dir, [row], size)[0]).to(self.device)
        noise = label_draw(cond_seed, [row], (size, size, 3), IMAGE_NOISE_TAG).to(self.device)
        aug = pix + self.config["conditioning"]["noise_aug_strength"] * noise
        emb = label_draw(cond_seed, [row], (1, self.config["unet"]["cross_attention_dim"]),
                         EMBEDDING_TAG).to(self.device)
        return {"image_latent": self.vae.encode_mode(aug)[0], "embed": emb}

    @torch.no_grad()
    def step(self, domain: str, rec: dict, is_cond, cond: dict):
        """((latents, None), the same with v = 0) of the recorded step
        ``rec``: the UNet on the clip's frames, unconditional (zero image
        latent and embedding) and conditional, guidance ``linspace(min,
        guidance_scale, F)``, the Euler step."""
        x = rec["x"].float().to(self.device)
        t_idx = np.asarray(rec["t_idx"])
        tgt = ~np.asarray(is_cond)
        y = x[torch.from_numpy(tgt).to(self.device)]
        frames = y.shape[0]
        t = torch.from_numpy(self.sched.timesteps[np.clip(t_idx[tgt], 0, self.sched.n - 1)])
        t = t.to(self.device)
        img = cond["image_latent"].expand(frames, *cond["image_latent"].shape)
        out = []
        for lat, emb in ((torch.zeros_like(img), torch.zeros_like(cond["embed"])),
                         (img, cond["embed"])):
            out.append(self.unet(torch.cat([y, lat], -1), t, emb, self.ids, frames))
        c = self.config["conditioning"]
        g = torch.linspace(c["min_guidance_scale"], self.config["guidance_scale"], frames,
                           device=self.device)[:, None, None, None]
        v = out[0] + g * (out[1] - out[0])
        v_all = torch.zeros_like(x)
        v_all[torch.from_numpy(tgt).to(self.device)] = v
        return ((self.sched.step(v_all, t_idx, x, tgt), None),
                (self.sched.step(torch.zeros_like(x), t_idx, x, tgt), None))

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """The frames of ``latents`` in 8-bit levels, each decoded within the
        first decoded clip that holds it."""
        if not _CLIPS:
            raise RuntimeError("no decoded clip was kept for the reference")
        clip = _CLIPS[0]
        idx = [next(i for i in range(clip.shape[0]) if torch.equal(clip[i], z.float().cpu()))
               for z in latents]
        frames = _u8(self.vae.decode(clip.to(self.device), clip.shape[0]))
        return frames[idx]


# -- the work of a window --------------------------------------------------------
@functools.cache
def _modules(unet_cfg: tuple, vae_cfg: tuple):
    with torch.device("meta"):
        return svd.UNet(dict(unet_cfg)), svd.VAE(dict(vae_cfg))


def _frozen(d: dict) -> tuple:
    return tuple((k, tuple(v) if isinstance(v, list) else v) for k, v in sorted(d.items()))


def single_key_least_s(b: int, s: int, h: int, d: int) -> float:
    """Least time of one Sk = 1 site on the program's single-key route: V
    read and the output written at the HBM rate (it reads neither Q nor K,
    and computes nothing)."""
    return wk.BYTES_PER_ELEMENT * b * h * d * (1 + s) / wk.PEAK_HBM_BYTES


def _least_s(b: int, s: int, h: int, d: int, sk: int) -> float:
    return single_key_least_s(b, s, h, d) if sk == 1 else wk.attention_least_s(b, s, h, d, sk)


def count(fn) -> tuple[float, float, float]:
    """(FLOPs, attention least seconds, temporal attention least seconds)
    of ``fn()`` on meta tensors: the FLOPs of ``harness/work.count`` on this
    family's reference; the least time of every attention site, each Sk = 1
    site at its route's bytes (:func:`single_key_least_s`), the temporal
    self-attention's sites recorded apart."""
    sites, tem = [], []
    orig, orig_tem = svd.attention, svd.temporal_attention

    def recorder(out, fn_):
        def record(p, q, k, v):
            out.append((q.shape[0], q.shape[1], q.shape[2], q.shape[3], k.shape[1]))
            return fn_(p, q, k, v)
        return record

    svd.attention, svd.temporal_attention = recorder(sites, orig), recorder(tem, orig_tem)
    try:
        flops, _ = wk.count(fn, svd)
    finally:
        svd.attention, svd.temporal_attention = orig, orig_tem
    return flops, sum(_least_s(*x) for x in sites), sum(_least_s(*x) for x in tem)


class Work:
    """Per-call (FLOPs, attention least seconds, temporal attention least
    seconds) of one configuration at one image size, on the reference's
    modules on the meta device."""

    def __init__(self, config: dict, image_size: int):
        self.unet, self.vae = _modules(_frozen(config["unet"]), _frozen(config["vae"]))
        self.size = image_size
        self.latent = image_size // 2 ** (len(config["vae"]["block_out_channels"]) - 1)
        self.ucfg = config["unet"]
        self._cache: dict = {}

    def _memo(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def unet_forward(self, frames: int):
        """One UNet forward over one clip of ``frames`` frames."""
        def fn():
            lat = self.latent
            x = torch.empty(frames, lat, lat, self.ucfg["in_channels"], device="meta")
            t = torch.empty(frames, device="meta")
            ctx = torch.empty(1, 1, self.ucfg["cross_attention_dim"], device="meta")
            self.unet(x, t, ctx, torch.empty(1, 3, device="meta"), frames)
        return self._memo(("unet", frames), lambda: count(fn))

    def encode(self):
        """One conditioning frame's encode (the posterior's mean)."""
        def fn():
            self.vae.encode_mode(torch.empty(1, self.size, self.size, 3, device="meta"))
        return self._memo(("enc",), lambda: (*wk.count(fn, ref_models), 0.0))

    def decode(self, frames: int):
        """One clip's decode."""
        def fn():
            self.vae.decode(torch.empty(frames, self.latent, self.latent, 4, device="meta"),
                            frames)
        return self._memo(("dec", frames), lambda: count(fn))


def work(config: dict, size: int, shape, jobs: list[dict]) -> dict:
    """Model FLOPs and least times of the window's work: each window step's
    UNet forwards over its clip (CFG counted once per half), one encode per
    conditioning frame a job uses, each job's decoded frames as clips of at
    most ``decode_chunk_size``. ``least_s_by_op``: ``attention`` over every
    attention site, ``temporal_attention`` over the frames'
    self-attention."""
    w = Work(config, size)
    halves = 2 if shape.cfg_on else 1
    total = np.zeros(3)
    for job in jobs:
        cond = set()
        for labels, is_cond in job["tasks"]:
            frames = shape.rows_per_window - int(np.count_nonzero(is_cond))
            total += halves * shape.n_denoise * shape.windows_per_task * np.array(
                w.unet_forward(frames))
            cond.update(lb for lb, c in zip(labels, is_cond) if c)
        total += len(cond) * np.array(w.encode())
        if shape.decodes:
            chunk = config["conditioning"]["decode_chunk_size"]
            n = job["targets"]
            for i in range(0, n, chunk):
                total += np.array(w.decode(min(chunk, n - i)))
    flops, least, tem = (float(x) for x in total)
    return {"flops": flops, "least_s_by_op": {"attention": least, "temporal_attention": tem}}
