"""The Diffuman4D family: the multiview UNet (zju3dv/Diffuman4D
``UNetMultiviewCondition``) with its pose encoder or skeleton latents, the SD
VAE, DDIM or DPM-Solver++ 2M and classifier-free guidance, run by the port's
``Diffuman4DPipeline``. Its plain reference is ``benchmark/reference/models.py``
and ``sampling.py``.

Everything of the benchmark that depends on the model is here; the core
(``benchmark/harness/``) loads this file for a configuration whose ``family``
is ``d4d_multiview`` or absent, and keeps the scene, the sampler, the windows,
the seeded state, the recorders, the chain check, the verdict, the trace and
the metric readers. A family file provides:

* ``KEYS``: the configuration keys it reads, beside the core's;
* ``reference_modules(config, device)``: the plain reference's modules, whose
  parameters in order are the weight spec (``harness/weights.py``);
* ``sampler_settings(config)``: the port's sampler settings it fixes;
* ``build_pipeline(prog)``: the program from the port's public constructors,
  its weights drawn from the seed;
* ``warm_up(prog)``: the cell's own shapes run once; the seconds of a step;
* ``Reference``: the fp32 reference's conditions from the raw files, its
  window step with the eps = 0 step beside it, its decode, its control;
* ``work(config, size, shape, jobs)``: the window's FLOPs and the least time
  of each of the port's ops (``op/<name>`` ranges) that it counts.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from benchmark.harness import weights as W
from benchmark.harness import work as wk
from benchmark.reference import data as ref_data
from benchmark.reference import models as ref
from benchmark.reference import sampling as ref_sampling

KEYS = {"unet", "vae", "scheduler", "guidance_scale"}


def reference_modules(config: dict, device="meta") -> dict[str, torch.nn.Module]:
    with torch.device(device):
        return {"unet": ref.UNet(config["unet"]), "vae": ref.VAE(config["vae"])}


def sampler_settings(config: dict) -> dict:
    return {"guidance_scale": config["guidance_scale"]}


# -- the program ---------------------------------------------------------------
def build_pipeline(prog):
    """``Diffuman4DPipeline`` over ``UNetMultiviewCondition`` and
    ``AutoencoderKL`` holding the seed's weights, in the configuration's dtype
    and channels-last, and the configuration's ``Scheduler``."""
    from diffuman4d_torch.models.unet import UNetConfig, UNetMultiviewCondition
    from diffuman4d_torch.models.vae import AutoencoderKL, VAEConfig
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig

    config = prog.config
    entries = W.spec(reference_modules(config))
    weights = W.make_weights(entries, prog.seed, prog.device, prog.dtype)
    with torch.device("meta"):
        unet = UNetMultiviewCondition(UNetConfig(**_tuples(config["unet"])))
        vae = AutoencoderKL(VAEConfig(**_tuples(config["vae"])))
    for key, mod in (("unet", unet), ("vae", vae)):
        mod.to_empty(device=prog.device)
        mod.load_state_dict(W.split(weights, key), strict=True)
    del weights
    unet = unet.to(dtype=prog.dtype, memory_format=torch.channels_last).eval()
    vae = vae.to(dtype=prog.dtype, memory_format=torch.channels_last).eval()
    scheduler = Scheduler(SchedulerConfig(kind=config["scheduler"]))
    return Diffuman4DPipeline(
        unet, vae, scheduler, sliding=prog.sliding, image_size=prog.size,
        pose_cache_mb=prog.cell.traffic["pose_cache_mb"], cond_seed=prog.seed,
        device=prog.device)


@torch.no_grad()
def warm_up(prog) -> float:
    """Run the cell's own shapes once (the UNet at the window's batch, the
    VAE encoder at ``vae_batch``, the decoder at ``vae_decode_batch`` where
    the mix decodes, the pose encoder); return the seconds of one warm window
    step."""
    p, sh, dev, dt = prog.pipeline, prog.shape, prog.device, prog.dtype
    lat, ucfg = p.latent_size, prog.config["unet"]
    b = sh.denoiser_batch
    gen = torch.Generator(device=dev).manual_seed(prog.seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    x = rnd(b, lat, lat, ucfg["in_channels"])
    t = torch.full((b,), 500, device=dev, dtype=torch.int64)
    tem = torch.zeros((b,), dtype=torch.int32, device=dev)
    pose = rnd(b, lat, lat, ucfg["block_out_channels"][0]) \
        if ucfg["enable_pose_encoder"] else None
    px = rnd(p.vae_batch, prog.size, prog.size, 3).clamp(-1, 1)
    nz = torch.randn((p.vae_batch, lat, lat, 4), generator=gen, device=dev)
    for _ in range(2):
        p.encode_images(px, nz)
        if ucfg["enable_pose_encoder"]:
            p.unet.pose_encoder(px)
        if sh.decodes:
            p.decode(rnd(p.vae_decode_batch, lat, lat, 4))
        prog.sync()
        t0 = time.perf_counter()
        for _ in range(sh.denoiser_calls_per_step):
            p.unet(x, t, tem_indices=tem, num_frames=sh.rows_per_window, pose_features=pose)
        prog.sync()
        step_s = time.perf_counter() - t0
    return step_s


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


# -- the plain reference -------------------------------------------------------
def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.floor((x.float() * 0.5 + 0.5).clamp(0, 1) * 255.0 + 0.5)


class Reference:
    """The plain reference of one configuration on ``device``, fp32 weights
    from the seed, its schedule over ``total_steps``."""

    def __init__(self, config: dict, seed: int, device, entries, total_steps: int):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config, self.device = config, device
        with torch.device(device):
            self.unet = ref.UNet(config["unet"]).eval()
            self.vae = ref.VAE(config["vae"]).eval()
        w = W.make_weights(entries, seed, device, torch.bfloat16)
        for key, mod in (("unet", self.unet), ("vae", self.vae)):
            mod.load_state_dict({k: v.float() for k, v in W.split(w, key).items()}, strict=True)
        del w
        self.sched = ref_sampling.Schedule(config["scheduler"], total_steps)

    def set_fp8(self, fp8: bool) -> None:
        """The control: every product in float8 e4m3 (or back to fp32)."""
        for mod in (self.unet, self.vae):
            ref.set_prec(mod, ref.Prec(fp8=fp8))

    @torch.no_grad()
    def encode(self, images: torch.Tensor, noise: torch.Tensor, batch: int = 4) -> torch.Tensor:
        return torch.cat([self.vae.encode(images[i:i + batch], noise[i:i + batch])
                          for i in range(0, images.shape[0], batch)])

    @torch.no_grad()
    def conditions(self, scene_dir: str, labels, first_label, is_cond, cond_seed: int,
                   size: int, latent: int) -> dict:
        """The window rows' conditions, from the raw files: VAE posterior
        draws of the conditional frames, Plücker rays, and pose features or
        skeleton latents."""
        dev = self.device
        pix, skel, K, pose = ref_data.load_rows(scene_dir, [first_label] + list(labels), size)
        pix, skel, K, pose = pix[1:], skel[1:], K[1:], pose[1:]
        cond = {"rays": ref_data.plucker(torch.from_numpy(K).to(dev),
                                         torch.from_numpy(pose).to(dev), size, latent)}
        lat = torch.zeros((len(labels), latent, latent, 4), device=dev)
        rows = np.nonzero(is_cond)[0]
        if rows.size:
            noise = ref_data.label_noise(cond_seed, [labels[i] for i in rows], latent).to(dev)
            lat[torch.from_numpy(rows).to(dev)] = self.encode(
                torch.from_numpy(pix[rows]).to(dev), noise)
        cond["cond_lat"] = lat
        sk = torch.from_numpy(skel).to(dev).float() / 127.5 - 1.0
        cond["pose"] = cond["neg_pose"] = cond["skel_lat"] = None
        if self.config["unet"]["enable_pose_encoder"]:
            pe = self.unet.pose_encoder
            cond["pose"] = torch.cat([pe(sk[i:i + 4]) for i in range(0, len(labels), 4)])
            cond["neg_pose"] = pe(-torch.ones_like(sk[:1]))
        else:
            noise = ref_data.label_noise(cond_seed, list(labels), latent,
                                         ref_data.SKELETON_NOISE_TAG).to(dev)
            cond["skel_lat"] = self.encode(sk, noise)
        return cond

    @torch.no_grad()
    def step(self, domain: str, rec: dict, is_cond, cond: dict):
        """((latents, history), the same with eps = 0) of the recorded step
        ``rec`` taken from its inputs."""
        aux = None if rec["aux"] is None else {k: v.to(self.device)
                                               for k, v in rec["aux"].items()}
        return ref_sampling.window_step(
            self.unet, self.sched, self.config["guidance_scale"], domain,
            rec["x"].float().to(self.device), rec["t_idx"], is_cond, cond["cond_lat"],
            cond["rays"], cond["pose"], cond["neg_pose"], cond["skel_lat"], aux)

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """The frames of ``latents`` in 8-bit levels."""
        return _u8(torch.cat([self.vae.decode(latents[i:i + 1].float().to(self.device))
                              for i in range(latents.shape[0])]))


# -- the work of a window --------------------------------------------------------
@functools.cache
def _modules(unet_cfg: tuple, vae_cfg: tuple):
    with torch.device("meta"):
        return ref.UNet(dict(unet_cfg)), ref.VAE(dict(vae_cfg))


def _frozen(d: dict) -> tuple:
    return tuple((k, tuple(v) if isinstance(v, list) else v) for k, v in sorted(d.items()))


class Work:
    """Per-call (FLOPs, attention least seconds) of one configuration at one
    image size, counted on the reference's modules on the meta device."""

    def __init__(self, config: dict, image_size: int):
        self.unet, self.vae = _modules(_frozen(config["unet"]), _frozen(config["vae"]))
        self.size = image_size
        self.latent = image_size // 2 ** (len(config["vae"]["block_out_channels"]) - 1)
        self.ucfg = config["unet"]
        self._cache: dict = {}

    def _memo(self, key, fn):
        if key not in self._cache:
            self._cache[key] = wk.count(fn, ref)
        return self._cache[key]

    def unet_forward(self, rows: int, frames: int) -> tuple[float, float]:
        """One UNet forward over ``rows`` rows attending across ``frames``."""
        def fn():
            lat = self.latent
            x = torch.empty(rows, lat, lat, self.ucfg["in_channels"], device="meta")
            t = torch.zeros(rows, dtype=torch.int64, device="meta")
            pose = (torch.empty(rows, lat, lat, self.ucfg["block_out_channels"][0],
                                device="meta") if self.ucfg["enable_pose_encoder"] else None)
            self.unet(x, t, t, frames, pose_features=pose)
        return self._memo(("unet", rows, frames), fn)

    def vae_encode(self) -> tuple[float, float]:
        """One frame's VAE encode (the posterior draw's products only)."""
        return self._memo(("enc",), lambda: self.vae.encode(
            torch.empty(1, self.size, self.size, 3, device="meta"),
            torch.empty(1, self.latent, self.latent, 4, device="meta")))

    def vae_decode(self) -> tuple[float, float]:
        return self._memo(("dec",), lambda: self.vae.decode(
            torch.empty(1, self.latent, self.latent, 4, device="meta")))

    def pose_encode(self) -> tuple[float, float]:
        return self._memo(("pose",), lambda: self.unet.pose_encoder(
            torch.empty(1, self.size, self.size, 3, device="meta")))


def work(config: dict, size: int, shape, jobs: list[dict]) -> dict:
    """Model FLOPs and attention least time of the window's work: every
    window step's UNet forwards (CFG counted once per half), the VAE encodes
    of conditional frames and skeletons, the pose encoder's frames and the
    decodes, each frame counted once per job (what a cache would let it skip
    is not work). ``jobs``: each job's ``tasks``, (row labels, conditional
    rows) each, and its ``targets``, the target cameras a decoding job
    decodes."""
    w = Work(config, size)
    n_tasks = sum(len(job["tasks"]) for job in jobs)
    f_u, a_u = w.unet_forward(shape.rows_per_window, shape.rows_per_window)
    halves = 2 if shape.cfg_on else 1
    flops = shape.n_denoise * halves * f_u * shape.windows_per_task * n_tasks
    least = shape.n_denoise * halves * a_u * shape.windows_per_task * n_tasks
    f_e, a_e = w.vae_encode()
    f_d, a_d = w.vae_decode()
    n_cond = n_skel = 0
    for job in jobs:
        cond, skel = set(), set()
        for labels, is_cond in job["tasks"]:
            cond.update(lb for lb, c in zip(labels, is_cond) if c)
            skel.update(labels)
        n_cond += len(cond)
        n_skel += len(skel)
    flops += n_cond * f_e
    least += n_cond * a_e
    if config["unet"]["enable_pose_encoder"]:
        flops += (n_skel + len(jobs)) * w.pose_encode()[0]
    else:
        flops += n_skel * f_e
        least += n_skel * a_e
    if shape.decodes:
        n_dec = sum(job["targets"] for job in jobs)
        flops += n_dec * f_d
        least += n_dec * a_d
    return {"flops": flops, "least_s_by_op": {"attention": least}}
