"""Benchmark of the port: camera-frames/sec on the headline 3D sampling
workload (counterpart of the repository's ``bench.py``).

    python -m diffuman4d_torch.bench            # both tiers, on the card
    BENCH_MODE=smoke python -m diffuman4d_torch.bench   # the smoke tier only

Two tiers, each a JSON line on stdout with the keys of ``bench.py``'s:

* **smoke** (``smoke_window_step_sec``): one spatial CFG window step of the
  full-width UNet (batch 32 at 128^2 latents, t = 500), one temporal step
  (batch 48, 24 frames, temporal indices ``tile(arange(12), 4)``), a VAE
  encode of 4 and a decode of 2 images at 1024^2; each run once untimed,
  then once timed between two ``torch.cuda.synchronize()``.
* **full** (``cam_frames_per_sec_per_chip``): one demo_3d task of 48
  cameras at 1024^2 (inputs 1, 13, 25, 37; 44 targets), window 12, stride
  1, one round, CFG 2.0, DDIM, random bf16 weights from seed 0, on a
  synthetic scene: ``load_sample`` -> ``prepare_conditions`` ->
  ``sliding_denoise`` -> ``decode`` of the finished rows. A warm-up run, a
  warm run, and a cold run that drops the dataset's frame cache and the
  pipeline's condition caches and starts its clock before ``load_sample``.
  ``vs_baseline`` is against BASELINE.md's single-A100 estimate.

Each line also carries ``launches``: the launches of the port's kernels
during its tier, by the TPU kernel each replaces (B1 the 3D window and B2
the per-frame attention of the skewed d = 64 kernel, B8 / B9 the single
pass, B10 the two-level kernel, B3 the d = 512 attention, B4 the fused
conv), and ``device``. The shapes that each wrapper launched in each tier,
with their counts, go to ``shapes.json`` in the scene directory
(``{tier: {wrapper: [[*shape, launches], ...]}}``, by the wrappers' names
in ``flash_attention.KERNELS`` and ``conv3x3``), so that a caller can hold
each kernel against its plain version at the shapes the bench gave it. A
tier that finished is also written to
``partial.json`` in the scene directory: on a timeout (``BENCH_TIMEOUT_S``,
default 3000) a watchdog process prints the best finished line and kills
the run; on an exception the process prints that line, or a failure line
whose values are null, and exits non-zero. No line carries a number of a
tier that did not run.

Environment: ``BENCH_MODE=smoke``, ``BENCH_SCENE_DIR`` (default
``build/bench`` in the checkout; the scene is made there once),
``BENCH_TIMEOUT_S``. ``--device`` (default ``cuda``: raises without a
card) and ``--arch tiny`` (the tiny models at 64^2 images) are for the CPU
tests. The port draws
its own noise, so its images differ from the JAX bench's; only times
compare.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil
import subprocess
import sys
import time
from collections import Counter

BASELINE_CAM_FRAMES_PER_SEC = 0.55  # single-A100 estimate, see BASELINE.md
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
NUM_CAMS, INPUT_LABELS = 48, (1, 13, 25, 37)

_WATCHDOG = None  # keep a reference so the child isn't reaped early


def _scene_dir() -> str:
    return os.environ.get("BENCH_SCENE_DIR", osp.join(ROOT, "build", "bench"))


def _partial_path() -> str:
    return osp.join(_scene_dir(), "partial.json")


def _shapes_path() -> str:
    return osp.join(_scene_dir(), "shapes.json")


def save_partial(obj: dict) -> None:
    """Record the best line so far; the watchdog and the failure path print
    it, so a late failure cannot erase a tier that finished."""
    os.makedirs(_scene_dir(), exist_ok=True)
    with open(_partial_path(), "w") as fp:
        fp.write(json.dumps(obj))


def _arm_watchdog(seconds: int) -> None:
    """A separate process sharing our stdout: after ``seconds`` it prints
    the best finished line (or a timeout line) and SIGKILLs us, whatever
    the main thread is blocked in. Killed at exit when we finish first."""
    import atexit

    global _WATCHDOG
    line = json.dumps({
        "metric": "cam_frames_per_sec_per_chip", "value": None,
        "unit": f"TIMEOUT: no tier finished within {seconds}s", "vs_baseline": None})
    code = (
        "import os, sys, time, signal\n"
        f"pid = {os.getpid()}\n"
        f"time.sleep({seconds})\n"
        "try:\n"
        "    os.kill(pid, 0)\n"
        "except OSError:\n"
        "    sys.exit(0)\n"
        "try:\n"
        f"    line = open({_partial_path()!r}).read().strip()\n"
        "except OSError:\n"
        f"    line = {line!r}\n"
        "print(line, flush=True)\n"
        "os.kill(pid, signal.SIGKILL)\n"
    )
    _WATCHDOG = subprocess.Popen([sys.executable, "-c", code])
    atexit.register(_WATCHDOG.kill)


# the TPU kernel that each of the port's wrappers (but the d = 64 one,
# which serves B1 and B2) replaces
TPU_KERNELS = {"single_pass": "B8", "single_pass_batched": "B9", "two_level": "B10",
               "flash_d512": "B3", "conv3x3": "B4"}


def _wrappers() -> dict:
    """The port's kernel wrappers by their names in ``KERNELS``."""
    from diffuman4d_torch.ops import conv, flash_attention as fa

    return {**fa.KERNELS, "conv3x3": conv.conv3x3}


def launch_records() -> dict:
    return {name: Counter(fn.shapes) for name, fn in _wrappers().items()}


def shapes_since(before: dict) -> dict:
    """The launch keys of each wrapper since ``before`` (``launch_records()``),
    each with its count."""
    now = launch_records()
    return {name: [[*key, k] for key, k in sorted((now[name] - before[name]).items())]
            for name in now}


def launches_since(before: dict) -> dict:
    """Launches per TPU kernel since ``before`` (``launch_records()``); the
    d = 64 kernel's split into 3D window attention (the CFG pair as batch
    <= 2) and per-frame attention."""
    now = launch_records()
    d64 = now.pop("flash_d64") - before["flash_d64"]
    window = sum(k for (B, *_), k in d64.items() if B <= 2)
    counts = {TPU_KERNELS[name]: sum((now[name] - before[name]).values()) for name in now}
    return {"B1": window, "B2": sum(d64.values()) - window,
            **{k: counts[k] for k in ("B8", "B9", "B10", "B3", "B4")}}


def _sync(device) -> None:
    """Wait for the card's queued work (the clock reads around it)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def smoke(unet, vae, device, size: int) -> dict:
    """The cheap tier on synthetic device-resident inputs: a spatial and a
    temporal CFG window step and a VAE encode / decode."""
    import torch

    def timed(fn):
        fn()  # untimed first run
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        return time.perf_counter() - t0

    before = launch_records()
    cfg, dtype, hw = unet.config, unet.dtype, size // 8

    def window_step(L: int, tem):
        B = 2 * L  # CFG-doubled
        x = torch.zeros((B, hw, hw, cfg.in_channels), dtype=dtype, device=device)
        sk = torch.zeros((B, hw * 8, hw * 8, 3), dtype=dtype, device=device)
        t = torch.full((B,), 500, dtype=torch.int32, device=device)
        return lambda: unet(x, t, skeletons=sk, tem_indices=tem, num_frames=L)

    with torch.no_grad():
        L = 16  # spatial window, CFG batch 32
        step_s = timed(window_step(L, torch.zeros((2 * L,), dtype=torch.int32, device=device)))
        Lt = 24  # temporal window: 24 frames, CFG batch 48, flowing temporal indices
        tem = torch.arange(Lt // 2, dtype=torch.int32, device=device).repeat(4)
        step_t_s = timed(window_step(Lt, tem))
        img = torch.zeros((4, size, size, 3), dtype=dtype, device=device)
        gen = torch.Generator(device=device)
        enc_s = timed(lambda: vae.encode(img, generator=gen.manual_seed(0))) / img.shape[0]
        z = vae.encode(img, generator=gen.manual_seed(0))[:2]
        dec_s = timed(lambda: vae.decode(z)) / z.shape[0]

    line = {
        "metric": "smoke_window_step_sec",
        "value": round(step_s, 4),
        "unit": (
            f"sec/CFG-window-step (spatial, batch 32 @{hw}^2) | "
            f"temporal_step {step_t_s:.3f} s (batch 48) | "
            f"vae_encode {enc_s:.3f} s/img | vae_decode {dec_s:.3f} s/img @{size}^2"
        ),
        "vs_baseline": round(1.4 / step_s, 3),  # ~1.4 s/step A100 estimate
        "launches": launches_since(before),
    }
    return line


def full(unet, vae, device, size: int) -> dict:
    """One demo_3d task, warm-up, warm and cold."""
    import numpy as np
    import torch

    from diffuman4d_torch.data import SpaTemDataset, make_synthetic_scene
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline, SlidingConfig
    from diffuman4d_torch.sampling.sampler import SlidingIterativeSampler
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig

    before = launch_records()
    scene_dir = _scene_dir()
    if not osp.isfile(osp.join(scene_dir, "scene", "transforms.json")):
        make_synthetic_scene(scene_dir, "scene", num_cams=NUM_CAMS, num_frames=1,
                             image_size=size)
    # target_pixels=False: generation never reads the target views' pixels
    dataset = SpaTemDataset(data_dir=scene_dir, scene_label="scene", height=size, width=size,
                            target_pixels=False, skeletons_uint8=True)
    sliding = SlidingConfig(window_size=12, sliding_stride=1, bidirectional=False,
                            num_denoising_steps=1, alternation_rounds=1, guidance_scale=2.0)
    pipeline = Diffuman4DPipeline(unet, vae, Scheduler(SchedulerConfig(kind="ddim")), sliding,
                                  image_size=size, device=device)
    out_dir = osp.join(scene_dir, "out")
    num_targets = NUM_CAMS - len(INPUT_LABELS)

    def run_once(tag: str, cold: bool) -> float:
        """One demo_3d task. ``cold`` drops the frame and condition caches
        first; the clock starts before ``load_sample`` (host IO, decode and
        crop included), as in the A100 estimate."""
        shutil.rmtree(out_dir, ignore_errors=True)
        if cold:
            dataset.clear_frame_cache()
            pipeline.clear_condition_caches()
        sampler = SlidingIterativeSampler(
            dataset, pipeline, output_dir=out_dir, spa_label_range=(0, NUM_CAMS, 1),
            tem_label_range=(0, 1, 1), input_spa_labels=list(INPUT_LABELS))
        task = sampler.all_tasks[0][0]

        def mark(what, t):
            print(f"[bench]   {tag}/{what}: {time.perf_counter() - t:.1f}s", file=sys.stderr,
                  flush=True)
            return time.perf_counter()

        _sync(device)
        t0 = time.perf_counter()
        sample = sampler.load_sample(task)
        t1 = mark("load_sample", t0)
        spa, tem = sampler._grid_cells(sample.labels)
        cond = pipeline.prepare_conditions(sample)
        _sync(device)
        t1 = mark("prepare_conditions", t1)
        cells = (torch.from_numpy(spa).to(device), torch.from_numpy(tem).to(device))
        latents = sampler.grid_latents[cells]
        t_idx = sampler.grid_t_idx[spa, tem]
        windows = sampler._windows_for(task, len(sample.labels))
        latents, t_idx, _ = pipeline.sliding_denoise(cond, latents, t_idx, windows, task.domain)
        done = np.nonzero(np.asarray(t_idx) == sliding.total_steps)[0]
        _sync(device)
        t1 = mark("denoise", t1)
        images = pipeline.decode(latents[torch.from_numpy(done).to(device)])  # host copy: waits
        mark("decode", t1)
        dt = time.perf_counter() - t0
        if images.shape != (num_targets, size, size, 3) or not images.std() > 0:
            raise RuntimeError(f"bench: {tag} decoded {images.shape}, std {images.std()}")
        return dt

    def timed(tag, cold):
        t = time.perf_counter()
        dt = run_once(tag, cold=cold)
        print(f"[bench] {tag}: task {dt:.1f}s (incl. setup {time.perf_counter() - t - dt:.1f}s)",
              file=sys.stderr, flush=True)
        return dt

    timed("warmup", cold=False)
    warm_v = num_targets / timed("warm", cold=False)
    save_partial(_labelled({
        "metric": "cam_frames_per_sec_per_chip",
        "value": round(warm_v, 4),
        "unit": (f"generated {size}x{size} camera-frames/sec/chip, WARM caches (demo_3d "
                 "workload, 12 steps/target; cold tier did not finish)"),
        "vs_baseline": round(warm_v / BASELINE_CAM_FRAMES_PER_SEC, 3),
        "warm": round(warm_v, 4),
        "launches": launches_since(before),
    }, device))
    cold_v = num_targets / timed("cold", cold=True)
    return {
        "metric": "cam_frames_per_sec_per_chip",
        "value": round(cold_v, 4),
        "unit": (f"generated {size}x{size} camera-frames/sec/chip, COLD caches incl. host IO "
                 f"(demo_3d workload, 12 steps/target) | warm {warm_v:.4f} cf/s (vs_baseline "
                 f"{warm_v / BASELINE_CAM_FRAMES_PER_SEC:.3f})"),
        "vs_baseline": round(cold_v / BASELINE_CAM_FRAMES_PER_SEC, 3),
        "cold": round(cold_v, 4),
        "warm": round(warm_v, 4),
        "launches": launches_since(before),
    }


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _labelled(line: dict, device) -> dict:
    """The line with its device; a CPU run says in its unit that it is no
    measurement of a card."""
    if device.type == "cpu":
        line = {**line, "unit": "CPU run, not a card measurement | " + line["unit"]}
    return {**line, "device": _device_name(device)}


def main(argv=None) -> None:
    for stale in (_partial_path(), _shapes_path()):
        try:
            os.remove(stale)
        except OSError:
            pass
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--arch", default="full", choices=["full", "tiny"],
                    help="tiny: the CPU tests' models at 64^2 images")
    args = ap.parse_args(argv)
    smoke_only = os.environ.get("BENCH_MODE", "") == "smoke"
    _arm_watchdog(int(os.environ.get("BENCH_TIMEOUT_S", "3000")))

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench runs on the card; pass --device cpu to "
                           "run on the CPU")
    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.sampling.loader import TINY_UNET, TINY_VAE, build_models

    tiny = args.arch == "tiny"
    unet, vae = build_models(UNetConfig(**TINY_UNET) if tiny else UNetConfig(),
                             VAEConfig(**TINY_VAE) if tiny else VAEConfig(), device=device,
                             dtype=torch.bfloat16 if device.type == "cuda" else torch.float32,
                             seed=0)

    size = 64 if tiny else 1024
    shapes = {}
    for tier, run in (("smoke", smoke), ("full", full)):
        before = launch_records()
        line = _labelled(run(unet, vae, device, size), device)
        shapes[tier] = shapes_since(before)
        os.makedirs(_scene_dir(), exist_ok=True)
        with open(_shapes_path(), "w") as fp:
            json.dump(shapes, fp)
        print(json.dumps(line), flush=True)
        if tier == "smoke":
            save_partial(line)
            if smoke_only:
                return


def _emit_failure(exc: BaseException) -> None:
    """A crash still leaves a parseable last line: the best finished tier's,
    else a failure record with null values."""
    try:
        with open(_partial_path()) as fp:
            print(fp.read().strip(), flush=True)
    except OSError:
        print(json.dumps({
            "metric": "cam_frames_per_sec_per_chip", "value": None,
            "unit": (f"FAILED before any tier: {type(exc).__name__}: "
                     f"{(str(exc).splitlines() or [''])[0][:200]}"),
            "vs_baseline": None}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except BaseException as e:  # noqa: BLE001 -- print a line, then re-raise
        _emit_failure(e)
        raise
