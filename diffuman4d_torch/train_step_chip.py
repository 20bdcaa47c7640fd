"""Production-size training step on the card (counterpart of
``scripts/train_step_chip.py``).

Optimiser steps of the full 0.87B UNet (bf16 compute, fp32 masters and
optimiser state, per-block remat) at the reference's training shape -- a
window of 12 frames at 128^2 latents with skeleton conditioning -- timing
the first step and the steady steps and reading the device memory.

    python -m diffuman4d_torch.train_step_chip [--frames 12] [--steps 3]
        [--optimizer adafactor|adamw] [--ema [device|host]] [--tag NAME]

Prints one JSON line (``metric: train_step_sec``, the fastest timed step)
and appends it to ``--out`` as a list of tiers. The run is on the card; it
raises when there is none unless ``--device cpu`` is given (with
``--arch tiny``, the CPU tests' shape: the tiny UNet at 8^2 latents).

``tflop_per_step`` is counted, not modelled: ``FlopCounterMode`` over one
more step counts the aten matmuls and convolutions, and the port's kernels
add their own from the shapes their wrappers recorded in that step: 4 B H
Sq Sk d for an attention forward, 2.5x that for the fused backward, 18 B H
W Cin Cout for a fused conv. Remat's recomputed forward is in the count,
so ``mfu_vs_989tf_bf16`` (the count over the fastest step and the H100
SXM's dense bf16 peak) is the utilisation of the work the card does, not
of the model's own FLOPs. Two options of the JAX script are refused: ``--attn
bundled`` names jax's library kernel (the port runs only its own kernels,
``train``), and ``--pallas-conv`` selects a conv path that the port does
not have (its UNet routes every conv by ``conv3x3_ok``).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time
from collections import Counter

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
PEAK_BF16_FLOPS = 989e12  # NVIDIA H100 SXM, dense bf16
HEAD_DIM = 64


def memory_gb(device: torch.device) -> tuple[float | None, float | None]:
    """Allocated and peak allocated device memory in GiB (None off the card)."""
    if device.type != "cuda":
        return None, None
    torch.cuda.synchronize(device)
    return (round(torch.cuda.memory_allocated(device) / 2**30, 2),
            round(torch.cuda.max_memory_allocated(device) / 2**30, 2))


def kernel_flops(launched: dict) -> float:
    """FLOPs of the port's kernel launches (ctypes calls, which
    ``FlopCounterMode`` does not see), from ``{wrapper name: Counter of
    launch keys}``."""
    flops = 0.0
    for (B, Sq, Sk, H), k in launched.get("flash_fwd_lse", {}).items():
        flops += k * 4.0 * B * H * Sq * Sk * HEAD_DIM
    for (B, Sq, Sk, H), k in launched.get("flash_bwd", {}).items():
        flops += k * 2.5 * 4.0 * B * H * Sq * Sk * HEAD_DIM
    for (B, H, W, cin, cout, *_), k in launched.get("conv3x3", {}).items():
        flops += k * 2.0 * 9 * B * H * W * cin * cout
    return flops


class _GlobalOnly:
    """Stands in for ``FlopCounterMode``'s module tracker, which hooks every
    module's inputs and outputs for the backward and so keeps the
    activations that remat frees (the counted full-width step ran out of
    the card's 80 GB): every FLOP is counted under "Global" only."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def counted_flops(fn) -> int:
    """FLOPs of the aten matmuls and convolutions that ``fn()`` runs,
    backward and recompute included, counted under "Global" only."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    if not hasattr(counter, "mod_tracker"):
        raise RuntimeError("FlopCounterMode has no module tracker to replace: its per-module "
                           "hooks would keep the activations that remat frees")
    counter.mod_tracker = _GlobalOnly()
    with counter:
        fn()
    if set(counter.get_flop_counts()) != {"Global"}:
        raise RuntimeError(f"FlopCounterMode tracked modules {set(counter.get_flop_counts())}: "
                           "its module tracker was not replaced")
    return counter.get_total_flops()


def make_batch(L: int, hw: int, device: torch.device, B: int = 1) -> dict:
    """The JAX script's batch: one window of ``L`` frames from
    ``np.random.default_rng(0)``, its first ``L // 3`` rows conditions."""
    rng = np.random.default_rng(0)

    def bf16(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device, torch.bfloat16)

    return {
        "latents_x0": bf16(rng.normal(size=(B, L, hw, hw, 4)) * 0.2),
        "plucker": bf16(rng.uniform(-1, 1, (B, L, hw, hw, 6))),
        "skeletons": bf16(rng.uniform(-1, 1, (B, L, hw * 8, hw * 8, 3))),
        "is_cond": torch.tensor([[True] * (L // 3) + [False] * (L - L // 3)] * B, device=device),
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--optimizer", default="adafactor", choices=["adafactor", "adamw"])
    ap.add_argument("--ema", nargs="?", const="device", default="",
                    choices=["", "device", "host"],
                    help="fp32 EMA shadow: 'device' keeps it on the card, 'host' in host "
                    "memory with asynchronous copies (training/ema.py)")
    ap.add_argument("--out", default=osp.join(ROOT, "results", "train_step_torch.json"),
                    help="append the JSON record to this file as a tier list ('' to skip)")
    ap.add_argument("--tag", default="",
                    help="tier name in the --out list (replaces a record with the same tag)")
    ap.add_argument("--attn", default="train", choices=["train", "bundled"],
                    help="'train': the port's attention kernels; 'bundled' (jax's library "
                    "kernel in the JAX script) is refused")
    ap.add_argument("--pallas-conv", action="store_true",
                    help="the JAX script's conv switch; refused here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--arch", default="full", choices=["full", "tiny"],
                    help="tiny: the CPU tests' UNet at 8^2 latents")
    args = ap.parse_args(argv)
    if args.attn == "bundled":
        ap.error("--attn bundled names jax's library kernel; the port runs its own attention "
                 "kernels only ('train')")
    if args.pallas_conv:
        ap.error("--pallas-conv: the port's UNet routes every conv by conv3x3_ok; there is "
                 "no switch")
    return args


def main(argv=None) -> dict:
    """Run the steps; returns the record that it prints."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the train step runs on the card; pass "
                           "--device cpu to run on the CPU")

    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.ops import conv, flash_backward as fb
    from diffuman4d_torch.sampling.loader import TINY_UNET, TINY_VAE, build_models
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.training.ema import HostEMA
    from diffuman4d_torch.training.trainer import TrainConfig, create_train_state, make_train_step

    tiny = args.arch == "tiny"
    L, hw = args.frames, 8 if tiny else 128
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    unet, vae = build_models(UNetConfig(**TINY_UNET) if tiny else UNetConfig(),
                             VAEConfig(**TINY_VAE) if tiny else VAEConfig(),
                             device=device, dtype=dtype, seed=0)
    del vae
    n_params = sum(p.numel() for p in unet.parameters())
    print(f"init: {n_params / 1e9:.3f}B params, {time.perf_counter() - t0:.1f}s", flush=True)

    tcfg = TrainConfig(learning_rate=1e-5, remat=True, ema_decay=0.999 if args.ema else 0.0,
                       ema_host=args.ema == "host", optimizer=args.optimizer,
                       attn_implementation=args.attn)
    state = create_train_state(unet, tcfg)
    host_ema = None
    if args.ema == "host":
        t_ema = time.perf_counter()
        host_ema = HostEMA(state.params, tcfg.ema_decay)
        print(f"host EMA shadow: {host_ema.nbytes / 2**30:.2f} GB on host, init pull "
              f"{time.perf_counter() - t_ema:.1f}s", flush=True)
    step = make_train_step(unet, Scheduler(SchedulerConfig()), tcfg)
    B = 1
    batch = make_batch(L, hw, device, B)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ema_suffix = {"": "", "device": "_ema", "host": "_emahost"}[args.ema]
    tier = args.tag or f"{args.optimizer}{ema_suffix}_f{args.frames}"
    ema_desc = {"": "", "device": "+fp32-ema", "host": "+host-ema"}[args.ema]
    unit = (f"sec/step, {n_params / 1e9:.3f}B UNet {'bf16' if dtype == torch.bfloat16 else 'fp32'}"
            f" remat, {args.optimizer}{ema_desc}, batch {B}x{L}@{hw}^2 latents")
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    def emit(record):
        record = {"tier": tier, **record, "device": device_name}
        print(json.dumps(record), flush=True)
        if args.out:
            try:
                with open(args.out) as f:
                    existing = json.load(f)
                tiers = existing if isinstance(existing, list) else [existing]
            except (OSError, ValueError):
                tiers = []
            tiers = [t for t in tiers if t.get("tier") != tier] + [record]
            os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(tiers, f, indent=2)
        return record

    t0 = time.perf_counter()
    try:
        state, metrics = step(state, batch, gen(1))
        if host_ema is not None:
            host_ema.stage(state.params)
        loss0 = float(metrics["loss"])  # waits for the step
    except torch.cuda.OutOfMemoryError:
        used, peak = memory_gb(device)
        return emit({"metric": "train_step_sec", "value": None, "oom": True,
                     "unit": unit + " -- does NOT fit the card", "hbm_used_gb": used,
                     "hbm_peak_gb": peak, "params_b": round(n_params / 1e9, 3)})
    first_step_s = time.perf_counter() - t0
    used0, peak0 = memory_gb(device)
    print(f"first step: {first_step_s:.1f}s, loss {loss0:.4f}, memory used/peak "
          f"{used0}/{peak0} GB", flush=True)

    times, fold_times, loss = [], [], loss0
    for i in range(args.steps):
        t0 = time.perf_counter()
        if host_ema is not None:
            # fold the previous step's staged copies before this step
            # overwrites the parameters in place
            tf = time.perf_counter()
            host_ema.fold()
            fold_times.append(time.perf_counter() - tf)
        state, metrics = step(state, batch, gen(2 + i))
        if host_ema is not None:
            host_ema.stage(state.params)
        loss = float(metrics["loss"])  # waits for the step
        sync()
        times.append(time.perf_counter() - t0)
    if host_ema is not None:
        host_ema.fold()
    used, peak = memory_gb(device)
    step_s = min(times) if times else first_step_s

    # one more step, counted
    wrappers = {"flash_fwd_lse": fb.flash_fwd_lse, "flash_bwd": fb.flash_bwd,
                "conv3x3": conv.conv3x3}
    before = {name: Counter(fn.shapes) for name, fn in wrappers.items()}

    def counted_step():
        step(state, batch, gen(2 + args.steps))
        sync()

    flops = counted_flops(counted_step)
    launched = {name: fn.shapes - before[name] for name, fn in wrappers.items()}
    flops += kernel_flops(launched)

    record = {
        "metric": "train_step_sec",
        "value": round(step_s, 3),
        "unit": unit + (" | tflop_per_step and mfu_vs_989tf_bf16: FLOPs counted over one step,"
                        " aten matmuls and convolutions (torch.utils.flop_counter) plus the "
                        "port's attention and conv kernels from their launch shapes; remat's "
                        "recomputed forward included (hardware, not model, FLOPs)"),
        "params_b": round(n_params / 1e9, 3),
        "loss": loss,
        "first_step_s": round(first_step_s, 1),
        "hbm_used_gb": used,
        "hbm_peak_gb": peak,
        "all_steps_s": [round(t, 3) for t in times],
        "tflop_per_step": round(flops / 1e12, 3),
        "mfu_vs_989tf_bf16": (round(flops / step_s / PEAK_BF16_FLOPS, 3)
                              if device.type == "cuda" else None),
    }
    if host_ema is not None:
        record["ema_host_gb"] = round(host_ema.nbytes / 2**30, 2)
        record["ema_fold_s"] = [round(t, 3) for t in fold_times]
    return emit(record)


if __name__ == "__main__":
    main()
