"""Device memory of demo_4d's chunked denoise programs at the production
48 x 150 shapes (counterpart of ``scripts/probe_temporal_mem.py``).

For each domain it prints the schedule line of a production task -- its
rows (300 for a temporal task: 150 condition and 150 target frames; 48 for
a spatial one), windows (window 12, stride 2), windows per chunk
(``Diffuman4DPipeline._window_chunk_size`` at ``--window-chunk``) and the
padded row union of a chunk (``_chunk_pad_u``) -- then runs each program
once on the card: the chunk conditioning (pose features of one chunk's row
union from the task's uint8 skeleton rows) and one sliding chunk (one
denoising step of each of the chunk's windows, CFG fused or, for the
domains in ``--split``, split). The JAX script read the compiler's memory
analysis without running anything; the port has no such thing, so it
reports ``torch.cuda.max_memory_allocated`` during each program above what
was allocated before it (the weights and the task's inputs, both given
beside it).

    python -m diffuman4d_torch.probe_temporal_mem [--domains temporal,spatial]
        [--window-chunk 8] [--skip-chunk-cond] [--split temporal]

Random weights from seed 0. One JSON line per schedule and per program. The
card unless ``--device cpu`` (``--arch tiny`` for the smoke-test model at
64^2, memory not measured there); without a card it exits 2."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

INPUTS = [1, 13, 25, 37]  # demo_4d's input cameras of 48


def windows_of(domain: str) -> tuple[int, np.ndarray]:
    """(rows, windows) of a production task of ``domain``: window 12,
    stride 2, as the script builds them."""
    from diffuman4d_torch.sampling.windows import build_windows

    if domain == "temporal":  # 150 condition + 150 target rows
        return 300, build_windows(np.arange(150, 300), np.arange(0, 150), "temporal", 12, 2)
    return 48, build_windows(np.setdiff1d(np.arange(48), INPUTS), np.array(INPUTS),
                             "spatial", 12, 2)


def schedule(domain: str, window_chunk: int) -> dict:
    """The script's schedule line: rows, windows, windows per chunk and the
    chunk's padded row union."""
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline

    n, windows = windows_of(domain)
    c = Diffuman4DPipeline._window_chunk_size(
        argparse.Namespace(window_chunk=window_chunk), windows.shape[0])
    return {"domain": domain, "rows": n, "windows": int(windows.shape[0]), "chunk": c,
            "pad_u": int(Diffuman4DPipeline._chunk_pad_u(windows, c))}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--domains", default="temporal,spatial")
    ap.add_argument("--window-chunk", type=int, default=8)
    ap.add_argument("--skip-chunk-cond", action="store_true")
    ap.add_argument("--split", default="",
                    help="comma list of domains to run with split CFG")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arch", default="full", choices=("full", "tiny"))
    ap.add_argument("--size", type=int, default=None, help="image side (1024; tiny: 64)")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_temporal_mem: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.sampling.loader import TINY_UNET, TINY_VAE, build_models
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline, SlidingConfig
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.utils.tracing import card

    tiny, cuda = args.arch == "tiny", args.device == "cuda"
    size = args.size or (64 if tiny else 1024)
    dtype = torch.bfloat16 if cuda else torch.float32
    unet, vae = build_models(UNetConfig(**TINY_UNET) if tiny else UNetConfig(),
                             VAEConfig(**TINY_VAE) if tiny else VAEConfig(),
                             device=args.device, dtype=dtype, seed=0)
    pipe = Diffuman4DPipeline(
        unet, vae, Scheduler(SchedulerConfig(kind="ddim")),
        SlidingConfig(sliding_stride=2,
                      split_cfg_domains=tuple(d for d in args.split.split(",") if d)),
        image_size=size, window_chunk=args.window_chunk, device=args.device)
    lat, ch0 = pipe.latent_size, unet.config.block_out_channels[0]
    gen = torch.Generator(device=args.device).manual_seed(0)
    weights = sum(p.numel() * p.element_size()
                  for m in (unet, vae) for p in m.parameters()) / 2**30
    print(json.dumps({"card": card(), "weights_gb": weights}), flush=True)

    def gb(x):
        return None if x is None else x / 2**30

    def measured(name: str, fn, base: float, inputs_gb: float):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fn()
        if cuda:
            torch.cuda.synchronize()
        rep = {"program": name, "seconds": time.perf_counter() - t0,
               "peak_above_gb": gb(torch.cuda.max_memory_allocated() - base) if cuda else None,
               "weights_gb": weights, "inputs_gb": inputs_gb}
        print(json.dumps(rep), flush=True)
        return out

    for domain in args.domains.split(","):
        sched = schedule(domain, args.window_chunk)
        print(json.dumps(sched), flush=True)
        n, windows = windows_of(domain)
        c, pad_u = sched["chunk"], sched["pad_u"]
        is_cond = torch.zeros((n,), dtype=torch.bool, device=args.device)
        if domain == "temporal":
            is_cond[:150] = True
        else:
            is_cond[INPUTS] = True
        cond = {"pix_latents": torch.randn((n, lat, lat, 4), generator=gen,
                                           device=args.device).to(dtype),
                "plucker": torch.randn((n, lat, lat, 6), generator=gen,
                                       device=args.device).to(dtype),
                "is_cond": is_cond,
                "skel_rows": [torch.randint(0, 256, (size, size, 3), generator=gen,
                                            device=args.device, dtype=torch.uint8)
                              for _ in range(n)],
                "neg_pose_feature": torch.zeros((1, lat, lat, ch0), device=args.device,
                                                dtype=dtype)}
        latents = torch.randn((n, lat, lat, 4), generator=gen, device=args.device).to(dtype)
        t_idx = torch.zeros((n,), dtype=torch.long, device=args.device)
        inputs_gb = gb(sum(t.numel() * t.element_size() for t in
                           [*cond["skel_rows"], latents, t_idx]
                           + [v for k, v in cond.items() if k != "skel_rows"]))
        base = torch.cuda.memory_allocated() if cuda else 0
        wchunk = windows[:c]
        if not args.skip_chunk_cond:
            measured(f"{domain}/chunk_cond(c={c},pad_u={pad_u})",
                     lambda: pipe._chunk_cond(cond, wchunk, pad_u), base, inputs_gb)
        cond_c, wc = pipe._chunk_cond(cond, wchunk, pad_u)
        base_c = torch.cuda.memory_allocated() if cuda else 0

        def sliding_chunk():
            for w, w_cond in zip(wchunk, wc):
                wi = torch.from_numpy(w.astype(np.int64)).to(args.device)
                ci = torch.from_numpy(w_cond.astype(np.int64)).to(args.device)
                cond_w = {k: v[ci] for k, v in cond_c.items() if k != "neg_pose_feature"}
                cond_w["neg_pose_feature"] = cond_c["neg_pose_feature"]
                pipe._denoise_step(cond_w, latents[wi], t_idx[wi], domain)

        measured(f"{domain}/sliding_chunk(c={c})", sliding_chunk, base_c, inputs_gb)
        del cond, cond_c, latents
        if cuda:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
