"""Print the sliding-window schedule of a sampler preset: task counts,
windows per task, the UNet batch of a window step and the steps per target
(counterpart of ``scripts/show_schedule.py``, whose output it repeats byte
for byte), on the port's ``configs/presets.py`` and ``sampling/windows.py``.

    python -m diffuman4d_torch.show_schedule [preset] [--cams 48] [--frames 150]
        [--inputs 4]

Host-only arithmetic that touches no card; like every tool of the port it
runs where there is one unless given ``--device cpu``, and without a card it
exits 2."""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("preset", nargs="?", default="sliding_fast")
    p.add_argument("--cams", type=int, default=48)
    p.add_argument("--frames", type=int, default=150)
    p.add_argument("--inputs", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("show_schedule: no CUDA device; pass --device cpu to run on the CPU",
                  file=sys.stderr)
            return 2

    from diffuman4d_torch.configs.presets import SAMPLER_PRESETS, SamplerConfig
    from diffuman4d_torch.sampling.windows import build_windows, step_counts

    cfg = SamplerConfig()
    for k, v in SAMPLER_PRESETS[args.preset].items():
        setattr(cfg, k, v)

    peralt, total = step_counts(cfg.window_size, cfg.sliding_stride, cfg.num_denoising_steps,
                                cfg.bidirectional, cfg.alternation_rounds)
    n_targets = args.cams - args.inputs
    domains = (["spatial", "temporal"] * cfg.alternation_rounds)[: cfg.alternation_rounds]
    print(f"preset {args.preset}: window={cfg.window_size} stride={cfg.sliding_stride} "
          f"rounds={cfg.alternation_rounds} cfg={cfg.guidance_scale}")
    print(f"steps per target latent: {total}  (per alternation: {peralt})")
    total_windows = 0
    for i, d in enumerate(domains):
        if d == "spatial":
            tasks = args.frames
            w = build_windows(np.arange(n_targets), np.arange(args.inputs), "spatial",
                              cfg.window_size, cfg.sliding_stride, cfg.sliding_shift,
                              cfg.bidirectional)
        else:
            tasks = n_targets
            w = build_windows(np.arange(args.frames, 2 * args.frames), np.arange(args.frames),
                              "temporal", cfg.window_size, cfg.sliding_stride,
                              cfg.sliding_shift, cfg.bidirectional)
        batch = 2 * w.shape[1] if cfg.guidance_scale > 1 else w.shape[1]
        total_windows += tasks * w.shape[0]
        print(f"round {i+1} ({d}): {tasks} tasks x {w.shape[0]} windows "
              f"(UNet batch {batch}/step)")
    print(f"total UNet window-steps for the run: {total_windows}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
