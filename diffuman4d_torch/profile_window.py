"""The hot units of a window on the card (counterpart of
``scripts/profile_window.py``): the attention at the model's 3D and
per-frame shapes through ``ops/attention.py``'s ``dot_product_attention``
(so each takes the kernel the dispatch table routes it to, named in its
record) beside the plain version where S <= 8,192, then one full UNet
window step (CFG batch 2L) and the VAE encode and decode of 4 images.

    python -m diffuman4d_torch.profile_window [--domain spatial|temporal]
        [--latent 128] [--window 12] [--attn-only] [--iters N] [--out PATH]

Random weights from seed 0 (``sampling.loader.build_models``). Prints one
line per unit and the JSON of all of them, which ``--out`` also writes. The
card unless ``--device cpu`` (``--arch tiny`` for the smoke-test model, at
latent 8 and window 2 unless given); without a card it exits 2."""

from __future__ import annotations

import json
import sys

from diffuman4d_torch.utils.units import (
    Units, attention_flops, refuse_without_card, tool_parser)

PLAIN_MAX_S = 8192  # the plain version holds the (S, S) scores: up to here


def attention_shapes(domain: str = "spatial", latent: int = 128,
                     window: int = 12) -> list[tuple]:
    """(name, batch, seq, heads, head dim), as the script lists them."""
    L = window + (4 if domain == "spatial" else window)
    return [("3d@64^2", 2, L * (latent // 2) ** 2, 10, 64),
            ("3d@32^2", 2, L * (latent // 4) ** 2, 20, 64),
            ("2d@64^2", 2 * L, (latent // 2) ** 2, 10, 64)]


def main(argv: list[str] | None = None) -> int:
    ap = tool_parser(__doc__, iters=3)
    ap.add_argument("--domain", default="spatial", choices=("spatial", "temporal"))
    ap.add_argument("--latent", type=int, default=None, help="latent side (128; tiny: 8)")
    ap.add_argument("--window", type=int, default=None, help="window size (12; tiny: 2)")
    ap.add_argument("--attn-only", action="store_true")
    args = ap.parse_args(argv)
    if refuse_without_card(args.device, "profile_window"):
        return 2
    tiny = args.arch == "tiny"
    latent = args.latent or (8 if tiny else 128)
    window = args.window or (2 if tiny else 12)
    import torch

    from diffuman4d_torch.ops import flash_attention as fa
    from diffuman4d_torch.ops.attention import dot_product_attention, route

    u = Units(args)
    results = {}
    for name, b, s, h, d in attention_shapes(args.domain, latent, window):
        q, k, v = (u.randn(b, s, h, d) for _ in range(3))
        flops = attention_flops(b, s, h, d)
        kernel, blocks = route(q.shape, k.shape)
        rec = u.record(name, u.time(lambda: dot_product_attention(q, k, v)), flops,
                       kernel=kernel, blocks=blocks, shape=[b, s, h, d])
        results[name] = {"batch": b, "seq": s, "heads": h, "kernel": kernel, "blocks": blocks,
                         "flash_ms": rec["ms"], "flash_tflops": rec["tflops"]}
        if "pct_of_bound" in rec:
            results[name]["flash_pct_of_bound"] = rec["pct_of_bound"]
        if s <= PLAIN_MAX_S:  # the plain version materialises the (s, s) scores
            dt = u.time(lambda: fa.attention_plain(q, k, v))
            results[name]["xla_ms"] = dt * 1e3
            results[name]["xla_tflops"] = flops / dt / 1e12
        print(name, results[name], flush=True)
        del q, k, v
        if args.device == "cuda":
            torch.cuda.empty_cache()

    if not args.attn_only:
        from diffuman4d_torch.models.unet import UNetConfig
        from diffuman4d_torch.models.vae import VAEConfig
        from diffuman4d_torch.sampling.loader import TINY_UNET, TINY_VAE, build_models

        L = window + (4 if args.domain == "spatial" else window)
        ucfg = UNetConfig(**TINY_UNET) if tiny else UNetConfig()
        unet, vae = build_models(ucfg, VAEConfig(**TINY_VAE) if tiny else VAEConfig(),
                                 device=args.device, dtype=u.dtype, seed=0)
        B, hw = 2 * L, latent  # CFG
        zeros = dict(device=u.device, dtype=u.dtype)
        sample = torch.zeros((B, hw, hw, ucfg.in_channels), **zeros)
        pose = torch.zeros((B, hw, hw, ucfg.block_out_channels[0]), **zeros)
        t = torch.zeros((B,), dtype=torch.long, device=u.device)
        dt = u.time(lambda: unet(sample, t, num_frames=L, pose_features=pose))
        results["unet_window_step"] = {"batch": B, "latent": hw, "ms": dt * 1e3,
                                       "steps_per_s": 1 / dt}
        print("unet_window_step", results["unet_window_step"], flush=True)
        del unet
        img = torch.zeros((4, hw * 8, hw * 8, 3), **zeros)
        lat = torch.zeros((4, hw, hw, 4), **zeros)
        noise = torch.zeros((4, hw, hw, 4), device=u.device)
        t_enc = u.time(lambda: vae.encode(img, noise=noise))
        t_dec = u.time(lambda: vae.decode(lat))
        results["vae"] = {"encode4_ms": t_enc * 1e3, "decode4_ms": t_dec * 1e3}
        print("vae", results["vae"], flush=True)
    print(json.dumps(results, indent=2))
    u.write({**u.header(), "domain": args.domain, "latent": latent, "window": window,
             "results": results})
    return 0


if __name__ == "__main__":
    sys.exit(main())
