"""The VAE decoder stage by stage on the card (counterpart of
``scripts/profile_vae.py``): each stage of the decoder at 1024^2 --
``MidBlock`` through ``conv_out`` -- timed alone with its FLOP count, the
stage sum in ms an image, then the raw conv (as the model routes it, with
the library conv beside it), GroupNorm + SiLU and upsample references at
the decoder's shapes.

    python -m diffuman4d_torch.profile_vae [--batch N] [--iters N] [--out PATH]

Random weights (timing only). Prints one line per stage and reference and
writes the JSON (``results/profile_vae.json`` by default). The card unless
``--device cpu`` (``--arch tiny`` for the smoke-test shapes); without a
card it exits 2."""

from __future__ import annotations

import sys
from pathlib import Path

from diffuman4d_torch.utils.units import (
    Conv3x3, GroupNormSiLU, Units, conv_flops, fmt, refuse_without_card, tool_parser)

ROOT = Path(__file__).resolve().parents[1]
# the decoder's latent side and its stage channels (128^2 -> 1024^2 at
# 512, 512, 256, 128 channels)
ARCH = {"full": dict(lat=128, ch=(512, 256, 128)), "tiny": dict(lat=8, ch=(32, 16, 16))}


def resnet_flops(b, h, w, cin, cout):
    f = conv_flops(b, h, w, cin, cout) + conv_flops(b, h, w, cout, cout)
    if cin != cout:
        f += 2 * cin * cout * b * h * w
    return f


def plan(arch: str = "full", b: int = 1) -> tuple[list[dict], list[dict]]:
    """(stages, references) in the script's order: name, kind, input
    shape, output channels, the script's FLOP count and, for a stage, how
    many times the decoder runs it."""
    L, (c0, c1, c2) = ARCH[arch]["lat"], ARCH[arch]["ch"]

    def unit(name, kind, hw, cin, cout, flops, repeat=1):
        return dict(name=name, kind=kind, shape=(b, hw, hw, cin), cout=cout, flops=flops,
                    repeat=repeat)

    stages = [
        unit(f"mid({c0})@{L}^2", "mid", L, c0, c0,
             2 * resnet_flops(b, L, L, c0, c0) + 4 * L**4 * c0 * b + 4 * 2 * c0 * c0 * b * L**2),
        unit(f"res{c0}@{L}^2 x3", "resnet", L, c0, c0, resnet_flops(b, L, L, c0, c0), 3),
        unit(f"up{c0}@{L}->{2 * L}", "upsample", L, c0, c0, conv_flops(b, 2 * L, 2 * L, c0, c0)),
        unit(f"res{c0}@{2 * L}^2 x3", "resnet", 2 * L, c0, c0,
             resnet_flops(b, 2 * L, 2 * L, c0, c0), 3),
        unit(f"up{c0}@{2 * L}->{4 * L}", "upsample", 2 * L, c0, c0,
             conv_flops(b, 4 * L, 4 * L, c0, c0)),
        unit(f"res{c0}->{c1}@{4 * L}^2", "resnet", 4 * L, c0, c1,
             resnet_flops(b, 4 * L, 4 * L, c0, c1)),
        unit(f"res{c1}@{4 * L}^2 x2", "resnet", 4 * L, c1, c1,
             resnet_flops(b, 4 * L, 4 * L, c1, c1), 2),
        unit(f"up{c1}@{4 * L}->{8 * L}", "upsample", 4 * L, c1, c1,
             conv_flops(b, 8 * L, 8 * L, c1, c1)),
        unit(f"res{c1}->{c2}@{8 * L}^2", "resnet", 8 * L, c1, c2,
             resnet_flops(b, 8 * L, 8 * L, c1, c2)),
        unit(f"res{c2}@{8 * L}^2 x2", "resnet", 8 * L, c2, c2,
             resnet_flops(b, 8 * L, 8 * L, c2, c2), 2),
        unit(f"out: norm+silu+conv@{8 * L}^2", "out", 8 * L, c2, 3,
             conv_flops(b, 8 * L, 8 * L, c2, 3)),
    ]
    refs = [unit(f"conv3x3 {ch}ch@{hw}^2", "conv", hw, ch, ch, conv_flops(b, hw, hw, ch, ch))
            for ch, hw in [(c0, L), (c0, 2 * L), (c1, 4 * L), (c2, 8 * L), (c1, 8 * L)]]
    refs += [unit(f"GN+silu {ch}ch@{hw}^2", "gn_silu", hw, ch, ch, 0)
             for ch, hw in [(c0, 2 * L), (c1, 4 * L), (c2, 8 * L)]]
    refs += [unit(f"upsample2x {ch}ch@{hw}^2", "upsample", hw, ch, ch,
                  conv_flops(b, 2 * hw, 2 * hw, ch, ch))
             for ch, hw in [(c0, L), (c0, 2 * L), (c1, 4 * L)]]
    return stages, refs


def build(kind: str, cin: int, cout: int):
    """The port's module of a stage or reference (random weights)."""
    from torch import nn

    from diffuman4d_torch.models.layers import ResnetBlock2D, Upsample2D
    from diffuman4d_torch.models.vae import MidBlock

    if kind == "mid":
        return MidBlock(cin)
    if kind == "resnet":
        return ResnetBlock2D(cin, cout, None, 32, 1e-5)
    if kind == "upsample":
        return Upsample2D(cin, cout)
    if kind == "out":
        return nn.Sequential(GroupNormSiLU(cin, eps=1e-6), Conv3x3(cin, cout))
    if kind == "gn_silu":
        return GroupNormSiLU(cin, eps=1e-6)
    return Conv3x3(cin, cout)


def main(argv: list[str] | None = None) -> int:
    ap = tool_parser(__doc__, iters=10, out=str(ROOT / "results" / "profile_vae.json"))
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args(argv)
    if refuse_without_card(args.device, "profile_vae"):
        return 2
    import torch

    u = Units(args)
    print(f"device: {args.device}, batch {args.batch}", flush=True)
    stages, refs = plan(args.arch, args.batch)
    total = 0.0
    for i, p in enumerate(stages + refs):
        if i == len(stages):
            print(f"--- stage sum: {total * 1e3 / args.batch:.1f} ms/img", flush=True)
            print("\nraw conv / norm references:", flush=True)
        x = u.randn(*p["shape"])
        mod = u.module(build(p["kind"], p["shape"][-1], p["cout"]))
        dt = u.time(lambda: mod(x))
        extra = {}
        if p["kind"] == "conv":
            extra["library_ms"] = u.time(lambda: mod.library(x)) * 1e3
        row = u.record(p["name"], dt, p["flops"], shape=list(p["shape"]), cout=p["cout"],
                       repeat=p["repeat"], **extra)
        if i < len(stages):
            total += dt * p["repeat"]
        print(f"{p['name']:34s} {fmt(row)}", flush=True)
        del mod, x
        if args.device == "cuda":
            torch.cuda.empty_cache()
    u.write({**u.header(), "batch": args.batch, "stage_sum_ms_per_img": total * 1e3 / args.batch,
             "stages": [p["name"] for p in stages], "results": u.results})
    return 0


if __name__ == "__main__":
    sys.exit(main())
