"""Per-unit timings at the model's real shapes on the card (counterpart of
``scripts/profile_units.py``): the 3x3 conv, GroupNorm + SiLU and
``ResnetBlock2D`` at the UNet stage shapes (CFG batch 32 at 128^2, 64^2,
32^2 and 16^2), ``MultiviewTransformerBlock`` at the window shapes, the
VAE's encode and decode at batch 2 and 1024^2, and the decoder's stage convs
and GroupNorm + SiLU, each with its TFLOP/s or GB/s and its share of the
card's bound for the script's FLOP or byte count.

    python -m diffuman4d_torch.profile_units [--section unet|vae|all] [--iters N]
        [--out PATH]

The conv unit is the port's conv as the model routes it (the fused kernel,
B4, where ``conv3x3_ok`` admits the shape, else the library conv); beside it
``library_ms`` times one bf16 ``F.conv2d``, the library reference. Prints
one line per unit and the JSON of all of them, which ``--out`` also writes.
The card unless ``--device cpu`` (``--arch tiny`` for the smoke-test
shapes); without a card it exits 2."""

from __future__ import annotations

import json
import sys

from diffuman4d_torch.utils.units import (
    Conv3x3, GroupNormSiLU, Units, conv_flops, fmt, refuse_without_card, tool_parser)

ARCH = {
    # UNet stage shapes (CFG batch, hw, channels); transformer blocks (hw,
    # channels, heads, frames): 3D attention from the 64^2 stage down, as
    # num_3d_attn_blocks=3 gates it; VAE stage convs (hw, channels)
    "full": dict(stages=[(32, 128, 320), (32, 64, 640), (32, 32, 1280), (32, 16, 1280)],
                 temb=1280, blocks=[(128, 320, 5, 1), (64, 640, 10, 16), (32, 1280, 20, 16)],
                 block_batch=32, vae="full", vae_batch=2, image=1024,
                 vae_stages=[(256, 512), (512, 512), (512, 256), (1024, 128)]),
    "tiny": dict(stages=[(2, 16, 32), (2, 8, 64)], temb=32,
                 blocks=[(8, 64, 1, 1), (4, 128, 2, 2)], block_batch=4, vae="tiny",
                 vae_batch=2, image=64, vae_stages=[(16, 32), (32, 16)]),
}
# the script's counts of the VAE at 1024^2: 2 x ~560 G an encoded image,
# ~2.5 TFLOP a decoded one
VAE_ENCODE_FLOP, VAE_DECODE_FLOP = 2 * 560e9, 2.5e12


def plan(arch: str = "full", section: str = "all") -> list[dict]:
    """The units in the script's order: name, kind, shape and the script's
    FLOP or byte count (bf16 bytes; the VAE counts only at 1024^2)."""
    a = ARCH[arch]
    out = []
    if section in ("unet", "all"):
        for b, hw, c in a["stages"]:
            shape = (b, hw, hw, c)
            out += [dict(name=f"conv3x3_{hw}x{c}", kind="conv", shape=shape,
                         flops=2 * b * hw * hw * c * c * 9),
                    dict(name=f"gn_silu_{hw}x{c}", kind="gn_silu", shape=shape,
                         nbytes=2 * b * hw * hw * c * 2),
                    dict(name=f"resnet_{hw}x{c}", kind="resnet", shape=shape,
                         flops=2 * (2 * b * hw * hw * c * c * 9))]
        B = a["block_batch"]
        for hw, c, heads, nf in a["blocks"]:
            tokens = hw * hw
            s3d = nf * tokens
            flops = (4 * (B // nf) * s3d * s3d * c + B * 4 * tokens * tokens * c
                     + B * tokens * (8 * c * c + 16 * c * c))
            out.append(dict(name=f"mvblock_{hw}x{c}", kind="mvblock",
                            shape=(B, tokens, c), heads=heads, frames=nf, flops=flops))
    if section in ("vae", "all"):
        b, img = a["vae_batch"], a["image"]
        full = img == 1024
        out += [dict(name=f"vae_encode_b{b}", kind="vae_encode", shape=(b, img, img, 3),
                     flops=b * VAE_ENCODE_FLOP if full else 0.0),
                dict(name=f"vae_decode_b{b}", kind="vae_decode",
                     shape=(b, img // 8, img // 8, 4), flops=b * VAE_DECODE_FLOP if full else 0.0)]
        for hw, c in a["vae_stages"]:
            shape = (b, hw, hw, c)
            out += [dict(name=f"vae_conv3x3_{hw}x{c}", kind="conv", shape=shape,
                         flops=conv_flops(b, hw, hw, c, c)),
                    dict(name=f"vae_gn_silu_{hw}x{c}", kind="gn_silu", shape=shape, eps=1e-6,
                         nbytes=2 * b * hw * hw * c * 2)]
    return out


def build(p: dict, temb: int):
    """The port's module of a UNet unit of :func:`plan` (random weights):
    the routed conv, GroupNorm + SiLU, ``ResnetBlock2D`` with a ``temb``
    embedding, ``MultiviewTransformerBlock`` at head dim 64."""
    from diffuman4d_torch.models.layers import ResnetBlock2D
    from diffuman4d_torch.models.transformer import MultiviewTransformerBlock

    kind, c = p["kind"], p["shape"][-1]
    if kind == "conv":
        return Conv3x3(c, c)
    if kind == "gn_silu":
        return GroupNormSiLU(c, eps=p.get("eps", 1e-5))
    if kind == "resnet":
        return ResnetBlock2D(c, c, temb)
    return MultiviewTransformerBlock(c, p["heads"], 64)


def main(argv: list[str] | None = None) -> int:
    ap = tool_parser(__doc__, iters=5)
    ap.add_argument("--section", default="all", choices=("unet", "vae", "all"))
    args = ap.parse_args(argv)
    if refuse_without_card(args.device, "profile_units"):
        return 2
    from diffuman4d_torch.models.vae import AutoencoderKL, VAEConfig
    from diffuman4d_torch.sampling.loader import TINY_VAE

    u = Units(args)
    temb = ARCH[args.arch]["temb"]
    slow = max(1, args.iters * 3 // 5)  # the script's 3 calls of 5 for the big units
    vae = None
    for p in plan(args.arch, args.section):
        shape, kind = p["shape"], p["kind"]
        x = u.randn(*shape)
        extra = {}
        if kind == "conv":
            conv = u.module(build(p, temb))
            dt = u.time(lambda: conv(x))
            extra["library_ms"] = u.time(lambda: conv.library(x)) * 1e3
        elif kind in ("gn_silu", "mvblock"):
            mod = u.module(build(p, temb))
            kw = {"num_frames": p["frames"]} if kind == "mvblock" else {}
            dt = u.time(lambda: mod(x, **kw), n=slow if kind == "mvblock" else None)
        elif kind == "resnet":
            rb, e = u.module(build(p, temb)), u.randn(shape[0], temb)
            dt = u.time(lambda: rb(x, e))
        else:  # the VAE
            if vae is None:
                cfg = VAEConfig() if ARCH[args.arch]["vae"] == "full" else VAEConfig(**TINY_VAE)
                vae = u.module(AutoencoderKL(cfg))
            if kind == "vae_encode":
                noise = u.randn(shape[0], shape[1] // 8, shape[2] // 8, 4)
                dt = u.time(lambda: vae.encode(x, noise=noise), n=slow)
                extra["note"] = "(~560 GFLOP/img)"
            else:
                dt = u.time(lambda: vae.decode(x), n=slow)
                extra["note"] = "(~2.5 TFLOP/img)"
        row = u.record(p["name"], dt, p.get("flops", 0.0), p.get("nbytes", 0.0),
                       shape=list(shape), **extra)
        print(p["name"], fmt(row), extra.get("note", ""), flush=True)
    payload = {**u.header(), "results": u.results}
    print(json.dumps(u.results, indent=2))
    u.write(payload)
    return 0


if __name__ == "__main__":
    sys.exit(main())
