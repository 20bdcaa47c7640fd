"""Per-unit timings of the window step's building blocks and the VAE
decoder on the card (counterpart of ``scripts/profile_unet_units.py``), with
the script's units and FLOP / byte accounting: the 3x3 conv (as the model
routes it), ``ResnetBlock2D`` and ``GroupNorm`` at the four UNet stages
(window batch 32), the transformer's feed-forward up / down pair at the
first three stage widths, the VAE decoder's stages at ``vae_batch`` 4 and
its 512 -> 1024 upsample (pooled back to its input shape, as the script
pools it, so the counted bytes stay the same).

    python -m diffuman4d_torch.profile_unet_units [--iters N] [--out PATH]

Prints one line per unit (ms, TF/s, GB/s and the share of the card's
bound) and writes the JSON (``results/unet_units.json`` by default). The
card unless ``--device cpu`` (``--arch tiny`` for the smoke-test shapes);
without a card it exits 2."""

from __future__ import annotations

import sys
from pathlib import Path

from diffuman4d_torch.utils.units import (
    Conv3x3, Units, fmt, refuse_without_card, tool_parser)

ROOT = Path(__file__).resolve().parents[1]
ARCH = {
    # UNet stages (res, channels) at window batch B (16 frames, CFG-doubled);
    # VAE decoder stages at vae_batch; the upsample's input (res, channels)
    "full": dict(B=32, temb=1280, stages=[(128, 320), (64, 640), (32, 1280), (16, 1280)],
                 vb=4, vae_stages=[(128, 512), (256, 512), (512, 256), (1024, 128)],
                 up=(512, 256)),
    "tiny": dict(B=2, temb=32, stages=[(16, 32), (8, 64)], vb=2,
                 vae_stages=[(16, 32), (32, 16)], up=(16, 16)),
}


def plan(arch: str = "full") -> list[dict]:
    """The units in the script's order with its FLOP and byte counts."""
    a = ARCH[arch]
    B, vb, out = a["B"], a["vb"], []
    for res, ch in a["stages"]:
        act = B * res * res * ch * 2
        cflops = 2.0 * B * res * res * 9 * ch * ch
        shape = (B, res, res, ch)
        out += [dict(name=f"conv3x3 {res}^2x{ch}", kind="conv", shape=shape, flops=cflops,
                     nbytes=3 * act),
                dict(name=f"resnet {res}^2x{ch}", kind="resnet", shape=shape, eps=1e-5,
                     flops=2 * cflops, nbytes=10 * act),
                dict(name=f"groupnorm {res}^2x{ch}", kind="groupnorm", shape=shape, eps=1e-5,
                     flops=0.0, nbytes=2 * act)]
    for res, ch in a["stages"][:3]:
        tok = B * res * res
        out.append(dict(name=f"ff_updown {tok}x{ch}x{4 * ch}", kind="ff", shape=(tok, ch),
                        flops=2.0 * tok * ch * 4 * ch * 2,
                        nbytes=(tok * ch * 2 + ch * 4 * ch + 4 * ch * ch + tok * 4 * ch) * 2))
    for res, ch in a["vae_stages"]:
        act = vb * res * res * ch * 2
        cflops = 2.0 * vb * res * res * 9 * ch * ch
        shape = (vb, res, res, ch)
        out += [dict(name=f"vae_conv3x3 {res}^2x{ch}", kind="conv", shape=shape, flops=cflops,
                     nbytes=3 * act),
                dict(name=f"vae_resnet {res}^2x{ch}", kind="resnet", shape=shape, eps=1e-6,
                     flops=2 * cflops, nbytes=10 * act),
                dict(name=f"vae_groupnorm {res}^2x{ch}", kind="groupnorm", shape=shape,
                     eps=1e-6, flops=0.0, nbytes=2 * act)]
    res, ch = a["up"]
    out.append(dict(name=f"vae_upsample {res}->{2 * res}x{ch}", kind="upsample",
                    shape=(vb, res, res, ch), flops=2.0 * vb * (2 * res) ** 2 * 9 * ch * ch,
                    nbytes=18 * vb * res * res * ch * 2))
    return out


def main(argv: list[str] | None = None) -> int:
    args = tool_parser(__doc__, iters=10,
                       out=str(ROOT / "results" / "unet_units.json")).parse_args(argv)
    if refuse_without_card(args.device, "profile_unet_units"):
        return 2
    from diffuman4d_torch.models.layers import GroupNorm, ResnetBlock2D, Upsample2D

    u = Units(args)
    temb_ch = ARCH[args.arch]["temb"]
    for p in plan(args.arch):
        shape, kind = p["shape"], p["kind"]
        x = u.randn(*shape)
        ch = shape[-1]
        extra = {}
        if kind == "conv":
            conv = u.module(Conv3x3(ch, ch))
            dt = u.time(lambda: conv(x))
            extra["library_ms"] = u.time(lambda: conv.library(x)) * 1e3
        elif kind == "resnet":
            vae = p["name"].startswith("vae_")
            rb = u.module(ResnetBlock2D(ch, ch, None if vae else temb_ch, 32, p["eps"]))
            temb = None if vae else u.randn(shape[0], temb_ch, scale=0.0)
            dt = u.time(lambda: rb(x, temb))
        elif kind == "groupnorm":
            gn = u.module(GroupNorm(ch, 32, p["eps"]))
            dt = u.time(lambda: gn(x))
        elif kind == "ff":
            w, w2 = u.randn(ch, 4 * ch), u.randn(4 * ch, ch)
            dt = u.time(lambda: (x @ w) @ w2)
        else:  # the upsample, pooled back to its input shape
            up = u.module(Upsample2D(ch, ch))
            b, res = shape[0], shape[1]
            dt = u.time(lambda: up(x).reshape(b, res, 2, res, 2, ch).mean(dim=(2, 4)))
        row = u.record(p["name"], dt, p["flops"], p["nbytes"], shape=list(shape), **extra)
        # the script's keys: TF/s and GB/s on every unit, zero where uncounted
        row["tflops"], row["gb_s"] = row.get("tflops", 0.0), row.pop("gbps", 0.0)
        print(f"{p['name']:36s} {fmt(row)}  {row['gb_s']:6.0f} GB/s", flush=True)
    u.write({**u.header(), "results": u.results})
    return 0


if __name__ == "__main__":
    sys.exit(main())
