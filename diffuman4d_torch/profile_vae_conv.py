"""The fused conv (B4, ``ops/conv.py``) against the library conv and its
plain version at the VAE decoder's shapes on the card (counterpart of
``scripts/profile_vae_conv.py``), raw and inside the resnet composition.

Per shape (``vae_batch`` 4): ``xla_conv`` is the library conv (one bf16
``F.conv2d``, cuDNN), ``pallas_conv`` the port's kernel, ``plain_conv`` its
plain version (``conv3x3_plain``); ``xla_resnet`` is the resnet's GroupNorm
-> SiLU -> conv chain twice through the library conv, ``fused_resnet`` the
composition the model runs (``groupnorm_affine`` and two fused convs, the
residual in the second's epilogue), ``plain_resnet`` that composition
through the plain version. The row names are the script's; first the kernel
is held against its plain version at ``chip_smoke.py``'s tolerance for B4
(2^-6 of the largest output), and a disagreement ends the run.

    python -m diffuman4d_torch.profile_vae_conv [--iters N] [--out PATH]

Writes the JSON (``results/vae_conv.json`` by default). The card unless
``--device cpu`` (``--arch tiny`` for the smoke-test shapes); without a card
it exits 2."""

from __future__ import annotations

import sys
from pathlib import Path

from diffuman4d_torch.utils.units import Units, fmt, refuse_without_card, tool_parser

ROOT = Path(__file__).resolve().parents[1]
ARCH = {"full": dict(vb=4, shapes=[(1024, 128), (512, 256), (256, 512), (128, 512)]),
        "tiny": dict(vb=2, shapes=[(32, 32), (16, 64)])}
CONV_REL_TOL = 2 ** -6  # chip_smoke.py's bound for B4 against its plain version
ROUTES = {"xla_conv": "library", "pallas_conv": "kernel", "plain_conv": "plain",
          "xla_resnet": "library", "fused_resnet": "kernel", "plain_resnet": "plain"}


def plan(arch: str = "full") -> list[dict]:
    """Rows in the script's order, with its FLOP counts (the plain rows
    added after each pair)."""
    vb, out = ARCH[arch]["vb"], []
    for res, ch in ARCH[arch]["shapes"]:
        cflops = 2.0 * vb * res * res * 9 * ch * ch
        for row, flops in (("xla_conv", cflops), ("pallas_conv", cflops), ("plain_conv", cflops),
                           ("xla_resnet", 2 * cflops), ("fused_resnet", 2 * cflops),
                           ("plain_resnet", 2 * cflops)):
            out.append(dict(name=f"{row} {res}^2x{ch}", row=row, shape=(vb, res, res, ch),
                            flops=flops))
    return out


def main(argv: list[str] | None = None) -> int:
    args = tool_parser(__doc__, iters=10,
                       out=str(ROOT / "results" / "vae_conv.json")).parse_args(argv)
    if refuse_without_card(args.device, "profile_vae_conv"):
        return 2
    import torch
    import torch.nn.functional as F

    from diffuman4d_torch.models.layers import ResnetBlock2D, conv_nhwc
    from diffuman4d_torch.ops.conv import conv3x3, conv3x3_plain
    from diffuman4d_torch.ops.groupnorm import groupnorm_affine

    u = Units(args)
    numerics = {}
    for p in plan(args.arch):
        (vb, res, _, ch), row = p["shape"], p["row"]
        key = f"{res}^2x{ch}"
        if row == "xla_conv":  # a new shape: its inputs and the numerics check
            x = u.randn(vb, res, res, ch)
            w = u.randn(ch, ch, 3, 3, scale=0.05, dtype=torch.float32)
            b = u.randn(ch, scale=0.1, dtype=torch.float32)
            wl, bl = w.to(u.dtype), b.to(u.dtype)
            g1, b1 = torch.ones(ch, device=u.device), torch.zeros(ch, device=u.device)
            rb = u.module(ResnetBlock2D(ch, ch, None, 32, 1e-6))
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False  # the plain conv in full fp32
            with torch.no_grad():
                want = conv3x3_plain(x, w, b).float()
                got = conv3x3(x, w, b).float()
            torch.backends.cudnn.allow_tf32 = tf32
            err, scale_ref = (got - want).abs().max().item(), want.abs().max().item()
            numerics[key] = {"max_abs_err": err, "max_abs_y": scale_ref,
                             "tol": CONV_REL_TOL * max(1.0, scale_ref)}
            print(f"numerics {key}: max|diff|={err:.4f} (max|y|={scale_ref:.1f})", flush=True)
            if not err <= numerics[key]["tol"]:
                raise AssertionError(f"profile_vae_conv: the kernel disagrees with its plain "
                                     f"version at {key}: {numerics[key]}")

            def resnet(conv, q, w=w, b=b, g1=g1, b1=b1):
                s1, sh1 = groupnorm_affine(q, g1, b1, 32, 1e-6)
                h = conv(q, w, b, s1, sh1, silu=True)
                s2, sh2 = groupnorm_affine(h, g1, b1, 32, 1e-6)
                return conv(h, w, b, s2, sh2, residual=q, silu=True)

            def library_resnet(q, rb=rb):
                h = conv_nhwc(rb.conv1, F.silu(rb.norm1(q)))
                return q + conv_nhwc(rb.conv2, F.silu(rb.norm2(h)))

            fns = {"xla_conv": lambda: F.conv2d(x.permute(0, 3, 1, 2), wl, bl,
                                                padding=1).permute(0, 2, 3, 1),
                   "pallas_conv": lambda: conv3x3(x, w, b),
                   "plain_conv": lambda: conv3x3_plain(x, w, b),
                   "xla_resnet": lambda: library_resnet(x),
                   "fused_resnet": lambda: resnet(conv3x3, x),
                   "plain_resnet": lambda: resnet(conv3x3_plain, x)}
        rec = u.record(p["name"], u.time(fns[row]), p["flops"], route=ROUTES[row],
                       shape=list(p["shape"]))
        print(f"{p['name']:36s} {fmt(rec)}", flush=True)
    u.write({**u.header(), "numerics": numerics, "results": u.results})
    return 0


if __name__ == "__main__":
    sys.exit(main())
