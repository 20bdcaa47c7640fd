"""Forward plus full backward of the port's trainable attention at the
training shapes on the card (counterpart of
``scripts/bench_flash_backward.py``): ``flash_attention_train`` -- the
forward with its base-2 logsumexp (B5) and the fused dK / dV / dQ backward
(B6 + B7) -- against the library reference, PyTorch's
``scaled_dot_product_attention`` through autograd (the script's comparison
row was jax's bundled kernel; the port has no library route, so this row
times a library call that sits on no path of the port).

dQ, dK, dV and the output are compared with the plain version
(``flash_attention_train_plain``) on the same inputs: where the plain
version cannot hold the (S, S) scores, on a subset of query rows against
the full keys, with Q and dO cut to that subset on both sides. The largest
error of each (batch row, head), over its largest reference entry, must
stay within 2^-5 (``chip_smoke.py``'s bound for the backward).

    python -m diffuman4d_torch.bench_flash_backward [--shapes S,..] [--iters N]
        [--out PATH]

Writes the JSON (``results/flash_bwd.json`` by default). The card unless
``--device cpu`` (``--arch tiny`` for the smoke-test shapes); without a
card it exits 2."""

from __future__ import annotations

import json
import sys
from pathlib import Path

from diffuman4d_torch.utils.units import Units, attention_flops, refuse_without_card, tool_parser

ROOT = Path(__file__).resolve().parents[1]
# the training window's shapes (no CFG, 12 frames at 128^2 latents): 3D
# attention regroups to (1, L*hw, h, d); 2D runs per frame
SHAPES = {"full": [("train_3d@64sq_f12", 1, 49152, 10, 64),
                   ("train_3d@32sq_f12", 1, 12288, 20, 64),
                   ("train_2d@128sq_f12", 12, 16384, 5, 64),
                   ("train_2d@64sq_f12", 12, 4096, 10, 64)],
          "tiny": [("train_3d@64sq_f12", 1, 192, 2, 64), ("train_3d@32sq_f12", 1, 48, 4, 64),
                   ("train_2d@128sq_f12", 2, 64, 1, 64), ("train_2d@64sq_f12", 2, 16, 2, 64)]}
BWD_REL_TOL = 2 ** -5
PLAIN_BUDGET = 12e9  # bytes the plain version's fp32 scores may take


def flops(b: int, s: int, h: int, d: int) -> float:
    """Forward (2 products) and backward (5) = 3.5x the forward's count."""
    return 3.5 * attention_flops(b, s, h, d)


def query_rows(b: int, s: int, h: int) -> int:
    """Query rows the plain comparison takes: all of them, or the largest
    power of two whose scores and probabilities (~24 bytes an entry) fit
    the budget."""
    m = s
    while m > 64 and b * h * m * s * 24 > PLAIN_BUDGET:
        m //= 2
    return m


def _head_rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().amax(dim=(1, 3))
            / want.abs().amax(dim=(1, 3)).clamp_min(1e-30)).max().item()


def main(argv: list[str] | None = None) -> int:
    ap = tool_parser(__doc__, iters=6, out=str(ROOT / "results" / "flash_bwd.json"))
    ap.add_argument("--shapes", default="", help="comma-separated substrings of shape names")
    args = ap.parse_args(argv)
    if refuse_without_card(args.device, "bench_flash_backward"):
        return 2
    import torch
    import torch.nn.functional as F

    from diffuman4d_torch.ops.flash_backward import (
        flash_attention_train, flash_attention_train_plain)
    from diffuman4d_torch.utils.tracing import rates, timed

    u = Units(args)
    results = {}

    def fwd_bwd(attn, q, k, v, dout):
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attn(*qkv)
        return (out, *torch.autograd.grad(out, qkv, dout))

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)

    shapes = [s for s in SHAPES[args.arch]
              if not args.shapes or any(k in s[0] for k in args.shapes.split(","))]
    for name, b, s, h, d in shapes:
        q, k, v, dout = (u.randn(b, s, h, d) for _ in range(4))
        f = flops(b, s, h, d)
        row = {}
        for tag, attn in (("train", flash_attention_train), ("library", sdpa)):
            try:
                dt = timed(lambda: fwd_bwd(attn, q, k, v, dout), args.iters,
                           windows=args.windows)
                r = rates(dt, f)
                row[tag] = {"ms": r["ms"], "tflops": r["tflops"]}
                if args.device == "cuda":
                    row[tag]["pct_of_bound"] = r["pct_of_bound"]
            except RuntimeError as e:  # the library call out of memory, say
                row[tag] = {"error": str(e)[:150]}
                if tag == "train":
                    raise
            print(name, tag, row[tag], flush=True)
        m = query_rows(b, s, h)
        got = fwd_bwd(flash_attention_train, q[:, :m], k, v, dout[:, :m])
        want = fwd_bwd(flash_attention_train_plain, q[:, :m], k, v, dout[:, :m])
        row["check"] = {"query_rows": m, **{
            f"{n}_rel_err": _head_rel_err(g, w)
            for n, g, w in zip(("out", "dq", "dk", "dv"), got, want)}}
        print(name, "vs plain", row["check"], flush=True)
        if max(v for n, v in row["check"].items() if n.endswith("_rel_err")) > BWD_REL_TOL:
            raise AssertionError(f"bench_flash_backward: {name} disagrees with the plain "
                                 f"version: {row['check']}")
        row.update(shape=[b, s, h, d], flop=f)
        results[name] = row
        del q, k, v, dout, got, want
        if args.device == "cuda":
            torch.cuda.empty_cache()
    u.write({**u.header(), "method": "cuda_events_min_of_windows(forward+backward)",
             "flops_model": "3.5 * 4*b*h*s^2*d", "results": results})
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
