"""Measured ceiling of the attention at its short-sequence shapes on the
card (counterpart of ``scripts/attn_ceiling_4k.py``).

For each of the script's four cases the attention runs on the kernel the
port's dispatch table routes it to (``ops/attention.py`` ``route``; its
name and block sizes go into the record). Beside it stand the two products
that bound it, as batched bf16 ``torch.matmul``s -- Q K^T (M = s, K = d,
N = s) and P V (M = s, K = s, N = d) -- and one ``exp2`` pass over the fp32
score footprint. The composed ceiling

    t_ceiling = t_QK + t_PV + t_exp2

is what a fused kernel could reach if the softmax cost nothing more; the
kernel's TFLOP/s against FLOPs / t_ceiling is its efficiency. As in the
script, the (s, s) scores are held only for the largest batch subset whose
fp32 block stays under 2 GB and the time is scaled by the batch, and the
65,536-token anchor has no ceiling (its scores do not fit). These GEMMs
measure a bound; they sit on no path of the port.

    python -m diffuman4d_torch.attn_ceiling [--iters N] [--out PATH]

Writes the JSON (``results/attn_ceiling.json`` by default). The card unless
``--device cpu`` (``--arch tiny`` for the smoke-test shapes); without a card
it exits 2."""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

from diffuman4d_torch.utils.units import Units, attention_flops, refuse_without_card, tool_parser

ROOT = Path(__file__).resolve().parents[1]
# (name, b, s, h, d): the script's cases -- the short per-frame and mid-block
# shapes and the 65k-token 3D shape as an anchor
CASES = {"full": [("2d@64sq", 32, 4096, 10, 64), ("3d@16sq_mid", 2, 4096, 20, 64),
                  ("2d@32sq", 32, 1024, 20, 64), ("3d_spatial@64sq", 2, 65536, 10, 64)],
         "tiny": [("2d@64sq", 4, 64, 2, 64), ("3d@16sq_mid", 2, 64, 4, 64),
                  ("2d@32sq", 4, 32, 4, 64), ("3d_spatial@64sq", 2, 256, 2, 64)]}
SCORE_BUDGET = 2 << 30  # bytes of the fp32 score block the proxy may hold


def proxy_batch(b: int, s: int, h: int) -> int:
    """Rows of the (b*h, s, s) score stack the ceiling holds (at least one;
    no ceiling is taken where one fp32 (s, s) block exceeds the budget)."""
    return max(1, min(b * h, SCORE_BUDGET // (s * s * 4)))


def main(argv: list[str] | None = None) -> int:
    args = tool_parser(__doc__, iters=20,
                       out=str(ROOT / "results" / "attn_ceiling.json")).parse_args(argv)
    if refuse_without_card(args.device, "attn_ceiling"):
        return 2
    import torch

    from diffuman4d_torch.ops.attention import dot_product_attention, route

    u = Units(args)
    report = {}

    def rnd(x):
        return None if x is None or x != x else x

    for name, b, s, h, d in CASES[args.arch]:
        q = u.randn(b, s, h, d)
        flops = attention_flops(b, s, h, d)
        impl, blocks = route(q.shape, q.shape)
        t_attn = u.time(lambda: dot_product_attention(q, q, q))
        bsub = proxy_batch(b, s, h)
        t_qk = t_pv = t_exp = math.nan
        if s * s * 4 <= SCORE_BUDGET:
            scale = b * h / bsub
            qk = q.transpose(1, 2).reshape(b * h, s, d)[:bsub]
            kt = q.permute(0, 2, 3, 1).reshape(b * h, d, s)[:bsub]
            t_qk = u.time(lambda: torch.matmul(qk, kt)) * scale
            del qk, kt
            p, vv = u.randn(bsub, s, s), u.randn(bsub, s, d)
            t_pv = u.time(lambda: torch.matmul(p, vv)) * scale
            del p, vv
            sc = u.randn(bsub, s, s, dtype=torch.float32)
            t_exp = u.time(lambda: torch.exp2(sc)) * scale
            del sc
        t_ceil = t_qk + t_pv + t_exp
        half = 2.0 * b * h * s * s * d  # FLOPs of one of the two products
        rec = u.record(name, t_attn, flops, kernel=impl, blocks=blocks, shape=[b, s, h, d])
        report[name] = {
            "b": b, "s": s, "h": h, "d": d, "impl": impl,
            "block_q": blocks.get("block_q"),
            "block_k": blocks.get("block_k", blocks.get("block_b")), "blocks": blocks,
            "iters": args.iters, "attn_ms": t_attn * 1e3, "attn_tflops": rec["tflops"],
            "attn_pct_of_bound": rec.get("pct_of_bound"),
            "proxy_batch": bsub,
            "qk_matmul_ms": rnd(t_qk * 1e3), "qk_matmul_tflops": rnd(half / t_qk / 1e12),
            "pv_matmul_ms": rnd(t_pv * 1e3), "pv_matmul_tflops": rnd(half / t_pv / 1e12),
            "exp2_ms": rnd(t_exp * 1e3), "ceiling_ms": rnd(t_ceil * 1e3),
            "ceiling_tflops": rnd(flops / t_ceil / 1e12),
            "attn_vs_ceiling_pct": rnd(100.0 * t_ceil / t_attn),
        }
        print(name, json.dumps(report[name]), flush=True)
        del q
        if args.device == "cuda":
            torch.cuda.empty_cache()
    u.write({**u.header(), "results": report})
    return 0


if __name__ == "__main__":
    sys.exit(main())
