"""Time this tree's attention and conv kernels against another checkout's,
in turns, on one card.

    python -m diffuman4d_torch.bench_attention_fwd --baseline DIR [--rows b1,b3,b4] [--out PATH]

``DIR`` is the root of another checkout of the repository (for example an
unpacked ``git archive`` of the parent commit). Its kernel sources under
``diffuman4d_torch/csrc`` (``flash_attn.cu``, ``flash_attn_single.cu``,
``flash_attn_hopper.cu``, ``flash_attn_bwd.cu``, ``conv3x3.cu``, whichever
it has) are compiled with this tree's ``nvcc`` flags and loaded with
ctypes; its C entries ``flash_attn_fwd`` (the FA2-era B1/B2, and B3 at
D = 512 before B3 had its own source) and ``flash_attn_single_pass`` (the
``mma.sync`` B8/B9) take the arguments of :data:`BASELINE_FWD_ENTRIES`,
``flash_attn_fwd_two_level`` (B10), ``flash_attn_fwd_lse`` (B5) and
``conv3x3_fwd`` (B4) those that this tree's entries of the same names take,
and its ``flash_attn_bwd_dkdv`` + ``flash_attn_bwd_dq`` (B6 + B7, the
backward before it was fused) those of :data:`BASELINE_BWD_ENTRIES`, so
both run on the same tensors. For each shape the baseline and this tree
are timed in the order baseline, this tree, this tree, baseline (CUDA
events around a few launches after a warm-up, the minimum of 3 windows
each), and their outputs are compared. Rows (``--rows`` picks some;
default all):

* ``b1``: the baseline's FA2 ``flash_attn_fwd`` against this tree's
  skewed-pipeline B1/B2 (``flash_attention_d64`` at the blocks the table
  routes the shape to, else its default) at the two hottest sampling
  shapes;
* ``b8``: the baseline's ``mma.sync`` single pass (B8 at block_q 64, B9 at
  block_q 64 and block_b 2) against this tree's (B8 at block_q 128, B9 at
  block_q 128 and block_b 5) at the per-frame 16^2 mid block, B32 S256 H20;
* ``b10``: the baseline's B10 at its table's winner against this tree's B10
  at each staging of ``TWO_LEVEL_CONFIGS``, at the two hottest sampling
  shapes. The control for clock differences where both trees have the same
  ``flash_attn_hopper.cu`` and headers (the 192 x 256 x 64 staging is then
  the same code on both sides);
* ``b5``: the baseline's B5 against this tree's at ``FWD_LSE_BLOCKS``, and
  this tree's B10 stagings at the same shapes (the sweep that chose
  ``FWD_LSE_BLOCKS``), at the train step's heaviest attention shapes;
* ``bwd``: the baseline's B6 + B7 (two launches) against this tree's fused
  backward (one launch) on the same Qs, K, V, dO, L2 and delta, at the same
  train shapes, with the largest difference of dQ, dK and dV;
* ``b3``: the baseline's d = 512 attention (its ``flash_attn_fwd`` at
  D = 512) against this tree's ``flash_attention_d512`` at the VAE mid
  block's B2 S16,384 H1;
* ``b4``: the baseline's fused conv against this tree's at the six
  :data:`CONV_SHAPES` with the decoder's epilogue variants
  (:data:`CONV_VARIANTS`), each with its largest output difference.

Prints one line per timing and writes the whole result as JSON. Exits 2
without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

# (name, B, S, H): the sampling path's two hottest d = 64 shapes and the
# train step's four heaviest
SAMPLING_SHAPES = [("3d_spatial@64sq", 2, 65536, 10), ("2d@128sq", 32, 16384, 5)]
TRAIN_SHAPES = [("train_3d@64sq", 1, 49152, 10), ("train_2d@128sq", 12, 16384, 5),
                ("train_3d@32sq", 1, 12288, 20), ("train_2d@64sq", 12, 4096, 10)]
# the parent's table winner for B10 at the d = 64 shapes with S >= 4,096
BASELINE_B10_BLOCKS = (192, 256, 64)
# (B, S, H) of the VAE mid-block attention at d = 512 (128^2 latents)
B3_SHAPE = (2, 16384, 1)
# (B, H, W, Cin, Cout) of the decoder's convs at 1024^2 images: chip_smoke.py's
# CONV_SHAPES; and the epilogue variants (affine, silu, residual)
CONV_SHAPES = [(2, 1024, 1024, 128, 128), (2, 512, 512, 256, 256), (2, 256, 256, 512, 512),
               (2, 128, 128, 512, 512), (2, 1024, 1024, 256, 128), (2, 512, 512, 512, 256)]
CONV_VARIANTS = {"plain": (False, False, False), "affine_silu": (True, True, False),
                 "affine_silu_res": (True, True, True)}
# (B, S, H) of the per-frame 16^2 mid block, the single pass's heaviest path
# shape; the baseline's and this tree's B8 block_q and B9 (block_q, block_b)
B8_SHAPE = (32, 256, 20)
B8_BLOCKS = {"baseline": ((64, 1), (64, 2)), "this": ((128, 1), (128, 5))}
ROWS = ("b1", "b8", "b10", "b5", "bwd", "b3", "b4")
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# the baseline's FA2 forward and mma.sync single pass (this tree has neither)
BASELINE_FWD_ENTRIES = {"flash_attn_fwd": [_PTR] * 4 + [_INT] * 5 + [_PTR],
                        "flash_attn_single_pass": [_PTR] * 4 + [_INT] * 6 + [_PTR]}
# the baseline's two backward entries (this tree has one fused entry instead)
BASELINE_BWD_ENTRIES = {"flash_attn_bwd_dq": [_PTR] * 7 + [_INT] * 4 + [_PTR],
                        "flash_attn_bwd_dkdv": [_PTR] * 8 + [_INT] * 4 + [_PTR]}


def _build_baseline(root: Path) -> dict:
    """The baseline's C entries by name: each attention source it has,
    compiled into ``build/baseline`` (keyed by a hash of the source and its
    headers)."""
    from diffuman4d_torch.ops import cuda_build

    csrc = root / "diffuman4d_torch" / "csrc"
    headers = b"".join(p.read_bytes() for p in sorted(csrc.glob("*.cuh")))
    types = {n: t for lib in ("flash_attn_hopper", "conv3x3_hopper")
             for n, t in cuda_build.ENTRIES[lib].items()}
    types.update(BASELINE_FWD_ENTRIES)
    types.update(BASELINE_BWD_ENTRIES)
    entries = {}
    for name in ("flash_attn", "flash_attn_single", "flash_attn_hopper", "flash_attn_bwd",
                 "conv3x3"):
        src = csrc / f"{name}.cu"
        if not src.is_file():
            continue
        h = hashlib.sha256(src.read_bytes() + headers)
        out = cuda_build.BUILD_DIR / "baseline" / f"lib{name}_{h.hexdigest()[:12]}.so"
        if not out.is_file():
            out.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)],
                           check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(out))
        for fn_name, argtypes in types.items():
            fn = getattr(lib, fn_name, None)
            if fn is not None and fn_name not in entries:
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                entries[fn_name] = fn
    return entries


def _timed_ms(fn, n: int) -> float:
    from diffuman4d_torch.utils.tracing import timed

    return timed(fn, n) * 1e3


def _in_turns(base, new, n: int) -> dict:
    """Baseline, this tree, this tree, baseline."""
    b1, n1, n2, b2 = (_timed_ms(f, n) for f in (base, new, new, base))
    return {"baseline_ms": [b1, b2], "this_ms": [n1, n2],
            "speedup": (b1 + b2) / (n1 + n2)}


def run(baseline: Path, rows=ROWS) -> dict:
    import torch

    from diffuman4d_torch.ops import attention as attn
    from diffuman4d_torch.ops import conv, cuda_build
    from diffuman4d_torch.ops import flash_attention as fa
    from diffuman4d_torch.ops import flash_backward as fb

    lib = _build_baseline(baseline)
    stream = torch.cuda.current_stream().cuda_stream

    def call(name, *args):
        cuda_build.check(lib[name](*args, stream), f"baseline {name}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    res: dict = {row: {} for row in rows}

    def inputs(B, S, H):
        return tuple(torch.randn((B, S, H, 64), generator=gen, device="cuda").bfloat16()
                     for _ in range(3))

    def log(row: str, r: dict) -> None:
        print(f"{row}: baseline {r['baseline_ms'][0]:.4f} / {r['baseline_ms'][1]:.4f} ms, this "
              f"tree {r['this_ms'][0]:.4f} / {r['this_ms'][1]:.4f} ms, x{r['speedup']:.3f}"
              + (f", max abs diff {r['max_abs_diff']:.3e}" if "max_abs_diff" in r else ""),
              flush=True)

    for name, B, S, H in SAMPLING_SHAPES if {"b1", "b10"} & set(rows) else ():
        q, k, v = inputs(B, S, H)
        flops = 4.0 * B * H * S * S * 64
        n = max(1, min(20, math.ceil(0.02 / (flops / 400e12))))
        ob = torch.empty_like(q)

        def b1_base():
            call("flash_attn_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), ob.data_ptr(),
                 B, H, S, S, 64)

        if "b1" in rows:
            routed, params = attn.route(q.shape, k.shape)
            blocks = tuple(params.values()) if routed == "flash_d64" else fa.SKEW_DEFAULT
            res["b1"][name] = r = _in_turns(
                b1_base, lambda: fa.flash_attention_d64(q, k, v, *blocks), n)
            b1_base()
            r["max_abs_diff"] = (fa.flash_attention_d64(q, k, v, *blocks).float()
                                 - ob.float()).abs().max().item()
            r["blocks"] = list(blocks)
            r["tflops"] = flops / (sum(r["this_ms"]) / 2) / 1e9
            log(f"b1 {name} {blocks}", r)
        if "b10" not in rows:
            del q, k, v, ob
            torch.cuda.empty_cache()
            continue

        def b10_base():
            call("flash_attn_fwd_two_level", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 ob.data_ptr(), B, H, S, S, *BASELINE_B10_BLOCKS)

        b10_base()
        want = ob.float()
        res["b10"][name] = {}
        for blocks in fa.TWO_LEVEL_CONFIGS:
            r = _in_turns(b10_base, lambda: fa.flash_attention_two_level(q, k, v, *blocks), n)
            r["max_abs_diff"] = (fa.flash_attention_two_level(q, k, v, *blocks).float()
                                 - want).abs().max().item()
            r["tflops"] = flops / (sum(r["this_ms"]) / 2) / 1e9
            res["b10"][name]["x".join(map(str, blocks))] = r
            log(f"b10 {name} {blocks}", r)
        del q, k, v, ob, want
        torch.cuda.empty_cache()

    if "b8" in rows:
        B, S, H = B8_SHAPE
        q, k, v = inputs(B, S, H)
        ob = torch.empty_like(q)
        flops = 4.0 * B * H * S * S * 64
        for (bq_b, bb_b), (bq, bb) in zip(*B8_BLOCKS.values()):

            def b8_base():
                call("flash_attn_single_pass", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     ob.data_ptr(), B, H, S, S, bq_b, bb_b)

            def b8_this():
                if bb == 1:
                    return fa.flash_attention_single_pass(q, k, v, bq)
                return fa.flash_attention_single_pass_batched(q, k, v, bq, bb)

            key = f"B{B}xS{S}xH{H}:base{bq_b}x{bb_b}:this{bq}x{bb}"
            res["b8"][key] = r = _in_turns(b8_base, b8_this, 200)
            b8_base()
            r["max_abs_diff"] = (b8_this().float() - ob.float()).abs().max().item()
            r["tflops"] = flops / (sum(r["this_ms"]) / 2) / 1e9
            log(f"b8 {key}", r)
        del q, k, v, ob
        torch.cuda.empty_cache()

    for name, B, S, H in TRAIN_SHAPES if {"b5", "bwd"} & set(rows) else ():
        q, k, v = inputs(B, S, H)
        qs = fb.scale_q(q)
        flops = 4.0 * B * H * S * S * 64
        n = max(1, min(20, math.ceil(0.02 / (flops / 400e12))))
        ob = torch.empty_like(q)
        l2b = torch.empty((B, H, S), device="cuda")

        def b5_base():
            call("flash_attn_fwd_lse", qs.data_ptr(), k.data_ptr(), v.data_ptr(), ob.data_ptr(),
                 l2b.data_ptr(), B, H, S, S)

        if "b5" in rows:
            r = _in_turns(b5_base, lambda: fb.flash_fwd_lse(qs, k, v), n)
            b5_base()
            out, l2 = fb.flash_fwd_lse(qs, k, v)
            r["max_abs_diff"] = (out.float() - ob.float()).abs().max().item()
            r["l2_max_abs_diff"] = (l2 - l2b).abs().max().item()
            r["stagings_ms"] = {"x".join(map(str, blocks)): _timed_ms(
                lambda: fa.flash_attention_two_level(q, k, v, *blocks), n)
                for blocks in fa.TWO_LEVEL_CONFIGS}
            res["b5"][name] = r
            log(f"b5 {name} {fb.FWD_LSE_BLOCKS}", r)
            print(f"  b10 stagings at {name}: {r['stagings_ms']}", flush=True)
            del out, l2
        if "bwd" in rows:
            dout = inputs(B, S, H)[0]
            out, l2 = fb.flash_fwd_lse(qs, k, v)
            delta = fb.attention_delta(out, dout)
            dq_b, dk_b, dv_b = (torch.empty_like(x) for x in (qs, k, v))
            args = [x.data_ptr() for x in (qs, k, v, dout, l2, delta)]

            def bwd_base():
                call("flash_attn_bwd_dkdv", *args, dk_b.data_ptr(), dv_b.data_ptr(), B, H, S, S)
                call("flash_attn_bwd_dq", *args, dq_b.data_ptr(), B, H, S, S)

            nb = max(1, math.ceil(n * 2 / 5))  # five products to the forward's two
            r = _in_turns(bwd_base, lambda: fb.flash_bwd(qs, k, v, dout, l2, delta), nb)
            bwd_base()
            got = fb.flash_bwd(qs, k, v, dout, l2, delta)
            r["max_abs_diff"] = max((a.float() - b.float()).abs().max().item()
                                    for a, b in zip(got, (dq_b, dk_b, dv_b)))
            r["rel_diff"] = {nm: ((a.float() - b.float()).abs().max()
                                  / b.float().abs().max()).item()
                             for nm, a, b in zip(("dq", "dk", "dv"), got, (dq_b, dk_b, dv_b))}
            r["tflops"] = 5 * flops / 2 / (sum(r["this_ms"]) / 2) / 1e9
            res["bwd"][name] = r
            log(f"bwd {name}", r)
            print(f"  bwd relative differences {r['rel_diff']}, {r['tflops']:.1f} TFLOP/s",
                  flush=True)
            del dout, out, l2, delta, dq_b, dk_b, dv_b, got
        del q, k, v, qs, ob, l2b
        torch.cuda.empty_cache()

    if "b3" in rows:
        B, S, H = B3_SHAPE
        q, k, v = (torch.randn((B, S, H, 512), generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        ob = torch.empty_like(q)
        flops = 4.0 * B * H * S * S * 512

        def b3_base():
            call("flash_attn_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), ob.data_ptr(),
                 B, H, S, S, 512)

        n = max(1, min(20, math.ceil(0.02 / (flops / 300e12))))
        res["b3"] = r = _in_turns(b3_base, lambda: fa.flash_attention_d512(q, k, v), n)
        b3_base()
        got = fa.flash_attention_d512(q, k, v)
        r["max_abs_diff"] = (got.float() - ob.float()).abs().max().item()
        r["tflops"] = flops / (sum(r["this_ms"]) / 2) / 1e9
        log(f"b3 B{B}xS{S}xH{H}xD512", r)
        del q, k, v, ob, got
        torch.cuda.empty_cache()

    for B, H, W, cin, cout in CONV_SHAPES if "b4" in rows else ():
        x = torch.randn((B, H, W, cin), generator=gen, device="cuda").bfloat16()
        w = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") / math.sqrt(9 * cin)
        wt = conv.tap_major_weights(w)
        bias = 0.1 * torch.randn((cout,), generator=gen, device="cuda")
        sc = 1 + 0.2 * torch.randn((B, cin), generator=gen, device="cuda")
        sh = 0.2 * torch.randn((B, cin), generator=gen, device="cuda")
        resid = torch.randn((B, H, W, cout), generator=gen, device="cuda").bfloat16()
        ob = torch.empty((B, H, W, cout), device="cuda", dtype=torch.bfloat16)
        flops = 2.0 * B * H * W * cout * 9 * cin
        n = max(1, min(20, math.ceil(0.02 / (flops / 300e12))))
        for variant, (affine, silu, has_res) in CONV_VARIANTS.items():
            kw = {"silu": silu, **({"scale": sc, "shift": sh} if affine else {}),
                  **({"residual": resid} if has_res else {})}

            def b4_base():
                call("conv3x3_fwd", x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                     sc.data_ptr() if affine else None, sh.data_ptr() if affine else None,
                     resid.data_ptr() if has_res else None, ob.data_ptr(), B, H, W, cin, cout,
                     int(silu))

            name = f"B{B}x{H}x{W}x{cin}->{cout}:{variant}"
            res["b4"][name] = r = _in_turns(b4_base, lambda: conv.conv3x3(x, w, bias, **kw), n)
            b4_base()
            got = conv.conv3x3(x, w, bias, **kw)
            r["max_abs_diff"] = (got.float() - ob.float()).abs().max().item()
            r["tflops"] = flops / (sum(r["this_ms"]) / 2) / 1e9
            log(f"b4 {name}", r)
        del x, w, wt, resid, ob, got
        torch.cuda.empty_cache()
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, help="root of the other checkout")
    ap.add_argument("--rows", default=",".join(ROWS), help=f"comma-separated subset of {ROWS}")
    ap.add_argument("--out", default="results/bench_attention_fwd.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_attention_fwd: no CUDA device", file=sys.stderr)
        return 2
    from diffuman4d_torch.ops.flash_backward import FWD_LSE_BLOCKS
    from diffuman4d_torch.tune_attention import device_info

    info = device_info()
    print(f"device {info['device']}, power limit {info['power_limit']}", flush=True)
    rows = tuple(r for r in args.rows.split(",") if r)
    if unknown := set(rows) - set(ROWS):
        ap.error(f"unknown rows {sorted(unknown)}")
    res = {**info, "fwd_lse_blocks": list(FWD_LSE_BLOCKS), **run(Path(args.baseline), rows)}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
