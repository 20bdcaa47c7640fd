"""Time this tree's attention and conv kernels against another checkout's,
in turns, on one card.

    python -m diffuman4d_torch.bench_attention_fwd --baseline DIR [--rows bwd,b1] [--out PATH]

``DIR`` is the root of another checkout of the repository (for example an
unpacked ``git archive`` of the parent commit). Each source of this tree's
``cuda_build.ENTRIES`` that the checkout has under ``diffuman4d_torch/csrc``
is compiled with the checkout's own headers and this tree's ``nvcc`` flags
(one ``nvcc`` per source, all started together) and loaded with ctypes; its
C entries take the argument types this tree's entries of the same names
take (:func:`baseline_entries`). A row whose entry the checkout lacks
raises. For each shape the baseline and this tree are timed in the order
baseline, this tree, this tree, baseline (CUDA events around a few launches
after a warm-up, the fastest of 3 windows each), and their outputs are
compared. Rows (``--rows`` picks some; default all):

* ``b1``: B1/B2 (``flash_attn_fwd_skew``) at the blocks the table routes
  each of the two hottest sampling shapes to, else its default;
* ``b8``: B8 and B9 (``flash_attn_single_pass``) at block_q 128, and
  block_b 5 for B9, at the per-frame 16^2 mid block, B32 S256 H20;
* ``b10``: the baseline's B10 at its table's winner against this tree's B10
  at each staging of ``TWO_LEVEL_CONFIGS``, at the two hottest sampling
  shapes: the control for clock differences while both trees have the same
  ``flash_attn_hopper.cu`` and headers;
* ``b5``: B5 (``flash_attn_fwd_lse``) at ``FWD_LSE_BLOCKS``, and this
  tree's B10 stagings at the same shapes, at the train step's four heaviest
  attention shapes;
* ``bwd``: the fused backward (``flash_attn_bwd_fused``, B6 + B7) on the
  same Qs, K, V, dO, L2 and delta, each with its own outputs and scratch,
  at those four shapes and the train step's three lightest, with the
  largest difference of dQ, dK and dV, the card's bound for the work and
  SDPA's backward (dQ, dK and dV in one autograd call) beside them;
* ``b3``: d = 512 attention (``flash_attn_fwd_d512``) at the VAE mid
  block's B2 S16,384 H1;
* ``b4``: the fused conv (``conv3x3_fwd``) at the six
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

from diffuman4d_torch.ops import cuda_build

# (name, B, S, H): the sampling path's two hottest d = 64 shapes and the
# train step's four heaviest, then its three lightest (the backward only)
SAMPLING_SHAPES = [("3d_spatial@64sq", 2, 65536, 10), ("2d@128sq", 32, 16384, 5)]
TRAIN_SHAPES = [("train_3d@64sq", 1, 49152, 10), ("train_2d@128sq", 12, 16384, 5),
                ("train_3d@32sq", 1, 12288, 20), ("train_2d@64sq", 12, 4096, 10)]
BWD_LIGHT_SHAPES = [("train_2d@32sq", 12, 1024, 20), ("train_3d@16sq", 1, 3072, 20),
                    ("train_2d@16sq", 12, 256, 20)]
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
# shape; B8's block_q and B9's (block_q, block_b)
B8_SHAPE = (32, 256, 20)
B8_BLOCKS = ((128, 1), (128, 5))
ROWS = ("b1", "b8", "b10", "b5", "bwd", "b3", "b4")


def baseline_entries(root: Path) -> dict[str, dict[str, list]]:
    """The C entries the tool asks of the checkout at ``root``: for each
    library of this tree's ``cuda_build.ENTRIES`` whose source the checkout
    has, that library's entries with this tree's argument types."""
    csrc = Path(root) / "diffuman4d_torch" / "csrc"
    return {lib: entries for lib, entries in cuda_build.ENTRIES.items()
            if (csrc / f"{lib}.cu").is_file()}


def _build_baseline(root: Path) -> dict:
    """The baseline's C entries by name: each library of
    :func:`baseline_entries`, compiled into ``build/baseline`` (keyed by a
    hash of the source, the checkout's headers and the flags)."""
    csrc = Path(root) / "diffuman4d_torch" / "csrc"
    headers = b"".join(p.read_bytes() for p in sorted(csrc.glob("*.cuh")))
    wanted = baseline_entries(root)
    out_dir = cuda_build.BUILD_DIR / "baseline"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, {}
    for lib in wanted:
        src = csrc / f"{lib}.cu"
        h = hashlib.sha256(src.read_bytes() + headers + " ".join(cuda_build.NVCC_FLAGS).encode())
        libs[lib] = out = out_dir / f"lib{lib}_{h.hexdigest()[:12]}.so"
        if not out.is_file():
            procs[lib] = subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for lib, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"baseline {lib}: nvcc failed:\n{log}")
    entries = {}
    for lib, path in libs.items():
        so = ctypes.CDLL(str(path))
        for fn_name, argtypes in wanted[lib].items():
            fn = getattr(so, fn_name)
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
    import torch.nn.functional as F

    from diffuman4d_torch.ops import attention as attn
    from diffuman4d_torch.ops import conv
    from diffuman4d_torch.ops import flash_attention as fa
    from diffuman4d_torch.ops import flash_backward as fb
    from diffuman4d_torch.utils.tracing import rates

    lib = _build_baseline(baseline)
    stream = torch.cuda.current_stream().cuda_stream

    def call(name, *args):
        if name not in lib:
            raise RuntimeError(f"the baseline at {baseline} has no C entry {name} (it has "
                               f"{sorted(lib)})")
        cuda_build.check(lib[name](*args, stream), f"baseline {name}")

    def ptrs(*xs):
        return [x.data_ptr() for x in xs]

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

    def compare(r: dict, got, want, flops: float) -> None:
        r["max_abs_diff"] = (got.float() - want.float()).abs().max().item()
        r["tflops"] = flops / (sum(r["this_ms"]) / 2) / 1e9

    for name, B, S, H in SAMPLING_SHAPES if {"b1", "b10"} & set(rows) else ():
        q, k, v = inputs(B, S, H)
        flops = 4.0 * B * H * S * S * 64
        n = max(1, min(20, math.ceil(0.02 / (flops / 400e12))))
        ob = torch.empty_like(q)
        if "b1" in rows:
            routed, params = attn.route(q.shape, k.shape)
            blocks = tuple(params.values()) if routed == "flash_d64" else fa.SKEW_DEFAULT

            def b1_base():
                call("flash_attn_fwd_skew", *ptrs(q, k, v, ob), B, H, S, S, *blocks)

            res["b1"][name] = r = _in_turns(
                b1_base, lambda: fa.flash_attention_d64(q, k, v, *blocks), n)
            b1_base()
            r["blocks"] = list(blocks)
            compare(r, fa.flash_attention_d64(q, k, v, *blocks), ob, flops)
            log(f"b1 {name} {blocks}", r)
        if "b10" in rows:
            def b10_base():
                call("flash_attn_fwd_two_level", *ptrs(q, k, v, ob), B, H, S, S,
                     *BASELINE_B10_BLOCKS)

            b10_base()
            want = ob.clone()
            for blocks in fa.TWO_LEVEL_CONFIGS:
                r = _in_turns(b10_base, lambda: fa.flash_attention_two_level(q, k, v, *blocks), n)
                compare(r, fa.flash_attention_two_level(q, k, v, *blocks), want, flops)
                res["b10"].setdefault(name, {})["x".join(map(str, blocks))] = r
                log(f"b10 {name} {blocks}", r)
        del q, k, v, ob
        torch.cuda.empty_cache()

    if "b8" in rows:
        B, S, H = B8_SHAPE
        q, k, v = inputs(B, S, H)
        ob = torch.empty_like(q)
        for bq, bb in B8_BLOCKS:
            def b8_base():
                call("flash_attn_single_pass", *ptrs(q, k, v, ob), B, H, S, S, bq, bb)

            def b8_this():
                if bb == 1:
                    return fa.flash_attention_single_pass(q, k, v, bq)
                return fa.flash_attention_single_pass_batched(q, k, v, bq, bb)

            key = f"B{B}xS{S}xH{H}:{bq}x{bb}"
            res["b8"][key] = r = _in_turns(b8_base, b8_this, 200)
            b8_base()
            compare(r, b8_this(), ob, 4.0 * B * H * S * S * 64)
            log(f"b8 {key}", r)
        del q, k, v, ob
        torch.cuda.empty_cache()

    train = TRAIN_SHAPES + (BWD_LIGHT_SHAPES if "bwd" in rows else [])
    for name, B, S, H in train if {"b5", "bwd"} & set(rows) else ():
        q, k, v = inputs(B, S, H)
        qs = fb.scale_q(q)
        flops = 4.0 * B * H * S * S * 64
        n = max(1, min(20, math.ceil(0.02 / (flops / 400e12))))
        if "b5" in rows and (name, B, S, H) in TRAIN_SHAPES:
            ob = torch.empty_like(q)
            l2b = torch.empty((B, H, S), device="cuda")

            def b5_base():
                call("flash_attn_fwd_lse", *ptrs(qs, k, v, ob, l2b), B, H, S, S)

            r = _in_turns(b5_base, lambda: fb.flash_fwd_lse(qs, k, v), n)
            b5_base()
            out, l2 = fb.flash_fwd_lse(qs, k, v)
            compare(r, out, ob, flops)
            r["l2_max_abs_diff"] = (l2 - l2b).abs().max().item()
            r["stagings_ms"] = {"x".join(map(str, blocks)): _timed_ms(
                lambda: fa.flash_attention_two_level(q, k, v, *blocks), n)
                for blocks in fa.TWO_LEVEL_CONFIGS}
            res["b5"][name] = r
            log(f"b5 {name} {fb.FWD_LSE_BLOCKS}", r)
            print(f"  b10 stagings at {name}: {r['stagings_ms']}", flush=True)
            del ob, l2b, out, l2
        if "bwd" in rows:
            dout = inputs(B, S, H)[0]
            out, l2 = fb.flash_fwd_lse(qs, k, v)
            delta = fb.attention_delta(out, dout)
            grads_b = [torch.empty_like(x) for x in (qs, k, v)]
            dq_accum = torch.empty((B * H, S, 64), device="cuda")
            sems = torch.empty((1 + B * H * -(-S // fb.BWD_BLOCK_Q),), dtype=torch.int32,
                               device="cuda")

            def bwd_base():
                call("flash_attn_bwd_fused", *ptrs(qs, k, v, dout, l2, delta, *grads_b,
                                                   dq_accum, sems), B, H, S, S)

            nb = max(1, math.ceil(n * 2 / 5))  # five products to the forward's two
            r = _in_turns(bwd_base, lambda: fb.flash_bwd(qs, k, v, dout, l2, delta), nb)
            bwd_base()
            got = fb.flash_bwd(qs, k, v, dout, l2, delta)
            r["max_abs_diff"] = max((a.float() - b.float()).abs().max().item()
                                    for a, b in zip(got, grads_b))
            r["rel_diff"] = {nm: ((a.float() - b.float()).abs().max()
                                  / b.float().abs().max()).item()
                             for nm, a, b in zip(("dq", "dk", "dv"), got, grads_b)}
            # the card's bound: five products; qs, dO, dQ and k, v, dK, dV
            # once each, L2 and delta
            bnd = rates(sum(r["this_ms"]) / 2e3, 5 * flops / 2,
                        2.0 * (3 * qs.numel() + 4 * k.numel()) + 8.0 * B * H * S)
            r.update(tflops=bnd["tflops"], bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"])
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            o = F.scaled_dot_product_attention(qt, kt, vt)
            go = dout.transpose(1, 2)
            r["library_ms"] = _timed_ms(
                lambda: torch.autograd.grad(o, (qt, kt, vt), go, retain_graph=True), nb)
            res["bwd"][name] = r
            log(f"bwd {name}", r)
            print(f"  bwd relative differences {r['rel_diff']}, {r['tflops']:.1f} TFLOP/s, "
                  f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), SDPA backward "
                  f"{r['library_ms']:.3f} ms", flush=True)
            del dout, out, l2, delta, grads_b, dq_accum, sems, got, qt, kt, vt, o, go
        del q, k, v, qs
        torch.cuda.empty_cache()

    if "b3" in rows:
        B, S, H = B3_SHAPE
        q, k, v = (torch.randn((B, S, H, 512), generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        ob = torch.empty_like(q)

        def b3_base():
            call("flash_attn_fwd_d512", *ptrs(q, k, v, ob), B, H, S, S)

        flops = 4.0 * B * H * S * S * 512
        n = max(1, min(20, math.ceil(0.02 / (flops / 300e12))))
        res["b3"] = r = _in_turns(b3_base, lambda: fa.flash_attention_d512(q, k, v), n)
        b3_base()
        compare(r, fa.flash_attention_d512(q, k, v), ob, flops)
        log(f"b3 B{B}xS{S}xH{H}xD512", r)
        del q, k, v, ob
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
            compare(r, conv.conv3x3(x, w, bias, **kw), ob, flops)
            log(f"b4 {name}", r)
        del x, w, wt, resid, ob
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
