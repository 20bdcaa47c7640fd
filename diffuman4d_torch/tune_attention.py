"""Sweep the port's attention kernels and block sizes at the model's hot
shapes on the card and write the winners to
``diffuman4d_torch/ops/attention_table.json``, the measured dispatch table
that ``ops/attention.py`` follows (counterpart of the JAX package's
``scripts/tune_attention.py``).

    python -m diffuman4d_torch.tune_attention [--quick] [--shapes S,..]
        [--candidates C,..] [--out PATH]
    python -m diffuman4d_torch.tune_attention --verify [--out PATH]

``--shapes`` and ``--candidates`` take comma-separated substrings of the
names in :data:`HOT_SHAPES` and of the candidate names; the table is merged
per shape, so a partial sweep keeps the other entries (each with its own
kernel-source stamp). ``--verify`` re-measures the two highest-TFLOP/s
entries of the existing table and exits 1 if one lost more than 10%.

Candidates per shape: at d = 512 the port's kernel of the head dim
(``flash_d512``); at d = 64 the skewed-pipeline kernel (``flash_d64``, B1/B2)
and the two-level kernel (B10) at each built staging, the single-pass
kernel (B8) at each ``block_q`` that ``single_pass_ok`` admits and its
batched form (B9) at each admitted (``block_q``, ``block_b``) with
``block_b`` < b*h. There is no plain and no library candidate; PyTorch's
``scaled_dot_product_attention`` is timed per shape as a yardstick column
of the printed results only. Each candidate is timed with CUDA events
around n launches after a warm-up, the minimum of 3 windows; a reading
above the card's bf16 peak is rejected. Without a CUDA device the entry
point exits 2.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

# the shared kernel timer: CUDA events around n calls after a warm-up, the
# fastest of 3 windows
from diffuman4d_torch.utils.tracing import PEAK_BF16_FLOPS, card, timed

# (name, b, s, h, d): the model's attention shapes. 3D attention = the
# CFG-doubled window regrouped to (2, T*hw); per-frame 2D attention at
# B = 2T; the VAE decoder mid block at d = 512; the JAX package's list plus
# the per-frame 16^2 mid-block attention that the demo_3d slice launches
HOT_SHAPES = [
    ("3d_spatial@64sq", 2, 65536, 10, 64),
    ("3d_temporal@64sq", 2, 98304, 10, 64),
    ("3d_spatial@32sq", 2, 16384, 20, 64),
    ("3d_temporal@32sq", 2, 24576, 20, 64),
    ("3d@16sq_mid", 2, 4096, 20, 64),
    ("2d@128sq", 32, 16384, 5, 64),
    ("2d@128sq_tem", 48, 16384, 5, 64),
    ("2d@64sq", 32, 4096, 10, 64),
    ("2d@32sq", 32, 1024, 20, 64),
    ("2d@16sq_mid", 32, 256, 20, 64),
    ("vae_mid@128sq", 2, 16384, 1, 512),
    # SVD-xt's temporal self-attention: 25 frames at each pixel of a level,
    # fused CFG (b = 2 x pixels); B * H above gridDim.y's 65,535 at 96^2
    ("svd_tem@96sq", 18432, 25, 5, 64),
    ("svd_tem@48sq", 4608, 25, 10, 64),
    ("svd_tem@24sq", 1152, 25, 20, 64),
    ("svd_tem@12sq", 288, 25, 20, 64),
]
BATCHED_BLOCK_B = (2, 4, 5, 8)
DEFAULT_OUT = Path(__file__).resolve().parent / "ops" / "attention_table.json"


def candidates(b: int, s: int, h: int, d: int) -> dict[str, tuple[str, dict]]:
    """Candidate name -> (port kernel, block sizes) at self-attention shape
    (b, s, h, d). The skewed and two-level kernels are candidates where the
    keys fill their ``block_k`` (the gate of ``ops/attention.route``)."""
    from diffuman4d_torch.ops import flash_attention as fa

    out = {"flash_d512": ("flash_d512", {})} if d == 512 else {}
    for bq, kmaj, kin in fa.SKEW_CONFIGS:
        if fa.skew_ok(d, bq, kmaj, kin) and s >= kin:
            out[f"flash_d64_{bq}x{kmaj}x{kin}"] = (
                "flash_d64", {"block_q": bq, "block_k_major": kmaj, "block_k": kin})
    for bq, kmaj, kin in fa.TWO_LEVEL_CONFIGS:
        if fa.two_level_ok(d, bq, kmaj, kin) and s >= kin:
            out[f"two_level_{bq}x{kmaj}x{kin}"] = (
                "two_level", {"block_q": bq, "block_k_major": kmaj, "block_k": kin})
    for bq in fa.SINGLE_PASS_BLOCK_Q:
        if fa.single_pass_ok(s, bq, d):
            out[f"single_pass_{bq}"] = ("single_pass", {"block_q": bq})
    for bq in fa.SINGLE_PASS_BLOCK_Q:
        for bb in BATCHED_BLOCK_B:
            if (b * h) % bb == 0 and bb < b * h and fa.single_pass_ok(s, bq, d, bb):
                out[f"single_pass_batched_{bq}b{bb}"] = (
                    "single_pass_batched", {"block_q": bq, "block_b": bb})
    return out


def _calls_per_window(flops: float) -> int:
    """Launches per timed window: ~20 ms of work at ~200 TFLOP/s, 1 to 50."""
    return max(1, min(50, math.ceil(0.02 / (flops / 200e12))))


def _inputs(b: int, s: int, h: int, d: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    return tuple(torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
                 for _ in range(3))


def device_info() -> dict:
    """The card's name (``torch.cuda.get_device_name``) and power limit."""
    import torch

    return {"device": torch.cuda.get_device_name(), "power_limit": card()["power_limit"]}


def _write_table(out: str, new_entries: list, device: dict, kernel_source_hash) -> None:
    """Write ``new_entries`` merged per shape name over the table at
    ``out``; carried-over entries keep the hash they were measured under
    (backfilled from the old table-level stamp if absent), so a partial
    re-sweep cannot mark stale entries fresh."""
    merged = {e["name"]: e for e in new_entries}
    try:
        with open(out) as f:
            old = json.load(f)
        for e in old.get("entries", []):
            if "kernel_hash" not in e and old.get("kernel_hash"):
                e["kernel_hash"] = old["kernel_hash"]
            merged.setdefault(e["name"], e)
    except (OSError, json.JSONDecodeError):
        pass
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump({**device, "kernel_hash": kernel_source_hash(),
                   "entries": list(merged.values())}, f, indent=2)
        f.write("\n")
    os.replace(tmp, out)


def sweep(shapes: list, keys: list[str] | None, out: str) -> dict:
    """Time every candidate (filtered by ``keys``) at each shape, write the
    winners to ``out`` after each shape, and return the per-shape results."""
    import torch
    import torch.nn.functional as F

    from diffuman4d_torch.ops import flash_attention as fa
    from diffuman4d_torch.ops.attention import kernel_source_hash

    device = device_info()
    print(f"device {device['device']}, power limit {device['power_limit']}", flush=True)
    results, table = {}, []
    for name, b, s, h, d in shapes:
        q, k, v = _inputs(b, s, h, d)
        flops = 4.0 * b * h * s * s * d
        n = _calls_per_window(flops)
        row, best, failed = {}, None, 0
        cands = candidates(b, s, h, d)
        if keys:
            cands = {c: x for c, x in cands.items() if any(key in c for key in keys)}
        for cname, (impl, params) in cands.items():
            fn = fa.KERNELS[impl]
            try:
                dt = timed(lambda: fn(q, k, v, **params), n)
                tf = flops / dt / 1e12
                if tf > PEAK_BF16_FLOPS / 1e12:
                    raise RuntimeError(f"measurement collapsed ({tf:.0f} TFLOP/s > the card's "
                                       "bf16 peak)")
                row[cname] = {"ms": round(dt * 1e3, 4), "tflops": round(tf, 1)}
                if best is None or tf > best[0]:
                    best = (tf, impl, params)
            except Exception as e:  # noqa: BLE001 -- recorded, counted, the sweep goes on
                row[cname] = {"error": f"{type(e).__name__}: {e}"[:160]}
                failed += 1
            print(name, cname, row[cname], flush=True)
        # the library's attention as a yardstick: never a candidate
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        try:
            dt = timed(lambda: F.scaled_dot_product_attention(qt, kt, vt), n)
            row["sdpa (yardstick)"] = {"ms": round(dt * 1e3, 4),
                                       "tflops": round(flops / dt / 1e12, 1)}
        except RuntimeError as e:
            row["sdpa (yardstick)"] = {"error": str(e)[:160]}
        print(name, "sdpa (yardstick)", row["sdpa (yardstick)"], flush=True)
        results[name] = row
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
        if best is not None:
            tf, impl, params = best
            entry = {"name": name, "b": b, "s": s, "h": h, "d": d, "impl": impl,
                     "block_q": params.get("block_q", 64),
                     "block_k": params.get("block_k", s if impl.startswith("single") else 64),
                     **{p: params[p] for p in ("block_k_major", "block_b") if p in params},
                     "tflops": round(tf, 1), "kernel_hash": kernel_source_hash(),
                     "candidates_failed": failed, "timing_method": "cuda_events_min3"}
            table.append(entry)
        # written after every shape: a sweep cut short keeps what it measured
        _write_table(out, table, device, kernel_source_hash)
    return results


def verify(table_path: str) -> int:
    """Re-measure the two highest-TFLOP/s entries of the table at ``table_path``
    and report drift against the stamped numbers; 1 if one lost > 10%."""
    from diffuman4d_torch.ops import flash_attention as fa
    from diffuman4d_torch.ops.attention import kernel_source_hash

    with open(table_path) as f:
        data = json.load(f)
    cur = kernel_source_hash()
    if data.get("kernel_hash") != cur:
        print(f"NOTE: table stamped {data.get('kernel_hash')} != current kernel sources {cur} "
              "— measuring drift")
    entries = sorted(data["entries"], key=lambda e: -e.get("tflops", 0))[:2]
    rc = 0
    for e in entries:
        if e.get("candidates_failed"):
            print(f"NOTE: {e['name']} winner was chosen with {e['candidates_failed']} failed "
                  "candidates outstanding (sweep incomplete)")
        q, k, v = _inputs(e["b"], e["s"], e["h"], e["d"])
        params = {p: e[p] for p in fa.BLOCK_PARAMS[e["impl"]]}
        flops = 4.0 * e["b"] * e["h"] * e["s"] ** 2 * e["d"]
        fn = fa.KERNELS[e["impl"]]
        dt = timed(lambda: fn(q, k, v, **params), _calls_per_window(flops))
        tf = flops / dt / 1e12
        drift = tf / e["tflops"] - 1.0
        status = "OK" if drift > -0.10 else "REGRESSED"
        rc |= status != "OK"
        print(f"{e['name']}: stamped {e['tflops']} TFLOP/s, measured {tf:.1f} ({drift:+.1%}) "
              f"[{status}]")
    return int(rc)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="the first two hot shapes only")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--candidates", default=None,
                    help="comma-separated substrings; measure only matching candidates")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated substrings; sweep only matching HOT_SHAPES")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("tune_attention: no CUDA device; the sweep times the port's kernels on the card",
              file=sys.stderr)
        return 2
    out = os.path.abspath(args.out)
    if args.verify:
        return verify(out)
    shapes = HOT_SHAPES[:2] if args.quick else HOT_SHAPES
    if args.shapes:
        keys = [x.strip() for x in args.shapes.split(",") if x.strip()]
        shapes = [sh for sh in shapes if any(x in sh[0] for x in keys)]
        if not shapes:
            ap.error(f"--shapes {args.shapes!r} matched no HOT_SHAPES "
                     f"(available: {', '.join(sh[0] for sh in HOT_SHAPES)})")
    keys = [x.strip() for x in args.candidates.split(",") if x.strip()] if args.candidates else None
    results = sweep(shapes, keys, out)
    print(json.dumps(results, indent=1))
    with open(out) as f:
        n_merged = len(json.load(f)["entries"])
    print(f"measured {len(shapes)} shapes this run; the dispatch table now holds {n_merged} "
          f"entries at {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
