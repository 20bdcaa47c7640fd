"""The shared frame of the port's per-unit measurement tools
(``profile_units``, ``profile_unet_units``, ``profile_vae``,
``profile_vae_conv``, ``profile_window``, ``attn_ceiling``,
``bench_flash_backward``): their command line, the refusal without a card,
seeded random inputs, one record per timed unit and the small modules they
time beside the model's own.

Every tool runs on the card unless given ``--device cpu``; there (with
``--arch tiny``, the tests' way in) its units run in fp32 through the plain
versions and are timed by the host clock, and its JSON names the device as
``cpu``. Without a card and without ``--device cpu`` a tool exits 2. On the
card each unit is timed by :func:`diffuman4d_torch.utils.tracing.timed` and
its rates are taken against the H100 SXM peaks (989 TFLOP/s dense bf16,
3.35 TB/s)."""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
from torch import nn

from diffuman4d_torch.models.layers import GroupNorm, conv_nhwc
from diffuman4d_torch.ops.conv import conv3x3, conv3x3_ok
from diffuman4d_torch.utils.tracing import card, rates, timed


def tool_parser(doc: str, iters: int = 10, out: str | None = None) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arch", default="full", choices=("full", "tiny"),
                    help="tiny: the smoke-test shapes (with --device cpu)")
    ap.add_argument("--iters", type=int, default=iters, help="calls per timed window")
    ap.add_argument("--windows", type=int, default=3, help="timed windows, the fastest kept")
    ap.add_argument("--out", default=out, help="where to write the JSON")
    return ap


def refuse_without_card(device: str, tool: str) -> bool:
    """True (after a message) when the card was asked for and there is none."""
    if device == "cuda" and not torch.cuda.is_available():
        print(f"{tool}: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return True
    return False


class Units:
    """Seeded inputs on the tool's device and one record per timed unit:
    its shape, FLOP and byte counts, ms and rates."""

    def __init__(self, args):
        self.args = args
        self.device = torch.device(args.device)
        self.dtype = torch.bfloat16 if args.device == "cuda" else torch.float32
        self.gen = torch.Generator(device=self.device).manual_seed(0)
        self.results: dict = {}

    def randn(self, *shape, scale: float = 1.0, dtype=None) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, device=self.device)
        return (x * scale).to(dtype or self.dtype)

    def module(self, mod: nn.Module) -> nn.Module:
        return mod.to(self.device, self.dtype).eval()

    @torch.no_grad()
    def time(self, fn, n: int | None = None) -> float:
        return timed(fn, n or self.args.iters, windows=self.args.windows)

    def record(self, name: str, seconds: float, flops: float = 0.0, nbytes: float = 0.0,
               **extra) -> dict:
        row = {**rates(seconds, flops, nbytes), "flop": flops, "bytes": nbytes, **extra}
        if self.args.device == "cpu":  # a host time is no share of the card's bound
            row.pop("pct_of_bound", None)
        self.results[name] = row
        return row

    def header(self) -> dict:
        return {"card": card(), "device": self.args.device, "arch": self.args.arch,
                "iters": self.args.iters, "windows": self.args.windows}

    def write(self, payload: dict) -> None:
        if self.args.out:
            os.makedirs(os.path.dirname(os.path.abspath(self.args.out)), exist_ok=True)
            with open(self.args.out, "w") as f:
                json.dump(payload, f, indent=2)
            print("wrote", self.args.out, flush=True)


def fmt(row: dict) -> str:
    """A record's time and rates on one line."""
    parts = [f"{row['ms']:9.3f} ms"]
    if "tflops" in row:
        parts.append(f"{row['tflops']:7.1f} TF/s")
    if "gbps" in row:
        parts.append(f"{row['gbps']:7.0f} GB/s")
    if "pct_of_bound" in row:
        parts.append(f"{row['pct_of_bound']:5.1f}% of bound")
    if row.get("library_ms") is not None:
        parts.append(f"library {row['library_ms']:.3f} ms")
    return "  ".join(parts)


class Conv3x3(nn.Conv2d):
    """A 3x3 SAME conv on NHWC, routed as the model routes its convs: the
    fused kernel (B4, ``ops/conv.py``) where ``conv3x3_ok`` admits the
    shape, else the library conv through ``conv_nhwc``."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if conv3x3_ok(x.shape, self.out_channels):
            return conv3x3(x, self.weight, self.bias)
        return conv_nhwc(self, x)

    def library(self, x: torch.Tensor) -> torch.Tensor:
        """The library reference: one bf16 ``F.conv2d`` (cuDNN on the card)."""
        return conv_nhwc(self, x)


class GroupNormSiLU(nn.Module):
    """GroupNorm (fp32 statistics) then SiLU, as the model runs it
    (``GroupNorm(x, silu=True)``: the kernel pair on the card)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm = GroupNorm(channels, groups, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x, silu=True)


def conv_flops(b: int, h: int, w: int, cin: int, cout: int) -> float:
    return 2 * 9 * cin * cout * b * h * w


def attention_flops(b: int, s: int, h: int, d: int) -> float:
    return 4.0 * b * h * s * s * d
