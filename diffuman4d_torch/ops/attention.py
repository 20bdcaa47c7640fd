"""Attention entry point for the whole port (counterpart of
``diffuman4d_tpu/ops/attention.py``), with its measured dispatch table.

Every attention of the model goes through :func:`dot_product_attention` on
``(batch, seq, heads, head_dim)`` tensors: scale 1/sqrt(head_dim), softmax
in fp32, no mask. ``implementation="auto"`` follows the port's own table,
``ops/attention_table.json``, which ``python -m
diffuman4d_torch.tune_attention`` writes from a sweep of every kernel and
block size at the model's hot shapes on the card: :func:`route` takes the
nearest entry of the head dim and sends the shape to that entry's kernel
if the kernel's gate admits it. The port's kernel names and the JAX
package's impl names they stand for:

=======================  ==============================================
port                     JAX package
=======================  ==============================================
``flash_d64``            ``pallas`` / ``pallas_v3`` / ``pallas_v4`` at d=64
``flash_d512``           ``pallas`` (v1) at d=512
``two_level``            ``pallas_v2`` (B10)
``single_pass``          ``pallas_v5`` (B8)
``single_pass_batched``  ``pallas_v6`` (B9)
=======================  ==============================================

The JAX package also routes to ``xla`` and ``bundled`` (jax's library
kernel) on the accelerator and falls back to them by heuristic; the port
has no such route. With no entry for the head dim, or when the entry's
gate refuses the shape, the shape goes to the port's kernel of the head
dim (``flash_d64``, ``flash_d512``): the documented default route, and the
launch counters show which kernel ran. The kernel wrappers pick the device:
a CPU tensor takes the plain version, a CUDA tensor the kernel. Any other
head dim takes the plain version on the CPU and raises on CUDA.

Two routes of the port have no TPU counterpart: one key (Sk = 1, the
one-token cross-attention of a spatio-temporal UNet) returns V through
:func:`flash_attention.single_key`, and a key row shorter than the skewed
kernel's score chunk at head dim 64 takes the single pass (:func:`route`'s
gate on Sk). The table is keyed by Sq alone.

``implementation="pallas"`` (the JAX package's forced v1) goes to the
kernel of the head dim; ``"math"`` is the plain version; ``"train"`` is
the differentiable path: head dim 64 goes to :func:`flash_attention_train`
(forward with logsumexp plus the fused hand-written backward).
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
from pathlib import Path

import torch

from diffuman4d_torch.ops import flash_attention as fa
from diffuman4d_torch.ops.flash_backward import flash_attention_train
from diffuman4d_torch.utils.tracing import ranged

log = logging.getLogger(__name__)

TABLE_PATH = Path(__file__).resolve().parent / "attention_table.json"
# the CUDA sources of the table's candidates (B1/B2, B3, B8/B9 and B10) and
# the headers they include; the training kernels are not dispatched by it
KERNEL_SOURCES = ("flash_attn_skew_hopper.cu", "flash_attn_d512.cu",
                  "flash_attn_single_hopper.cu", "flash_attn_hopper.cu", "mma_common.cuh",
                  "hopper_common.cuh")
DEFAULT_KERNEL = {64: "flash_d64", 512: "flash_d512"}

_TABLE: list[dict] | None = None


def kernel_source_hash() -> str:
    """Hash of the CUDA sources the table's candidates launch. Each table
    entry is stamped with it at sweep time; a mismatch at load time means
    the measured winner may be stale (a kernel changed and the table was
    not re-swept) and triggers a one-time warning."""
    h = hashlib.sha256()
    for name in KERNEL_SOURCES:
        h.update((fa.cuda_build.CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _dispatch_table() -> list[dict]:
    """The measured per-shape winners of ``attention_table.json``, loaded
    once. Stale per-entry stamps and winners chosen while candidates failed
    warn once, as in the JAX package; an entry naming a kernel the port
    lacks raises."""
    global _TABLE
    if _TABLE is None:
        try:
            data = json.loads(TABLE_PATH.read_text())
            entries = data["entries"]
        except (OSError, KeyError, json.JSONDecodeError):
            _TABLE = []
            return _TABLE
        unknown = sorted({e["impl"] for e in entries} - set(fa.KERNELS))
        if unknown:
            raise ValueError(f"{TABLE_PATH.name}: no port kernel named {unknown} "
                             f"(have {sorted(fa.KERNELS)})")
        cur = kernel_source_hash()
        stale = [e["name"] for e in entries
                 if (e.get("kernel_hash") or data.get("kernel_hash")) not in (None, cur)]
        if stale:
            log.warning(
                "attention_table.json entries swept against different kernel sources "
                "(stale vs current %s): %s — block sizes may be stale; re-run "
                "python -m diffuman4d_torch.tune_attention (or --verify to check the hot "
                "entries quickly)", cur, ", ".join(stale))
        incomplete = [e["name"] for e in entries if e.get("candidates_failed")]
        if incomplete:
            log.warning("attention_table.json winners chosen with failed candidates "
                        "outstanding (sweep incomplete): %s", ", ".join(incomplete))
        _TABLE = entries
    return _TABLE


def _table_lookup(s: int, d: int, bh: int):
    """Nearest measured entry with matching head dim: log-distance over
    sequence length, plus a weaker term over total rows (batch*heads), as
    in the JAX package."""
    best, best_dist = None, None
    for e in _dispatch_table():
        if e["d"] != d:
            continue
        dist = abs(math.log(e["s"] / s)) + 0.3 * abs(math.log(e["b"] * e["h"] / bh))
        if best_dist is None or dist < best_dist:
            best, best_dist = e, dist
    return best


def route(q_shape, k_shape) -> tuple[str, dict]:
    """The kernel (a key of ``flash_attention.KERNELS``, or
    ``"single_key"``) and block sizes that ``implementation="auto"`` uses
    for these shapes at head dim 64 or 512. Pure: it reads the table and
    nothing of the tensors.

    One key (Sk = 1) takes :func:`flash_attention.single_key`, the same
    function bit for bit. The table is keyed by Sq; the gate on Sk keeps a
    shape off a kernel whose key tiles it does not fill: the skewed and
    two-level kernels take Sk >= their ``block_k`` (the default route's
    too), and a shorter key row at head dim 64 goes to the single pass."""
    b, s, h, d = q_shape
    sk = k_shape[1]
    if d not in DEFAULT_KERNEL:
        raise ValueError(f"no attention kernel for head dim {d} (have 64 and 512)")
    if sk == 1:
        return "single_key", {}
    e = _table_lookup(s, d, b * h)
    if e is not None:
        impl, bq = e["impl"], e.get("block_q")
        if impl == "single_pass" and fa.single_pass_ok(sk, bq, d):
            return impl, {"block_q": bq}
        if impl == "single_pass_batched":
            bb = e["block_b"]
            if (b * h) % bb == 0 and fa.single_pass_ok(sk, bq, d, bb):
                return impl, {"block_q": bq, "block_b": bb}
        if impl in ("two_level", "flash_d64"):
            blocks = (bq, e.get("block_k_major"), e["block_k"])
            built = fa.two_level_ok if impl == "two_level" else fa.skew_ok
            if built(d, *blocks) and sk >= e["block_k"]:
                return impl, dict(zip(fa.BLOCK_PARAMS[impl], blocks))
    if d == 64 and sk < fa.SKEW_DEFAULT[2]:
        return "single_pass", {"block_q": fa.SINGLE_PASS_BLOCK_Q[0 if s <= 64 else 1]}
    return DEFAULT_KERNEL[d], {}


@ranged("op/attention")  # a profiler range, while one records
def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, implementation: str = "auto"
) -> torch.Tensor:
    """Multi-head attention, (B, S, H, D) -> (B, S, H, D).

    implementation:
      * "auto" -- the kernel :func:`route` picks from the table (plain on
        the CPU, any other head dim plain on the CPU and an error on CUDA)
      * "pallas" -- the kernel of the head dim (d=64 or d=512)
      * "math" -- the plain version (the JAX package's ``_xla_attention``)
      * "train" -- differentiable: at d=64 the forward-with-logsumexp and
        backward kernels on CUDA, their plain version on the CPU; any other
        head dim is autograd through the plain version on the CPU and
        raises on CUDA
    """
    if implementation == "math":
        return fa.attention_plain(q, k, v)
    if implementation == "train":
        if q.shape[-1] == 64:
            return flash_attention_train(q, k, v)
        if q.device.type == "cpu":
            return fa.attention_plain(q, k, v)
        raise ValueError(f"no differentiable CUDA attention kernel for head dim "
                         f"{q.shape[-1]} (have 64)")
    if implementation not in ("auto", "pallas"):
        raise ValueError(f"Unknown attention implementation: {implementation}")
    d = q.shape[-1]
    if d not in DEFAULT_KERNEL:
        if q.device.type == "cpu":
            return fa.attention_plain(q, k, v)
        raise ValueError(f"no CUDA attention kernel for head dim {d} (have 64 and 512)")
    if implementation == "pallas":
        return fa.KERNELS[DEFAULT_KERNEL[d]](q, k, v)
    name, params = route(q.shape, k.shape)
    if name == "single_key":
        return fa.single_key(q, k, v)
    return fa.KERNELS[name](q, k, v, **params)
