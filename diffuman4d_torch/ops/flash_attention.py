"""Flash attention on Hopper, with its plain PyTorch version beside it.

Counterpart of ``diffuman4d_tpu/ops/flash_attention.py``. Five wrappers
launch the kernels of ``csrc/flash_attn_skew_hopper.cu``,
``csrc/flash_attn_d512.cu``, ``csrc/flash_attn_single_hopper.cu`` and
``csrc/flash_attn_hopper.cu``, all TMA / wgmma kernels:

* :func:`flash_attention_d64` replaces ``flash_attention_v4`` (the UNet's
  3D window attention) and ``flash_attention_v3`` (its per-frame
  attention); both compute the same function at head dim 64. Their skewed
  score pipeline: ``block_q`` query rows per block (64 per consumer
  warpgroup), K/V tiles of ``block_k_major`` keys per TMA stage, two
  score buffers of ``block_k`` keys, the next chunk's ``Q K^T`` running
  under this chunk's softmax.
* :func:`flash_attention_d512` replaces ``flash_attention`` (v1), the VAE
  mid-block attention at head dim 512.
* :func:`flash_attention_single_pass` replaces ``flash_attention_v5``: each
  (batch, head) row's K and V loaded once for all its query tiles, one
  pass of ``block_q`` (64 or 128) query rows at a time, no online softmax
  up to 256 keys (one rescale per further 256 keys, Sk <= 4,096).
* :func:`flash_attention_single_pass_batched` replaces
  ``flash_attention_v6``: the same with ``block_b`` (batch * head) rows per
  thread block, walked in turn, the next row's loads under this row's work
  (in the JAX package ``block_b`` rows are one program's block).
* :func:`flash_attention_two_level` replaces ``flash_attention_v2``:
  ``block_q`` query rows per block (64 per consumer warpgroup), K/V tiles
  of ``block_k_major`` keys per TMA stage, ``Q K^T`` in chunks of
  ``block_k``.

Semantics (all five): O = softmax(Q K^T / sqrt(d)) V per (batch, head) on
``(B, S, H, D)``, non-causal, unmasked, the exact scale applied to fp32
scores, fp32 max / normaliser, P rounded to the input dtype for the PV
product, fp32 accumulation: the function of :func:`attention_plain`. (The
TPU v3-v6 kernels fold a bf16-rounded scale into Q instead; see
``ROADMAP.md`` section C.) Each wrapper checks the shapes and block sizes
its kernel was built for and raises on others, on any device. Then a CPU
tensor takes :func:`attention_plain`; a CUDA tensor launches the kernel or
raises. Each wrapper counts its launches in ``.launches`` and, per
``(B, Sq, Sk, H)`` plus its block sizes, in the counter ``.shapes``.
"""

from __future__ import annotations

from collections import Counter

import torch

from diffuman4d_torch.ops import cuda_build

# single pass (B8/B9): query rows per pass (one or two consumer warpgroups
# of 64); the kernel takes keys in chunks of 256 (128 when Sk <= 128) and
# keeps the row's chunks in a ring of shared-memory slots, so its
# registers (128 fp32 scores per thread) and shared memory (a fixed layout
# of at most 230,504 bytes per instance) do not grow with Sk; Sk <= 4,096,
# the reference's largest single-pass candidate
SINGLE_PASS_BLOCK_Q = (64, 128)
SINGLE_PASS_MAX_SK = 4096
# skewed pipeline (B1/B2) and two-level (B10): the (block_q, block_k_major,
# block_k) built in csrc/flash_attn_skew_hopper.cu and csrc/flash_attn_hopper.cu
SKEW_CONFIGS = ((64, 128, 64), (128, 128, 64), (128, 256, 64), (128, 256, 128),
                (192, 128, 64), (192, 256, 64))
SKEW_DEFAULT = (192, 256, 64)
TWO_LEVEL_CONFIGS = ((64, 128, 64), (64, 256, 64), (64, 256, 128),
                     (128, 128, 64), (128, 256, 64), (128, 256, 128),
                     (192, 128, 64), (192, 256, 64))


def single_pass_ok(sk: int, block_q: int, d: int = 64, block_b: int = 1) -> bool:
    """Whether the single-pass kernel (B8, and B9 with ``block_b`` > 1) was
    built for this launch: head dim 64, 1 <= Sk <= 4,096 keys, ``block_q``
    one of :data:`SINGLE_PASS_BLOCK_Q`, ``block_b`` >= 1. Its registers and
    shared memory are fixed per ``block_q`` whatever Sk is (scores in
    chunks of 256 keys, K/V through a ring of chunk slots), so these are
    all its limits. The dispatcher and the tuner both ask it, so a
    nearest-match table lookup never routes a shape to a launch that fails
    (the role of the JAX package's ``v5_vmem_ok``)."""
    return (d == 64 and 1 <= sk <= SINGLE_PASS_MAX_SK and block_q in SINGLE_PASS_BLOCK_Q
            and block_b >= 1)


def skew_ok(d: int, block_q: int, block_k_major: int, block_k: int) -> bool:
    """Whether the skewed-pipeline kernel (B1/B2) was built for these block
    sizes (head dim 64, any Sq and Sk: ragged edges are masked)."""
    return d == 64 and (block_q, block_k_major, block_k) in SKEW_CONFIGS


def two_level_ok(d: int, block_q: int, block_k_major: int, block_k: int) -> bool:
    """Whether the two-level kernel (B10) was built for these block sizes
    (head dim 64, any Sq and Sk: ragged edges are masked)."""
    return d == 64 and (block_q, block_k_major, block_k) in TWO_LEVEL_CONFIGS


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention with fp32 scores and softmax (the JAX package's
    ``_xla_attention``): P is cast to the input dtype for the PV product."""
    dtype = q.dtype
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(dtype)


def _check_shapes(q, k, v, head_dim: int) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4 or x.shape[-1] != head_dim:
            raise ValueError(f"flash attention: {name} shape {tuple(x.shape)} is not "
                             f"(B, S, H, {head_dim})")
    B, _, H, _ = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != H:
        raise ValueError(f"flash attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")


def _launch(wrapper, q, k, v, fn_name: str, c_args: tuple, blocks: tuple = (),
            lib: str = "flash_attn_skew_hopper"):
    """Launch C entry ``fn_name`` of library ``lib`` on (q, k, v, out, B, H,
    Sq, Sk, *c_args, stream) and count it under ``(B, Sq, Sk, H, *blocks)``."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.dtype != torch.bfloat16:
            raise ValueError(f"flash attention: {name} must be a bf16 CUDA tensor, got "
                             f"{x.dtype} on {x.device}")
    B, Sq, H, D = q.shape
    if B * H > 65535:
        raise ValueError(f"flash attention: B*H = {B * H} exceeds the grid limit")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    for x in (q, k, v, out):
        if x.data_ptr() % 16:
            raise ValueError("flash attention: tensors must be 16-byte aligned")
    fn = cuda_build.entry(lib, fn_name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Sq, k.shape[1],
                *c_args, stream)
    cuda_build.check(rc, fn_name)
    cuda_build.count_launch(wrapper, (B, Sq, k.shape[1], H, *blocks))
    return out


def flash_attention_d64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_q: int = SKEW_DEFAULT[0], block_k_major: int = SKEW_DEFAULT[1],
                        block_k: int = SKEW_DEFAULT[2]) -> torch.Tensor:
    """Head dim 64 (TPU kernels B1 ``_flash_kernel_v4`` and B2
    ``_flash_kernel_v3``): the skewed score pipeline, ``block_q`` query rows
    per block, K/V tiles of ``block_k_major`` keys, two score buffers of
    ``block_k`` keys. Raises for block sizes not in :data:`SKEW_CONFIGS`;
    any Sq and Sk. bf16 CUDA tensors launch the kernel."""
    _check_shapes(q, k, v, 64)
    if not skew_ok(64, block_q, block_k_major, block_k):
        raise ValueError(f"skewed attention: not built for blocks ({block_q}, "
                         f"{block_k_major}, {block_k}); have {SKEW_CONFIGS}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    blocks = (block_q, block_k_major, block_k)
    return _launch(flash_attention_d64, q, k, v, "flash_attn_fwd_skew", blocks, blocks,
                   lib="flash_attn_skew_hopper")


def flash_attention_d512(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Head dim 512 (TPU kernel B3 ``_flash_kernel``, the VAE mid-block
    attention). bf16 CUDA tensors launch the kernel."""
    _check_shapes(q, k, v, 512)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _launch(flash_attention_d512, q, k, v, "flash_attn_fwd_d512", (),
                   lib="flash_attn_d512")


def flash_attention_single_pass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                block_q: int = 128) -> torch.Tensor:
    """Single pass at head dim 64 (TPU kernel B8 ``_flash_kernel_v5``): one
    (batch, head) row per block, its K and V loaded once for all its
    passes of ``block_q`` query rows. Raises where :func:`single_pass_ok`
    refuses the launch."""
    _check_shapes(q, k, v, 64)
    if not single_pass_ok(k.shape[1], block_q):
        raise ValueError(f"single-pass attention: not built for Sk={k.shape[1]}, "
                         f"block_q={block_q} (1 <= Sk <= {SINGLE_PASS_MAX_SK}, block_q in "
                         f"{SINGLE_PASS_BLOCK_Q})")
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _launch(flash_attention_single_pass, q, k, v, "flash_attn_single_pass",
                   (block_q, 1), (block_q,), lib="flash_attn_single_hopper")


def flash_attention_single_pass_batched(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                        block_q: int = 128, block_b: int = 2) -> torch.Tensor:
    """The single pass over ``block_b`` (batch * head) rows per block, each
    row's loads under the previous row's work (TPU kernel B9
    ``_flash_kernel_v6``). ``block_b`` must divide B * H."""
    _check_shapes(q, k, v, 64)
    bh = q.shape[0] * q.shape[2]
    if bh % block_b:
        raise ValueError(f"single-pass attention: b*h = {bh} not divisible by block_b "
                         f"{block_b}")
    if not single_pass_ok(k.shape[1], block_q, 64, block_b):
        raise ValueError(f"single-pass attention: not built for Sk={k.shape[1]}, "
                         f"block_q={block_q}, block_b={block_b}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _launch(flash_attention_single_pass_batched, q, k, v, "flash_attn_single_pass",
                   (block_q, block_b), (block_q, block_b), lib="flash_attn_single_hopper")


def flash_attention_two_level(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              block_q: int = 64, block_k_major: int = 256,
                              block_k: int = 64) -> torch.Tensor:
    """Two-level KV blocking at head dim 64 (TPU kernel B10
    ``_flash_kernel_v2``): ``block_q`` query rows per block, K/V tiles of
    ``block_k_major`` keys per TMA stage, ``Q K^T`` chunks of ``block_k``.
    Raises for block sizes not in :data:`TWO_LEVEL_CONFIGS`; any Sq and Sk."""
    _check_shapes(q, k, v, 64)
    if not two_level_ok(64, block_q, block_k_major, block_k):
        raise ValueError(f"two-level attention: not built for blocks ({block_q}, "
                         f"{block_k_major}, {block_k}); have {TWO_LEVEL_CONFIGS}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    blocks = (block_q, block_k_major, block_k)
    return _launch(flash_attention_two_level, q, k, v, "flash_attn_fwd_two_level", blocks, blocks,
                   lib="flash_attn_hopper")


# the port's attention kernels by their dispatch names, and the block-size
# arguments of each (the order of the block sizes in its ``.shapes`` keys)
KERNELS = {
    "flash_d64": flash_attention_d64,
    "flash_d512": flash_attention_d512,
    "single_pass": flash_attention_single_pass,
    "single_pass_batched": flash_attention_single_pass_batched,
    "two_level": flash_attention_two_level,
}
BLOCK_PARAMS = {"flash_d64": ("block_q", "block_k_major", "block_k"), "flash_d512": (),
                "single_pass": ("block_q",),
                "single_pass_batched": ("block_q", "block_b"),
                "two_level": ("block_q", "block_k_major", "block_k")}
# each wrapper counts its launches, in total and per (B, Sq, Sk, H, *blocks)
for _wrapper in KERNELS.values():
    _wrapper.launches = 0
    _wrapper.shapes = Counter()
