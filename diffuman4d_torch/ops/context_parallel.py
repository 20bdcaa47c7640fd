"""Context (sequence) parallelism for the 3D attention (counterpart of
``diffuman4d_tpu/ops/context_parallel.py``).

The UNet's long axis is the window's joint (frames * hw) token sequence, up
to 98,304 tokens of a temporal window. Under context parallelism each rank
of the mesh's ``model`` axis holds a contiguous slice of the window's
frames: its queries stay local and K/V are all-gathered (at 98k tokens
about heads * 64 * 2 B * S = 126 MB, where the S x S scores would be 38 GB
and never exist in the flash kernels). Each rank then runs the port's own
attention (``ops/attention.py`` ``dot_product_attention``, its kernels on
the card through ``route``) on its Sq queries against the gathered Sk keys.
The result is exact, not windowed.

Where the JAX package runs these under ``shard_map`` with the ``model`` axis
name, the port passes the rank mesh (``parallel/mesh.py``).
:func:`cp_attention_grouped`, the UNet's, counts its K/V all-gathers in
``.all_gathers``, as the kernel wrappers count their launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from diffuman4d_torch.ops.attention import dot_product_attention


@dataclass(frozen=True)
class ContextParallel:
    """A 3D attention's context-parallel setting: the mesh, the axis its
    frames are split over and the number of independent sequences (CFG
    halves) in the whole batch."""

    mesh: object
    axis: str = "model"
    groups: int = 1

    def attend(self, q, k, v, implementation: str = "auto") -> torch.Tensor:
        return cp_attention_grouped(q, k, v, self.mesh, self.axis, self.groups,
                                    implementation=implementation)


def cp_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                             axis: str = "model", implementation: str = "auto") -> torch.Tensor:
    """All-gather K/V (B, S_local, H, D) over ``axis`` and attend this
    rank's query shard."""
    k_full = mesh.all_gather(k, axis, dim=1)
    v_full = mesh.all_gather(v, axis, dim=1)
    return dot_product_attention(q, k_full, v_full, implementation=implementation)


def cp_attention_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                         axis: str = "model", groups: int = 1,
                         implementation: str = "auto") -> torch.Tensor:
    """Context-parallel attention for the UNet's 3D attention with the
    window's frame axis split over ``axis``.

    The whole batch is ``groups`` independent sequences laid out b-major
    (the CFG negative and positive halves) and each rank holds contiguous
    frames of exactly one group. K/V are all-gathered over the axis and
    cut to this rank's group (group = index // (n // groups)), so CFG
    halves never attend across each other."""
    k_full = mesh.all_gather(k, axis, dim=1)
    v_full = mesh.all_gather(v, axis, dim=1)
    cp_attention_grouped.all_gathers += 2
    if groups > 1:
        n_shards = k_full.shape[1] // k.shape[1]
        if n_shards % groups:
            raise ValueError(
                f"mesh axis size {n_shards} must be a multiple of the "
                f"group count {groups} (CFG halves may not straddle shards)"
            )
        group_len = k_full.shape[1] // groups
        g = mesh.index(axis) // (n_shards // groups)
        k_full = k_full[:, g * group_len:(g + 1) * group_len]
        v_full = v_full[:, g * group_len:(g + 1) * group_len]
    return dot_product_attention(q, k_full, v_full, implementation=implementation)


def shard_attention_over_mesh(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              implementation: str = "auto") -> torch.Tensor:
    """One attention over whole (B, S, H, D) inputs, the sequence split over
    the mesh's ``model`` axis: each rank attends its slice of queries, and
    the slices are gathered back to the whole output on every rank."""
    n, i = mesh.shape["model"], mesh.index("model")
    s = q.shape[1] // n
    if s * n != q.shape[1]:
        raise ValueError(f"sequence {q.shape[1]} not divisible by model={n}")
    part = slice(i * s, (i + 1) * s)
    out = cp_dot_product_attention(q[:, part], k[:, part], v[:, part], mesh,
                                   implementation=implementation)
    return mesh.all_gather(out, "model", dim=1)


cp_attention_grouped.all_gathers = 0
