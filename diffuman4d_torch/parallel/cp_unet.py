"""Context-parallel UNet forward: one window step spread over the mesh's
``model`` axis (counterpart of ``diffuman4d_tpu/parallel/cp_unet.py``).

The window's frame axis (a CFG batch of 32 or 48 frames) splits cleanly:
convs, norms, feed-forwards and the per-frame attention are frame-local,
so the only communication is the K/V all-gather inside the deepest stages'
3D attention (``ops/context_parallel.cp_attention_grouped``), plus, in the
port, one all-gather of the output so that every rank of the model group
holds the whole batch (the JAX function returns a sharded array instead).

Layout contract (checked here, with the JAX module's errors):
  * batch = groups * num_frames, b-major (CFG negative half first)
  * model axis size n: groups | n and n | batch, with >= 2 frames per rank
    so that the 3D / per-frame attention gating (num_frames > 1) is decided
    from local shapes

:func:`three_d_attention_layers` and :func:`cp_comm_budget` are the JAX
module's communication model, copied.
"""

from __future__ import annotations

import torch

from diffuman4d_torch.models.unet import UNetMultiviewCondition
from diffuman4d_torch.ops.context_parallel import ContextParallel


def make_cp_unet_apply(unet: UNetMultiviewCondition, mesh, axis: str = "model"):
    """Returns ``fn(x, t, tem, num_frames, pose_features=None)``: the UNet
    forward of the whole batch with its frame axis split over ``mesh``'s
    ``axis``. This rank runs its contiguous slice of the frames through the
    same modules (``unet.configured(cp=...)``, no second model) and returns
    the whole batch's output, gathered from the axis's ranks; the math is
    the single-device forward's, K/V gathered rather than resident."""
    n = mesh.shape[axis]

    def apply_fn(x, t, tem, num_frames, pose_features=None):
        B = x.shape[0]
        groups = B // num_frames
        if B % num_frames:
            raise ValueError(f"batch {B} not a multiple of num_frames {num_frames}")
        if B % n:
            raise ValueError(f"batch {B} not divisible by mesh axis {axis}={n}")
        if n % groups:
            raise ValueError(
                f"mesh axis {axis}={n} must be a multiple of the CFG group "
                f"count {groups} so halves never straddle a shard"
            )
        local_frames = B // n
        if n > 1 and local_frames < 2:
            raise ValueError(
                f"{axis}={n} leaves {local_frames} frame/shard; need >= 2 "
                "(3D-attention stage gating is decided from local shapes)"
            )
        i = mesh.index(axis)
        part = slice(i * local_frames, (i + 1) * local_frames)
        t = torch.as_tensor(t, device=x.device).reshape(-1).expand(B)
        with unet.configured(attn_implementation="auto",
                             cp=ContextParallel(mesh, axis, groups)):
            out = unet(x[part], t[part], tem_indices=tem[part], num_frames=local_frames,
                       pose_features=None if pose_features is None else pose_features[part])
        return mesh.all_gather(out, axis, dim=0)

    return apply_fn


# ---------------------------------------------------------------------------
# communication budget: the analytical model of the JAX package's docs/SCALING.md
# ---------------------------------------------------------------------------
def three_d_attention_layers(cfg) -> list[tuple[int, int]]:
    """(downscale_exponent, n_transformer_layers) for every UNet stage
    whose attention runs in 3D (cross-frame) mode -- the only stages that
    communicate under context parallelism. Mirrors the forward's gating
    (``models/unet.py``: down ``n_blocks-i-1 < k``, mid always, up ``i < k``)."""
    n_blocks = len(cfg.block_out_channels)
    k = cfg.num_3d_attn_blocks
    out = []
    for i in range(n_blocks - 1):  # CrossAttn down blocks
        if n_blocks - i - 1 < k:
            out.append((i, cfg.layers_per_block * cfg.transformer_layers_per_block))
    out.append((n_blocks - 1, cfg.transformer_layers_per_block))  # mid
    for i in range(1, n_blocks):  # CrossAttn up blocks
        if i < k:
            out.append(
                (n_blocks - 1 - i,
                 (cfg.layers_per_block + 1) * cfg.transformer_layers_per_block)
            )
    return out


def cp_comm_budget(cfg, num_frames: int, latent_hw: int, groups: int = 2,
                   n_model: int = 2, dtype_bytes: int = 2) -> dict:
    """Per-window-step CP communication budget at a given topology.

    Returns per-stage and total all-gather bytes *received per rank* for
    one UNet forward (K and V each all-gathered once per 3D transformer
    layer; each rank receives (n-1)/n of the full gathered size). The
    expected collective count is what the tests pin against the K/V
    gathers counted by ``ops/context_parallel.cp_attention_grouped``."""
    stages = three_d_attention_layers(cfg)
    per_stage = []
    total_rx = 0
    n_layers_total = 0
    for stage_idx, n_layers in stages:
        hw = (latent_hw // (2**stage_idx)) ** 2
        heads = cfg.num_attention_heads[stage_idx]
        d = cfg.block_out_channels[stage_idx] // heads
        s_full = num_frames * hw  # tokens per group (CFG half)
        kv_full = 2 * groups * s_full * heads * d * dtype_bytes  # K + V
        rx = kv_full * (n_model - 1) // n_model * n_layers
        total_rx += rx
        n_layers_total += n_layers
        per_stage.append(
            {
                "stage_hw": latent_hw // (2**stage_idx),
                "layers": n_layers,
                "tokens_per_group": s_full,
                "kv_bytes_full": kv_full,
                "rx_bytes_per_chip": rx,
            }
        )
    return {
        "stages": per_stage,
        "n_3d_layers": n_layers_total,
        "expected_all_gathers": 2 * n_layers_total,  # K and V
        "rx_bytes_per_chip_total": total_rx,
    }
