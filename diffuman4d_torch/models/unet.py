"""The spatio-temporal multiview UNet (counterpart of
``diffuman4d_tpu/models/unet.py``).

SD2.1-shaped: conv_in -> 4 down blocks -> mid -> 4 up blocks -> conv_out,
channels (320, 640, 1280, 1280), heads (5, 10, 20, 20), head dim 64. Only
the deepest ``num_3d_attn_blocks`` attention stages attend across the
window's frames (the mid block always does); an optional zero-init
temporal embedding is fed per-frame indices; an optional pose-encoder
feature is added to conv_in's output (without it, ``conv_in`` takes the
skeleton's VAE latent among its input channels); ``freeu`` (``b1, b2, s1,
s2``) turns on FreeU in the first two up blocks. Inputs and outputs are
NHWC.

Two settings serve training, as in the JAX module: ``attn_implementation``
is handed down to every ``Attention`` ("train" selects the differentiable
kernels), and ``remat`` recomputes each down / mid / up block and the pose
encoder in the backward pass (``torch.utils.checkpoint``), so that only
block boundaries are kept. Neither changes a parameter name.
``configured(cp=...)`` runs the 3D attention context-parallel (the JAX
module's ``attn_implementation="cp"`` / ``cp_groups``), as
``parallel/cp_unet.py`` drives it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from diffuman4d_torch.models.layers import (
    Attention,
    GroupNorm,
    TimestepEmbedding,
    conv_nhwc,
    timestep_sinusoidal,
)
from diffuman4d_torch.models.freeu import FreeUConfig
from diffuman4d_torch.models.pose_encoder import PoseEncoder
from diffuman4d_torch.models.transformer import MultiviewTransformerBlock
from diffuman4d_torch.models.unet_blocks import (
    CrossAttnDownBlockMultiview,
    CrossAttnUpBlockMultiview,
    DownBlock2D,
    UNetMidBlockMultiviewCrossAttn,
    UpBlock2D,
)


@dataclass(frozen=True)
class UNetConfig:
    """Same fields and defaults as the JAX package's ``UNetConfig``."""

    in_channels: int = 11  # latents 4 + plucker 6 + cond_mask 1 (pose enc on)
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_attention_heads: tuple[int, ...] = (5, 10, 20, 20)  # head COUNT per stage
    transformer_layers_per_block: int = 1
    use_linear_projection: bool = True
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True
    num_3d_attn_blocks: int = 3
    enable_tem_embeds: bool = True
    enable_pose_encoder: bool = True
    freeu: Optional[tuple[float, float, float, float]] = None

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


class TimestepEmbeddingZeroOut(TimestepEmbedding):
    """TimestepEmbedding whose ``linear_2`` starts at zero (the temporal
    head begins as an exact no-op); the zero init is applied by
    ``sampling.loader.init_random_params``."""


class UNetMultiviewCondition(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig(), attn_implementation: str = "auto",
                 remat: bool = False):
        super().__init__()
        cfg = self.config = config
        self.remat = remat
        impl = attn_implementation
        ch = cfg.block_out_channels
        n = len(ch)
        ted = cfg.time_embed_dim
        groups = cfg.norm_num_groups
        self.time_embedding = TimestepEmbedding(ch[0], ted)
        if cfg.enable_tem_embeds:
            self.temporal_pos_embed = TimestepEmbeddingZeroOut(ch[0], ted)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        if cfg.enable_pose_encoder:
            self.pose_encoder = PoseEncoder(ch[0])

        down, skips, prev = [], [ch[0]], ch[0]
        for i in range(n):
            final = i == n - 1
            if final:
                blk = DownBlock2D(prev, ch[i], ted, cfg.layers_per_block, False, groups)
            else:
                blk = CrossAttnDownBlockMultiview(
                    prev, ch[i], ted, cfg.num_attention_heads[i], cfg.layers_per_block,
                    cfg.transformer_layers_per_block, True, groups, cfg.use_linear_projection,
                    attn_implementation=impl)
            down.append(blk)
            skips += [ch[i]] * cfg.layers_per_block + ([] if final else [ch[i]])
            prev = ch[i]
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = UNetMidBlockMultiviewCrossAttn(
            ch[-1], ted, cfg.num_attention_heads[-1], 1, cfg.transformer_layers_per_block,
            groups, cfg.use_linear_projection, attn_implementation=impl)

        freeu = FreeUConfig(*cfg.freeu) if cfg.freeu is not None else None
        up = []
        rev_ch, rev_heads = list(reversed(ch)), list(reversed(cfg.num_attention_heads))
        n_up = cfg.layers_per_block + 1
        for i in range(n):
            take = skips[-n_up:]
            del skips[-n_up:]
            pop_order = list(reversed(take))
            add_up = i != n - 1
            if i == 0:
                blk = UpBlock2D(prev, pop_order, rev_ch[i], ted, add_up, groups, i, freeu)
            else:
                blk = CrossAttnUpBlockMultiview(
                    prev, pop_order, rev_ch[i], ted, rev_heads[i],
                    cfg.transformer_layers_per_block, add_up, groups, cfg.use_linear_projection,
                    attn_implementation=impl, resolution_idx=i, freeu=freeu)
            up.append(blk)
            prev = rev_ch[i]
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(ch[0], groups, cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    @property
    def attn_implementation(self) -> str:
        return next(m.attn_implementation for m in self.modules() if isinstance(m, Attention))

    @contextlib.contextmanager
    def configured(self, attn_implementation: str | None = None, remat: bool | None = None,
                   cp=None):
        """Run with another attention implementation, remat setting and / or
        context-parallel setting of the transformer blocks (an
        ``ops.context_parallel.ContextParallel``), restored on exit (what
        ``clone(...)`` does for the flax module)."""
        attns = [m for m in self.modules() if isinstance(m, Attention)]
        blocks = [m for m in self.modules() if isinstance(m, MultiviewTransformerBlock)]
        saved = ([m.attn_implementation for m in attns], self.remat, [m.cp for m in blocks])
        if attn_implementation is not None:
            for m in attns:
                m.attn_implementation = attn_implementation
        if remat is not None:
            self.remat = remat
        if cp is not None:
            for m in blocks:
                m.cp = cp
        try:
            yield self
        finally:
            for m, impl in zip(attns, saved[0]):
                m.attn_implementation = impl
            self.remat = saved[1]
            for m, c in zip(blocks, saved[2]):
                m.cp = c

    def _run(self, fn, *args):
        """``fn(*args)``, recomputed in the backward pass when remat is on."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def forward(
        self,
        sample: torch.Tensor,  # (B, H, W, in_channels)
        timestep: torch.Tensor,  # (B,) or scalar
        skeletons: torch.Tensor | None = None,  # (B, 8H, 8W, 3)
        tem_indices: torch.Tensor | None = None,  # (B,) int frame indices
        num_frames: int = 1,
        pose_features: torch.Tensor | None = None,  # (B, H, W, ch0)
    ) -> torch.Tensor:
        cfg = self.config
        dtype = self.dtype
        ch0 = cfg.block_out_channels[0]
        n = len(cfg.block_out_channels)
        B = sample.shape[0]
        dev = sample.device

        timestep = torch.as_tensor(timestep, device=dev).reshape(-1).expand(B)
        t_emb = timestep_sinusoidal(timestep, ch0, cfg.flip_sin_to_cos, cfg.freq_shift)
        emb = self.time_embedding(t_emb.to(dtype))
        if cfg.enable_tem_embeds:
            if tem_indices is None:
                tem_indices = torch.zeros((B,), dtype=torch.int32, device=dev)
            f_emb = timestep_sinusoidal(tem_indices, ch0, True, 0.0)
            emb = emb + self.temporal_pos_embed(f_emb.to(dtype))

        x = conv_nhwc(self.conv_in, sample.to(dtype))
        if cfg.enable_pose_encoder:
            if pose_features is None:
                if skeletons is None:
                    raise ValueError("enable_pose_encoder requires skeletons or pose_features")
                # full-resolution activations: recomputed under remat
                pose_features = self._run(self.pose_encoder, skeletons.to(dtype))
            x = x + pose_features

        res_states = [x]
        for i, blk in enumerate(self.down_blocks):
            nf = num_frames if (n - i - 1) < cfg.num_3d_attn_blocks else 1
            x, states = self._run(lambda x, emb, blk=blk, nf=nf: blk(x, emb, nf), x, emb)
            res_states.extend(states)

        x = self._run(lambda x, emb: self.mid_block(x, emb, num_frames), x, emb)

        n_up = cfg.layers_per_block + 1
        for i, blk in enumerate(self.up_blocks):
            take = res_states[-n_up:]
            del res_states[-n_up:]
            nf = num_frames if i < cfg.num_3d_attn_blocks else 1
            # each block gets its own list of skips: it pops from it, and
            # under remat its body runs a second time on the same arguments
            x = self._run(lambda x, emb, *skips, blk=blk, nf=nf: blk(x, list(skips), emb, nf),
                          x, emb, *take)

        x = self.conv_norm_out(x, silu=True)
        return conv_nhwc(self.conv_out, x)
