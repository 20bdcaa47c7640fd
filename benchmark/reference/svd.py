"""Plain reference of Stable Video Diffusion XT (diffusers
``UNetSpatioTemporalConditionModel``, ``AutoencoderKLTemporalDecoder`` and
``EulerDiscreteScheduler`` with Karras sigmas and v-prediction; Blattmann et
al., arXiv:2311.15127), written from the published modules in plain fp32
PyTorch, channels-last, with diffusers' parameter names, so one set of
weights loads here and into the program under test.

Departures from the published modules, none of which changes a value:

* activations are (B * F, H, W, C), a clip's F frames consecutive rows, and
  the frames' axis is moved where diffusers permutes to (B, C, F, H, W);
* ``image_only_indicator`` is all zeros (image-to-video sampling), so every
  mix is ``sigmoid(mix_factor)`` (``learned_with_images``) or, in the
  decoder, ``1 - sigmoid`` of it (``learned``, switched);
* the temporal blocks' cross-attention projects the clip's first-frame
  token once and repeats its key and value over the clip's pixels, where
  diffusers broadcasts the token to every pixel before projecting;
* attention is taken in blocks of queries (``models.attention``), the
  temporal decoder's spatial layers in blocks of frames, so that the
  cell's 50-frame UNet step and 25-frame decode fit on one card.

``Prec`` (``models.py``) sets the products' precision: fp32, or the float8
e4m3 control. The SD encoder is ``models.Encoder``. The scheduler's step is
the closed form of Euler's v-prediction step on the scaled state ``y = x /
sqrt(sigma^2 + 1)`` in float64 (:class:`KarrasEuler`). Nothing here imports
the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import models as ref
from benchmark.reference.models import Base, GroupNorm, Prec, _conv, _linear, sinusoid

FRAME_BLOCK = 5  # frames per block of the decoder's spatial layers


def attention(p: Prec, q, k, v):
    """Every attention of this module (the work count records its sites)."""
    return ref.attention(p, q, k, v)


def temporal_attention(p: Prec, q, k, v):
    """The temporal blocks' self-attention over the frames."""
    return attention(p, q, k, v)


def _clip(x: torch.Tensor, frames: int) -> torch.Tensor:
    bf, h, w, c = x.shape
    return x.reshape(bf // frames, frames * h, w, c)


def temporal_conv(p: Prec, conv: nn.Conv3d, x: torch.Tensor, frames: int) -> torch.Tensor:
    """``nn.Conv3d`` (3, 1, 1), padding (1, 0, 0), over a clip's frames."""
    bf, h, w, c = x.shape
    x5 = x.reshape(bf // frames, frames, h, w, c).permute(0, 4, 1, 2, 3)
    y = F.conv3d(p.q(x5), p.q(conv.weight), conv.bias, padding=(1, 0, 0))
    return y.permute(0, 2, 3, 4, 1).reshape(bf, h, w, -1)


def _per_frames(fn, x: torch.Tensor, block: int | None) -> torch.Tensor:
    if block is None or x.shape[0] <= block:
        return fn(x)
    return torch.cat([fn(x[i:i + block]) for i in range(0, x.shape[0], block)])


class Mixer(Base):
    def __init__(self, alpha: float, switch: bool = False):
        super().__init__()
        self.switch = switch
        self.mix_factor = nn.Parameter(torch.tensor([alpha]))

    def forward(self, xs, xt):
        a = torch.sigmoid(self.mix_factor)
        if self.switch:
            a = 1.0 - a
        return a * xs + (1.0 - a) * xt


class TemporalResnet(Base):
    def __init__(self, ch: int, temb: int | None, eps: float, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(ch, groups, eps)
        self.conv1 = nn.Conv3d(ch, ch, (3, 1, 1), padding=(1, 0, 0))
        if temb is not None:
            self.time_emb_proj = nn.Linear(temb, ch)
        self.norm2 = GroupNorm(ch, groups, eps)
        self.conv2 = nn.Conv3d(ch, ch, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x, temb, frames: int):
        p = self.prec
        h = F.silu(self.norm1(_clip(x, frames))).reshape(x.shape)
        h = temporal_conv(p, self.conv1, h, frames)
        if temb is not None:
            h = h + _linear(p, self.time_emb_proj, F.silu(temb))[:, None, None, :]
        h = F.silu(self.norm2(_clip(h, frames))).reshape(x.shape)
        return x + temporal_conv(p, self.conv2, h, frames)


class STResBlock(Base):
    def __init__(self, cin: int, cout: int, temb: int | None, eps: float,
                 temporal_eps: float | None = None, groups: int = 32, alpha: float = 0.5,
                 switch: bool = False, frame_block: int | None = None):
        super().__init__()
        self.spatial_res_block = ref.Resnet(cin, cout, temb, groups, eps)
        self.temporal_res_block = TemporalResnet(cout, temb, eps if temporal_eps is None
                                                 else temporal_eps, groups)
        self.time_mixer = Mixer(alpha, switch)
        self.frame_block = frame_block

    def forward(self, x, temb, frames: int):
        h = _per_frames(lambda xb: self.spatial_res_block(xb, None), x, self.frame_block) \
            if temb is None else self.spatial_res_block(x, temb)
        return self.time_mixer(h, self.temporal_res_block(h, temb, frames))


class XAttention(Base):
    """Self-attention, or cross-attention to ``context`` of B / n rows for
    n consecutive query rows each."""

    def __init__(self, dim: int, heads: int, head_dim: int, kv_dim: int | None = None,
                 site=None):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim or dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])
        self.temporal = site == "temporal"

    def forward(self, x, context=None):
        p = self.prec
        b, s, _ = x.shape
        kv = x if context is None else context
        q = _linear(p, self.to_q, x).reshape(b, s, self.heads, self.head_dim)
        k = _linear(p, self.to_k, kv).reshape(kv.shape[0], kv.shape[1], self.heads,
                                              self.head_dim)
        v = _linear(p, self.to_v, kv).reshape(k.shape)
        if kv.shape[0] != b:
            k = k.repeat_interleave(b // kv.shape[0], dim=0)
            v = v.repeat_interleave(b // kv.shape[0], dim=0)
        o = (temporal_attention if self.temporal else attention)(p, q, k, v)
        return _linear(p, self.to_out[0], o.reshape(b, s, -1))


class FF(Base):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([ref.GEGLU(dim, 4 * dim), nn.Identity(),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return _linear(self.prec, self.net[2], self.net[0](x))


class SpatialBlock(Base):
    def __init__(self, dim: int, heads: int, kv_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = XAttention(dim, heads, dim // heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = XAttention(dim, heads, dim // heads, kv_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FF(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class TemporalBlock(Base):
    def __init__(self, dim: int, heads: int, kv_dim: int):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim)
        self.ff_in = FF(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = XAttention(dim, heads, dim // heads, site="temporal")
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = XAttention(dim, heads, dim // heads, kv_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FF(dim)

    def forward(self, x, context):
        x = x + self.ff_in(self.norm_in(x))
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class STTransformer(Base):
    def __init__(self, ch: int, heads: int, kv_dim: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(ch, groups, 1e-6)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList([SpatialBlock(ch, heads, kv_dim)])
        self.temporal_transformer_blocks = nn.ModuleList([TemporalBlock(ch, heads, kv_dim)])
        self.time_pos_embed = _TimestepEmbedding(ch, 4 * ch, ch)
        self.time_mixer = Mixer(0.5)
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x, context, frames: int):
        p = self.prec
        bf, h, w, c = x.shape
        b, n = bf // frames, h * w
        t = _linear(p, self.proj_in, self.norm(x).reshape(bf, n, c))
        pos = self.time_pos_embed(sinusoid(torch.arange(frames, device=x.device).repeat(b), c))
        for blk, tblk in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            t = blk(t, context.repeat_interleave(frames, dim=0))
            tt = (t + pos[:, None, :]).reshape(b, frames, n, c).transpose(1, 2)
            tt = tblk(tt.reshape(b * n, frames, c), context)
            tt = tt.reshape(b, n, frames, c).transpose(1, 2).reshape(bf, n, c)
            t = self.time_mixer(t, tt)
        return _linear(p, self.proj_out, t).reshape(bf, h, w, c) + x


class _TimestepEmbedding(Base):
    def __init__(self, din: int, dim: int, dout: int | None = None):
        super().__init__()
        self.linear_1 = nn.Linear(din, dim)
        self.linear_2 = nn.Linear(dim, dout or dim)

    def forward(self, x):
        p = self.prec
        return _linear(p, self.linear_2, F.silu(_linear(p, self.linear_1, x)))


class Block(Base):
    def __init__(self, resnets, attentions, key=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if key:
            setattr(self, key, nn.ModuleList([sampler]))
        self.key = key


class UNet(Base):
    """``UNetSpatioTemporalConditionModel`` (resnet eps: 1e-6 in the
    cross-attention down blocks and the up blocks, 1e-5 in the last down
    block and the mid block, as diffusers' block classes set them)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        ch, heads = cfg["block_out_channels"], cfg["num_attention_heads"]
        lpb, g = cfg["layers_per_block"], cfg.get("norm_num_groups", 32)
        kv, ted, n = cfg["cross_attention_dim"], ch[0] * 4, len(ch)
        self.conv_in = nn.Conv2d(cfg["in_channels"], ch[0], 3, padding=1)
        self.time_embedding = _TimestepEmbedding(ch[0], ted)
        self.add_embedding = _TimestepEmbedding(cfg["projection_class_embeddings_input_dim"], ted)
        skips, prev, down = [ch[0]], ch[0], []
        for i in range(n):
            final = i == n - 1
            eps = 1e-5 if final else 1e-6
            res = [STResBlock(prev if j == 0 else ch[i], ch[i], ted, eps, groups=g)
                   for j in range(lpb)]
            att = [] if final else [STTransformer(ch[i], heads[i], kv, g) for _ in range(lpb)]
            down.append(Block(res, att, None if final else "downsamplers",
                              None if final else ref.Sampler(ch[i], up=False)))
            skips += [ch[i]] * lpb + ([] if final else [ch[i]])
            prev = ch[i]
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = Block([STResBlock(ch[-1], ch[-1], ted, 1e-5, groups=g)
                                for _ in range(2)], [STTransformer(ch[-1], heads[-1], kv, g)])
        rch, rheads, up = ch[::-1], heads[::-1], []
        for i in range(n):
            take = skips[-(lpb + 1):]
            del skips[-(lpb + 1):]
            res = []
            for skip in reversed(take):
                res.append(STResBlock(prev + skip, rch[i], ted, 1e-6, groups=g))
                prev = rch[i]
            att = [] if i == 0 else [STTransformer(rch[i], rheads[i], kv, g) for _ in take]
            last = i == n - 1
            up.append(Block(res, att, None if last else "upsamplers",
                            None if last else ref.Sampler(rch[i], up=True)))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(ch[0], g, 1e-5)
        self.conv_out = nn.Conv2d(ch[0], cfg["out_channels"], 3, padding=1)

    def forward(self, x, timestep, context, added_time_ids, frames: int):
        """``x`` (B * F, h, w, in); ``timestep`` (B * F,); ``context`` (B, 1,
        D); ``added_time_ids`` (B, 3)."""
        cfg, p = self.cfg, self.prec
        b = x.shape[0] // frames
        emb = self.time_embedding(sinusoid(timestep, cfg["block_out_channels"][0]))
        ids = sinusoid(added_time_ids.reshape(-1), cfg["addition_time_embed_dim"]).reshape(b, -1)
        emb = emb + self.add_embedding(ids).repeat_interleave(frames, dim=0)
        h = _conv(p, self.conv_in, x)
        states = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, emb, frames)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, context, frames)
                states.append(h)
            if blk.key:
                h = getattr(blk, blk.key)[0](h)
                states.append(h)
        mid = self.mid_block
        h = mid.resnets[0](h, emb, frames)
        h = mid.resnets[1](mid.attentions[0](h, context, frames), emb, frames)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, states.pop()], dim=-1), emb, frames)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, context, frames)
            if blk.key:
                h = getattr(blk, blk.key)[0](h)
        return _conv(p, self.conv_out, F.silu(self.conv_norm_out(h)))


class VAEAttention(ref.VAEAttention):
    """The d = 512 mid attention, through this module's ``attention``."""

    def forward(self, x):
        p = self.prec
        b, h, w, c = x.shape
        t = self.group_norm(x).reshape(b, h * w, 1, c)
        o = attention(p, _linear(p, self.to_q, t), _linear(p, self.to_k, t),
                      _linear(p, self.to_v, t))
        return _linear(p, self.to_out[0], o.reshape(b, h * w, c)).reshape(b, h, w, c) + x


def _dec_block(cin: int, cout: int) -> STResBlock:
    return STResBlock(cin, cout, None, 1e-6, 1e-5, alpha=0.0, switch=True,
                      frame_block=FRAME_BLOCK)


class TemporalDecoder(Base):
    def __init__(self, cfg: dict):
        super().__init__()
        rch, lpb = cfg["block_out_channels"][::-1], cfg["layers_per_block"]
        self.conv_in = nn.Conv2d(cfg["latent_channels"], rch[0], 3, padding=1)
        self.mid_block = Block([_dec_block(rch[0], rch[0]) for _ in range(lpb)],
                               [VAEAttention(rch[0])])
        stages, prev = [], rch[0]
        for i, c in enumerate(rch):
            last = i == len(rch) - 1
            stages.append(Block([_dec_block(prev if j == 0 else c, c) for j in range(lpb + 1)],
                                [], None if last else "upsamplers",
                                None if last else ref.Sampler(c, up=True)))
            prev = c
        self.up_blocks = nn.ModuleList(stages)
        self.conv_norm_out = GroupNorm(rch[-1], 32, 1e-6)
        self.conv_out = nn.Conv2d(rch[-1], 3, 3, padding=1)
        self.time_conv_out = nn.Conv3d(3, 3, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, z, frames: int):
        p = self.prec
        x = _conv(p, self.conv_in, z)
        mid = self.mid_block
        x = mid.resnets[0](x, None, frames)
        for res, att in zip(mid.resnets[1:], mid.attentions):
            x = res(_per_frames(att, x, FRAME_BLOCK), None, frames)
        for st in self.up_blocks:
            for r in st.resnets:
                x = r(x, None, frames)
            if st.key:
                x = _per_frames(getattr(st, st.key)[0], x, FRAME_BLOCK)
        x = _per_frames(lambda xb: _conv(p, self.conv_out, F.silu(self.conv_norm_out(xb))), x,
                        FRAME_BLOCK)
        return temporal_conv(p, self.time_conv_out, x, frames)


class VAE(Base):
    """``AutoencoderKLTemporalDecoder``: the SD encoder and ``quant_conv``,
    the temporal decoder, no ``post_quant_conv``."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        lc = cfg["latent_channels"]
        self.encoder = ref.Encoder(cfg)
        self.decoder = TemporalDecoder(cfg)
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """Pixels in [-1, 1] -> the posterior's mean, unscaled."""
        return _conv(self.prec, self.quant_conv, self.encoder(x)).chunk(2, dim=-1)[0]

    def decode(self, z: torch.Tensor, frames: int) -> torch.Tensor:
        """Scaled latents of clips of ``frames`` rows -> pixels in [-1, 1]."""
        return self.decoder(z / self.cfg["scaling_factor"], frames)


class KarrasEuler:
    """diffusers ``EulerDiscreteScheduler`` with ``use_karras_sigmas``: n
    sigmas from ``sigma_max`` to ``sigma_min`` (rho 7) in float64, held in
    fp32 as diffusers holds them, and a trailing 0; continuous timesteps
    ``0.25 ln sigma`` (fp32); the v-prediction Euler step on the scaled
    state, in float64 (:meth:`step`)."""

    def __init__(self, cfg: dict, n: int):
        rho = 7.0
        ramp = np.linspace(0, 1, n)
        lo, hi = cfg["sigma_min"] ** (1 / rho), cfg["sigma_max"] ** (1 / rho)
        sig32 = torch.tensor((hi + ramp * (lo - hi)) ** rho, dtype=torch.float32)
        self.n = n
        self.timesteps = (0.25 * sig32.log()).numpy()
        self.sigmas = np.concatenate([sig32.double().numpy(), [0.0]])

    def step(self, v: torch.Tensor, t_idx: np.ndarray, y: torch.Tensor,
             mask: np.ndarray) -> torch.Tensor:
        """``y_next = (y (1 + s s') + (s' - s) v) / (sqrt(s^2 + 1) sqrt(s'^2
        + 1))`` per row (s, s' the row's sigma and the next): Euler's step
        ``x + (s' - s)(x - x0) / s`` with ``x = y sqrt(s^2 + 1)`` and ``x0 =
        x / (s^2 + 1) - s v / sqrt(s^2 + 1)``, divided by ``sqrt(s'^2 + 1)``.
        Rows off ``mask`` keep ``y``; fp32 out."""
        idx = np.clip(t_idx, 0, self.n - 1)
        s, s1 = self.sigmas[idx], self.sigmas[idx + 1]
        shape = (-1,) + (1,) * (y.dim() - 1)

        def col(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=y.device).reshape(shape)

        out = (y.double() * col(1 + s * s1) + col(s1 - s) * v.double()) / \
            col(np.sqrt(s * s + 1) * np.sqrt(s1 * s1 + 1))
        m = torch.as_tensor(mask, device=y.device).reshape(shape)
        return torch.where(m, out, y.double()).float()


def set_prec(module: nn.Module, prec: Prec) -> None:
    ref.set_prec(module, prec)

