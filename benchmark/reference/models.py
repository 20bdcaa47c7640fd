"""Plain reference of the Diffuman4D UNet, pose encoder and SD VAE.

Plain PyTorch, channels-last (NHWC), fp32 by default, with the diffusers
parameter names of the released checkpoint (zju3dv/Diffuman4D
``unet_multiview_condition.py`` / ``pose_encoder.py``, diffusers
``AutoencoderKL``), so one set of weights loads into this reference and into
the program under test. No kernel, cache or batching: every convolution is
``F.conv2d``, every attention a softmax over explicit scores, taken in blocks
of queries so that a 98,304-token 3D attention fits on one card.

``Prec`` sets the precision of the products. ``Prec()`` computes them in
fp32 (the caller turns TF32 off); ``Prec(fp8=True)`` rounds both operands of
every convolution, linear layer and attention product (Q, K, V and the
softmax probabilities) to float8 e4m3 with a per-tensor scale, accumulating
in fp32: the control that a lower precision than the configuration's bf16
must fail.

The reference imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0


class Prec:
    def __init__(self, fp8: bool = False, attn_block_bytes: int = 2 << 30):
        self.fp8 = fp8
        self.attn_block_bytes = attn_block_bytes

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the products see it: itself, or rounded to e4m3 with a
        per-tensor scale."""
        if not self.fp8:
            return x
        amax = x.detach().abs().amax().float().clamp(min=1e-12)
        scale = amax / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _conv(p: Prec, conv: nn.Conv2d, x: torch.Tensor, pad=None) -> torch.Tensor:
    """NHWC in, NHWC out; ``pad`` (left, right, top, bottom) replaces the
    conv's own padding."""
    xc = x.permute(0, 3, 1, 2)
    padding = conv.padding
    if pad is not None:
        xc = F.pad(xc, pad)
        padding = 0
    y = F.conv2d(p.q(xc), p.q(conv.weight), conv.bias, conv.stride, padding)
    return y.permute(0, 2, 3, 1)


def _linear(p: Prec, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(p.q(x), p.q(lin.weight), lin.bias)


def attention(p: Prec, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, H, D): softmax(q k^T / sqrt(D)) v, in blocks of
    queries of at most ``p.attn_block_bytes`` of scores."""
    b, s, h, d = q.shape
    sk = k.shape[1]
    qt = p.q(q).permute(0, 2, 1, 3).contiguous()  # (B, H, S, D)
    kt = p.q(k).permute(0, 2, 3, 1).contiguous()  # (B, H, D, Sk)
    vt = p.q(v).permute(0, 2, 1, 3).contiguous()  # (B, H, Sk, D)
    block = max(1, p.attn_block_bytes // (b * h * sk * 4))
    out = torch.empty_like(qt)
    scale = 1.0 / math.sqrt(d)
    for i in range(0, s, block):
        scores = torch.matmul(qt[:, :, i:i + block], kt) * scale
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        out[:, :, i:i + block] = torch.matmul(p.q(probs), vt)
    return out.permute(0, 2, 1, 3)


def group_norm(x: torch.Tensor, weight, bias, groups: int, eps: float) -> torch.Tensor:
    b, h, w, c = x.shape
    xg = x.float().reshape(b, h * w, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(b, h, w, c)
    return (y * weight.float() + bias.float()).to(x.dtype)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = math.gcd(groups, channels), eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.groups, self.eps)


def sinusoid(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True, shift: float = 0.0):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / (half - shift))
    arg = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(arg), torch.cos(arg)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class Base(nn.Module):
    """A module that reaches the shared ``Prec`` through its root."""

    prec: Prec = Prec()


class TimestepEmbedding(Base):
    def __init__(self, din: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(din, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        p = self.prec
        return _linear(p, self.linear_2, F.silu(_linear(p, self.linear_1, x)))


class Resnet(Base):
    def __init__(self, cin: int, cout: int, temb: int | None, groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups, eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb is not None:
            self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = GroupNorm(cout, groups, eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        p = self.prec
        h = _conv(p, self.conv1, F.silu(self.norm1(x)))
        if temb is not None:
            h = h + _linear(p, self.time_emb_proj, F.silu(temb))[:, None, None, :]
        h = _conv(p, self.conv2, F.silu(self.norm2(h)))
        sc = _conv(p, self.conv_shortcut, x) if hasattr(self, "conv_shortcut") else x
        return sc + h


class Attention(Base):
    def __init__(self, dim: int, heads: int, head_dim: int, qkv_bias: bool = False):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        self.to_q = nn.Linear(dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x):
        p = self.prec
        b, s, _ = x.shape
        shape = (b, s, self.heads, self.head_dim)
        o = attention(p, _linear(p, self.to_q, x).reshape(shape),
                      _linear(p, self.to_k, x).reshape(shape),
                      _linear(p, self.to_v, x).reshape(shape))
        return _linear(p, self.to_out[0], o.reshape(b, s, -1))


class GEGLU(Base):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = _linear(self.prec, self.proj, x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(Base):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return _linear(self.prec, self.net[2], self.net[0](x))


class TransformerBlock(Base):
    """attn1 over every frame of the window (3D), attn2 per frame, GEGLU."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, head_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, num_frames: int):
        bt, hw, c = x.shape
        h = self.norm1(x).reshape(bt // num_frames, num_frames * hw, c)
        x = x + self.attn1(h).reshape(bt, hw, c)
        x = x + self.attn2(self.norm2(x))
        return x + self.ff(self.norm3(x))


class Transformer(Base):
    def __init__(self, ch: int, heads: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(ch, groups, 1e-6)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(ch, heads, ch // heads)])
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x, num_frames: int):
        b, h, w, c = x.shape
        t = _linear(self.prec, self.proj_in, self.norm(x).reshape(b, h * w, c))
        for blk in self.transformer_blocks:
            t = blk(t, num_frames)
        return _linear(self.prec, self.proj_out, t).reshape(b, h, w, c) + x


class Sampler(Base):
    """Down (stride-2 conv) or up (nearest 2x then conv) sampler."""

    def __init__(self, ch: int, up: bool):
        super().__init__()
        self.up = up
        self.conv = nn.Conv2d(ch, ch, 3, stride=1 if up else 2, padding=1)

    def forward(self, x):
        if self.up:
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return _conv(self.prec, self.conv, x)


class Block(Base):
    """A UNet down / up block: resnets, optional transformers, a sampler."""

    def __init__(self, resnets, attentions, sampler_key, sampler):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if sampler_key:
            setattr(self, sampler_key, nn.ModuleList([sampler]))
        self.sampler_key = sampler_key


class PoseEncoder(Base):
    PLAN = ((3, 3, 1), (16, 4, 2), (16, 3, 1), (32, 4, 2), (32, 3, 1), (64, 4, 2),
            (64, 3, 1), (128, 3, 1))

    def __init__(self, out_ch: int):
        super().__init__()
        layers, cin = [], 3
        for ch, k, s in self.PLAN:
            layers += [nn.Conv2d(cin, ch, k, stride=s, padding=(k - 1) // 2 if k % 2 else 1),
                       nn.SiLU()]
            cin = ch
        self.conv_layers = nn.ModuleList(layers)
        self.final_proj = nn.Conv2d(cin, out_ch, 1)
        self.scale = nn.Parameter(torch.full((1,), 2.0))

    def forward(self, x):
        for layer in self.conv_layers:
            x = _conv(self.prec, layer, x) if isinstance(layer, nn.Conv2d) else F.silu(x)
        return _conv(self.prec, self.final_proj, x) * self.scale


class UNet(Base):
    """The multiview UNet: the deepest ``num_3d_attn_blocks`` attention
    stages and the mid block attend across the window's frames."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        ch = cfg["block_out_channels"]
        heads = cfg["num_attention_heads"]
        lpb, g = cfg["layers_per_block"], cfg["norm_num_groups"]
        ted = ch[0] * 4
        n = len(ch)
        self.time_embedding = TimestepEmbedding(ch[0], ted)
        if cfg["enable_tem_embeds"]:
            self.temporal_pos_embed = TimestepEmbedding(ch[0], ted)
        self.conv_in = nn.Conv2d(cfg["in_channels"], ch[0], 3, padding=1)
        if cfg["enable_pose_encoder"]:
            self.pose_encoder = PoseEncoder(ch[0])
        skips, prev, down = [ch[0]], ch[0], []
        for i in range(n):
            final = i == n - 1
            res = [Resnet(prev if j == 0 else ch[i], ch[i], ted, g) for j in range(lpb)]
            att = [] if final else [Transformer(ch[i], heads[i], g) for _ in range(lpb)]
            down.append(Block(res, att, None if final else "downsamplers",
                              None if final else Sampler(ch[i], up=False)))
            skips += [ch[i]] * lpb + ([] if final else [ch[i]])
            prev = ch[i]
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = Block([Resnet(ch[-1], ch[-1], ted, g) for _ in range(2)],
                               [Transformer(ch[-1], heads[-1], g)], None, None)
        rch, rheads, up = ch[::-1], heads[::-1], []
        for i in range(n):
            take = skips[-(lpb + 1):]
            del skips[-(lpb + 1):]
            res = []
            for skip in reversed(take):
                res.append(Resnet(prev + skip, rch[i], ted, g))
                prev = rch[i]
            att = [] if i == 0 else [Transformer(rch[i], rheads[i], g) for _ in take]
            last = i == n - 1
            up.append(Block(res, att, None if last else "upsamplers",
                            None if last else Sampler(rch[i], up=True)))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(ch[0], g)
        self.conv_out = nn.Conv2d(ch[0], cfg["out_channels"], 3, padding=1)

    def forward(self, x, timestep, tem_indices, num_frames: int, pose_features=None):
        cfg, p = self.cfg, self.prec
        ch0 = cfg["block_out_channels"][0]
        n = len(cfg["block_out_channels"])
        n3d = cfg["num_3d_attn_blocks"]
        emb = self.time_embedding(sinusoid(timestep, ch0))
        if cfg["enable_tem_embeds"]:
            emb = emb + self.temporal_pos_embed(sinusoid(tem_indices, ch0))
        h = _conv(p, self.conv_in, x)
        if pose_features is not None:
            h = h + pose_features
        states = [h]
        for i, blk in enumerate(self.down_blocks):
            nf = num_frames if (n - i - 1) < n3d else 1
            for j, res in enumerate(blk.resnets):
                h = res(h, emb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, nf)
                states.append(h)
            if blk.sampler_key:
                h = getattr(blk, blk.sampler_key)[0](h)
                states.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, emb), num_frames), emb)
        for i, blk in enumerate(self.up_blocks):
            nf = num_frames if i < n3d else 1
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, states.pop()], dim=-1), emb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, nf)
            if blk.sampler_key:
                h = getattr(blk, blk.sampler_key)[0](h)
        return _conv(p, self.conv_out, F.silu(self.conv_norm_out(h)))


class VAEAttention(Base):
    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = GroupNorm(ch, 32, 1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        p = self.prec
        b, h, w, c = x.shape
        t = self.group_norm(x).reshape(b, h * w, 1, c)
        o = attention(p, _linear(p, self.to_q, t), _linear(p, self.to_k, t),
                      _linear(p, self.to_v, t))
        return _linear(p, self.to_out[0], o.reshape(b, h * w, c)).reshape(b, h, w, c) + x


class VAEMid(Base):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(ch, ch, None, 32, 1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAEStage(Base):
    def __init__(self, resnets, key, sampler):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if key:
            setattr(self, key, nn.ModuleList([sampler]))
        self.key = key


class VAEDown(Base):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return _conv(self.prec, self.conv, x, pad=(0, 1, 0, 1))


class Encoder(Base):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, lpb = cfg["block_out_channels"], cfg["layers_per_block"]
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        stages, prev = [], ch[0]
        for i, c in enumerate(ch):
            last = i == len(ch) - 1
            stages.append(VAEStage([Resnet(prev if j == 0 else c, c, None, 32, 1e-6)
                                    for j in range(lpb)],
                                   None if last else "downsamplers",
                                   None if last else VAEDown(c)))
            prev = c
        self.down_blocks = nn.ModuleList(stages)
        self.mid_block = VAEMid(ch[-1])
        self.conv_norm_out = GroupNorm(ch[-1], 32, 1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg["latent_channels"], 3, padding=1)

    def forward(self, x):
        p = self.prec
        x = _conv(p, self.conv_in, x)
        for st in self.down_blocks:
            for r in st.resnets:
                x = r(x)
            if st.key:
                x = getattr(st, st.key)[0](x)
        x = self.mid_block(x)
        return _conv(p, self.conv_out, F.silu(self.conv_norm_out(x)))


class Decoder(Base):
    def __init__(self, cfg: dict):
        super().__init__()
        rch, lpb = cfg["block_out_channels"][::-1], cfg["layers_per_block"]
        self.conv_in = nn.Conv2d(cfg["latent_channels"], rch[0], 3, padding=1)
        self.mid_block = VAEMid(rch[0])
        stages, prev = [], rch[0]
        for i, c in enumerate(rch):
            last = i == len(rch) - 1
            stages.append(VAEStage([Resnet(prev if j == 0 else c, c, None, 32, 1e-6)
                                    for j in range(lpb + 1)],
                                   None if last else "upsamplers",
                                   None if last else Sampler(c, up=True)))
            prev = c
        self.up_blocks = nn.ModuleList(stages)
        self.conv_norm_out = GroupNorm(rch[-1], 32, 1e-6)
        self.conv_out = nn.Conv2d(rch[-1], 3, 3, padding=1)

    def forward(self, z):
        p = self.prec
        x = self.mid_block(_conv(p, self.conv_in, z))
        for st in self.up_blocks:
            for r in st.resnets:
                x = r(x)
            if st.key:
                x = getattr(st, st.key)[0](x)
        return _conv(p, self.conv_out, F.silu(self.conv_norm_out(x)))


class VAE(Base):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        lc = cfg["latent_channels"]
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    def encode(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Pixels in [-1, 1] -> the scaled posterior draw with ``noise``."""
        m = _conv(self.prec, self.quant_conv, self.encoder(x))
        mean, logvar = m.chunk(2, dim=-1)
        logvar = logvar.clamp(-30.0, 20.0)
        return (mean + torch.exp(0.5 * logvar) * noise) * self.cfg["scaling_factor"]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> pixels in [-1, 1]."""
        z = _conv(self.prec, self.post_quant_conv, z / self.cfg["scaling_factor"])
        return self.decoder(z)


def set_prec(module: nn.Module, prec: Prec) -> None:
    """Give every reference module of ``module`` the precision ``prec``."""
    for m in module.modules():
        if isinstance(m, Base):
            m.prec = prec
