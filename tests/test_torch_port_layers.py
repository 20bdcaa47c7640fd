"""Each block of the port's ``models/layers.py``, the multiview transformer
(2D and 3D) and the pose encoder against the JAX package's flax modules.

fp32 on both sides, flax params perturbed away from their zero / one inits
and carried into the port through the same name mapping as the UNet carry.
Unless stated, the tolerance covers fp32 summation-order differences
between XLA and ATen (1e-5 relative to the unit-scale activations)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffuman4d_torch.models import layers
from tests.torch_port_helpers import j, jit_apply, load_block, n, perturb_params, randn, rng, t

ATOL = 2e-5


def _init(mod, *args, **kw):
    params = jax.jit(lambda k: mod.init(k, *args, **kw))(jax.random.PRNGKey(0))
    return perturb_params(params, 1, scale=0.1)


def _compare(got, want, atol=ATOL):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=atol)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_sinusoidal(dim):
    from diffuman4d_tpu.models.layers import timestep_sinusoidal as jts
    from diffuman4d_torch.models.layers import timestep_sinusoidal

    ts = np.array([0, 1, 17, 500, 999], np.int32)
    for flip, shift in ((True, 0.0), (False, 1.0)):
        # sin/cos of arguments up to ~1e3 in fp32: 1e-4 absolute
        _compare(timestep_sinusoidal(torch.from_numpy(ts), dim, flip, shift),
                 jts(jnp.asarray(ts), dim, flip, shift), atol=1e-4)


def test_timestep_embedding():
    from diffuman4d_tpu.models.layers import TimestepEmbedding as J
    from diffuman4d_torch.models.layers import TimestepEmbedding

    x = randn(rng(0), 3, 16)
    mod = J(32, dtype=jnp.float32)
    p = _init(mod, j(x))
    port = load_block(TimestepEmbedding(16, 32), p["params"])
    _compare(port(t(x)), jit_apply(mod)(p, j(x)))


@pytest.mark.parametrize("channels,groups", [(8, 32), (64, 32), (12, 4)])
def test_groupnorm(channels, groups):
    from diffuman4d_tpu.models.layers import GroupNorm as J
    from diffuman4d_torch.models.layers import GroupNorm

    x = randn(rng(1), 2, 5, 6, channels) * 2 + 0.5
    mod = J(groups, 1e-5)
    p = _init(mod, j(x))
    port = load_block(GroupNorm(channels, groups, 1e-5), p["params"]["GroupNorm_0"])
    _compare(port(t(x)), jit_apply(mod)(p, j(x)))


@pytest.mark.parametrize("channels,groups", [(40, 4), (60, 2), (24, 8)])
def test_groupnorm_silu_flag(channels, groups):
    """``GroupNorm(x, silu=True)`` is the JAX package's ``silu(GroupNorm(x))``
    (C / G = 10, 30 and 3 channels a group)."""
    from diffuman4d_tpu.models.layers import GroupNorm as J
    from diffuman4d_torch.models.layers import GroupNorm

    x = randn(rng(1), 2, 5, 6, channels) * 2 + 0.5
    mod = J(groups, 1e-5)
    p = _init(mod, j(x))
    port = load_block(GroupNorm(channels, groups, 1e-5), p["params"]["GroupNorm_0"])
    want = jax.jit(lambda p, x: jax.nn.silu(mod.apply(p, x)))(p, j(x))
    _compare(port(t(x), silu=True), want)


def test_attention_block_head_dim_64():
    from diffuman4d_tpu.models.layers import Attention as J
    from diffuman4d_torch.models.layers import Attention

    x = randn(rng(2), 2, 24, 128)
    mod = J(2, 64, dtype=jnp.float32, implementation="xla")
    p = _init(mod, j(x))
    port = load_block(Attention(128, 2, 64), p["params"])
    _compare(port(t(x)), jit_apply(mod)(p, j(x)), atol=1e-4)


def test_feedforward_geglu():
    from diffuman4d_tpu.models.layers import FeedForward as J
    from diffuman4d_torch.models.layers import FeedForward

    x = randn(rng(3), 2, 7, 16)
    mod = J(dtype=jnp.float32)
    p = _init(mod, j(x))
    port = load_block(FeedForward(16), p["params"], wrap="ff")
    _compare(port(t(x)), jit_apply(mod)(p, j(x)))


@pytest.mark.parametrize("cin,cout,temb", [(8, 8, True), (8, 16, True), (16, 8, False)])
def test_resnet_block_plain(cin, cout, temb):
    from diffuman4d_tpu.models.layers import ResnetBlock2D as J
    from diffuman4d_torch.models.layers import ResnetBlock2D

    r = rng(4)
    x = randn(r, 2, 6, 5, cin)
    e = randn(r, 2, 12) if temb else None
    mod = J(cout, use_temb=temb, groups=4, dtype=jnp.float32)
    p = _init(mod, j(x), None if e is None else j(e))
    port = load_block(ResnetBlock2D(cin, cout, 12 if temb else None, 4), p["params"])
    want = jit_apply(mod)(p, j(x), None if e is None else j(e))
    _compare(port(t(x), None if e is None else t(e)), want, atol=1e-4)


def test_resnet_block_fused_path(monkeypatch):
    """At a gated shape the port takes the fused conv3x3 path (its plain
    version on the CPU); the JAX side is forced onto its fused Pallas path
    in interpret mode. Both round the conv operands to bf16."""
    from diffuman4d_tpu.models.layers import ResnetBlock2D as J
    from diffuman4d_torch.models.layers import ResnetBlock2D
    from diffuman4d_torch.ops.conv import conv3x3_ok

    shape = (1, 256, 256, 128)
    assert conv3x3_ok(shape, 128)
    x = randn(rng(5), *shape)
    mod = J(128, use_temb=False, eps=1e-6, dtype=jnp.float32)
    monkeypatch.setenv("D4D_PALLAS_CONV", "force")
    p = _init(mod, j(x))
    want = jax.jit(mod.apply)(p, j(x))
    port = load_block(ResnetBlock2D(128, 128, None, 32, 1e-6), p["params"])
    calls = []
    real = layers.conv3x3
    monkeypatch.setattr(layers, "conv3x3", lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        got = port(t(x))
    assert len(calls) == 2  # both GN-SiLU-conv chains went through the fused op
    # bf16 operands: the normalised activation rounds to bf16 on both sides,
    # and the two fp32 GroupNorm statistics differ in their last bits, so a
    # few activations round to neighbouring bf16 values; each such flip moves
    # an output by ~|w| * 2**-8 (outputs ~O(5)). Most elements see none.
    _compare(got, want, atol=3e-2)
    assert np.mean(np.abs(n(got) - n(want)) < 1e-3) > 0.95


def test_downsample_upsample_plain():
    from diffuman4d_tpu.models.layers import Downsample2D as JD
    from diffuman4d_tpu.models.layers import Upsample2D as JU
    from diffuman4d_torch.models.layers import Downsample2D, Upsample2D

    x = randn(rng(6), 2, 7, 6, 8)
    for jm, pm in ((JD(16, dtype=jnp.float32), Downsample2D(8, 16)),
                   (JU(16, dtype=jnp.float32), Upsample2D(8, 16))):
        p = _init(jm, j(x))
        port = load_block(pm, p["params"])
        _compare(port(t(x)), jit_apply(jm)(p, j(x)))


def test_upsample_fused_path(monkeypatch):
    from diffuman4d_tpu.models.layers import Upsample2D as JU
    from diffuman4d_torch.models.layers import Upsample2D

    x = randn(rng(7), 1, 128, 128, 128)
    mod = JU(128, dtype=jnp.float32)
    monkeypatch.setenv("D4D_PALLAS_CONV", "force")
    p = _init(mod, j(x))
    want = jax.jit(mod.apply)(p, j(x))
    port = load_block(Upsample2D(128, 128), p["params"])
    # bf16-rounded operands on both sides, fp32 accumulation over 1152 taps
    _compare(port(t(x)), want, atol=1e-3)


@pytest.mark.parametrize("num_frames", [1, 2])
def test_transformer_block_2d_3d(num_frames):
    from diffuman4d_tpu.models.transformer import MultiviewTransformerBlock as J
    from diffuman4d_torch.models.transformer import MultiviewTransformerBlock

    x = randn(rng(8), 4, 16, 128)
    mod = J(2, 64, dtype=jnp.float32, attn_implementation="xla")
    p = _init(mod, j(x), num_frames=num_frames)
    port = load_block(MultiviewTransformerBlock(128, 2, 64), p["params"])
    want = jit_apply(mod, num_frames=num_frames)(p, j(x))
    with torch.no_grad():
        _compare(port(t(x), num_frames=num_frames), want, atol=2e-4)


@pytest.mark.parametrize("linear", [True, False])
def test_transformer_multiview(linear):
    from diffuman4d_tpu.models.transformer import TransformerMultiview as J
    from diffuman4d_torch.models.transformer import TransformerMultiview

    x = randn(rng(9), 4, 4, 4, 16)
    mod = J(2, 8, norm_groups=4, use_linear_projection=linear, dtype=jnp.float32,
            attn_implementation="xla")
    p = _init(mod, j(x), num_frames=2)
    port = load_block(TransformerMultiview(16, 2, 8, 1, 4, linear), p["params"])
    want = jit_apply(mod, num_frames=2)(p, j(x))
    with torch.no_grad():
        _compare(port(t(x), num_frames=2), want, atol=1e-4)


def test_pose_encoder():
    from diffuman4d_tpu.models.pose_encoder import PoseEncoder as J
    from diffuman4d_torch.io.checkpoints import unet_state_dict_from_flax, load_numpy_state_dict
    from diffuman4d_torch.models.pose_encoder import PoseEncoder

    x = np.clip(randn(rng(10), 2, 32, 32, 3), -1, 1)
    mod = J(8, dtype=jnp.float32)
    p = _init(mod, j(x))
    sd = unet_state_dict_from_flax({"pose_encoder": p["params"]})
    port = PoseEncoder(8)
    load_numpy_state_dict(port, {k[len("pose_encoder."):]: v for k, v in sd.items()})
    with torch.no_grad():
        _compare(port(t(x)), jit_apply(mod)(p, j(x)), atol=1e-4)
