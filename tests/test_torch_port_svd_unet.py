"""SVD's spatio-temporal UNet in the port (``models/unet_spatiotemporal.py``)
against the plain reference (``benchmark/reference/svd.py``) at tiny widths,
fp32 on the CPU, on the same seeded weights: a spatio-temporal resnet, a
spatio-temporal transformer, and the whole UNet over two clips of 4 frames.

Tolerances: both sides compute in fp32 with the same weights; they differ in
the order of sums only (the port's GroupNorm takes the variance as E[x^2] -
mean^2 and applies a folded affine, its temporal conv is three GEMMs where
the reference calls conv3d, its mix is a lerp), so the largest difference
is a few fp32 ulps of the largest output, amplified through a dozen layers:
1e-5 of the largest magnitude holds with a wide margin (readings ~1e-7)."""

import torch

from benchmark.reference import models as ref_models
from diffuman4d_torch.models.unet_spatiotemporal import (
    SpatioTemporalResBlock,
    TransformerSpatioTemporalModel,
    temporal_conv,
)
from tests.torch_port_svd_setup import models, one_torch_thread, rel_err  # noqa: F401

TOL = 1e-5
F = 4


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_whole_unet_matches_the_reference_over_two_clips():
    (unet, _), (r_unet, _) = models()
    g = _gen()
    x = torch.randn(2 * F, 8, 8, 8, generator=g)
    t = torch.randn(2 * F, generator=g)
    ctx = torch.randn(2, 1, 16, generator=g)
    ids = torch.tensor([[6.0, 127.0, 0.02], [6.0, 127.0, 0.02]])
    with torch.no_grad():
        got = unet(x, t, ctx, ids, F)
        want = r_unet(x, t, ctx, ids, F)
    assert got.shape == want.shape == (2 * F, 8, 8, 4)
    assert rel_err(got, want) < TOL
    # the clips do not mix: the second alone gives its rows
    with torch.no_grad():
        alone = unet(x[F:], t[F:], ctx[1:], ids[1:], F)
    assert rel_err(alone, got[F:]) < TOL


def test_spatio_temporal_resnet_block_matches_the_reference():
    (unet, _), (r_unet, _) = models()
    blk, r_blk = unet.down_blocks[1].resnets[0], r_unet.down_blocks[1].resnets[0]
    assert isinstance(blk, SpatioTemporalResBlock)
    g = _gen(1)
    x = torch.randn(2 * F, 4, 4, 8, generator=g)
    temb = torch.randn(2 * F, 32, generator=g)
    with torch.no_grad():
        assert rel_err(blk(x, temb, F), r_blk(x, temb, F)) < TOL


def test_spatio_temporal_transformer_matches_the_reference():
    (unet, _), (r_unet, _) = models()
    blk, r_blk = unet.down_blocks[0].attentions[0], r_unet.down_blocks[0].attentions[0]
    assert isinstance(blk, TransformerSpatioTemporalModel)
    g = _gen(2)
    x = torch.randn(2 * F, 4, 4, 8, generator=g)
    ctx = torch.randn(2, 1, 16, generator=g)
    with torch.no_grad():
        assert rel_err(blk(x, ctx, F), r_blk(x, ctx, F)) < TOL


def test_temporal_groupnorm_spans_every_frame_of_a_clip():
    """Statistics per (clip, group) over every frame's pixels: one frame
    scaled up moves the other frames' outputs of its clip only."""
    (unet, _), _ = models()
    norm = unet.down_blocks[0].resnets[0].temporal_res_block.norm1
    x = torch.randn(2 * F, 4, 4, 8, generator=_gen(3))
    y = norm(x.reshape(2, F * 4, 4, 8)).reshape(x.shape)
    x2 = x.clone()
    x2[0] *= 5.0
    y2 = norm(x2.reshape(2, F * 4, 4, 8)).reshape(x.shape)
    assert not torch.allclose(y[1:F], y2[1:F])
    assert torch.equal(y[F:], y2[F:])


def test_temporal_conv_is_the_reference_conv3d_with_its_taps_in_order():
    conv = torch.nn.Conv3d(6, 5, (3, 1, 1), padding=(1, 0, 0))
    x = torch.randn(2 * F, 3, 3, 6, generator=_gen(4))
    with torch.no_grad():
        got = temporal_conv(conv, x, F)
        from benchmark.reference.svd import temporal_conv as ref_conv
        want = ref_conv(ref_models.Prec(), conv, x, F)
        assert rel_err(got, want) < TOL
        # the taps reversed is another function
        flipped = torch.nn.Conv3d(6, 5, (3, 1, 1), padding=(1, 0, 0))
        flipped.weight.copy_(conv.weight.flip(2))
        flipped.bias.copy_(conv.bias)
        assert rel_err(temporal_conv(flipped, x, F), want) > 1e-2


def test_state_dict_keys_are_the_references_and_the_published_names():
    (unet, vae), (r_unet, r_vae) = models()
    assert list(unet.state_dict()) == list(dict(r_unet.named_parameters()))
    assert set(vae.state_dict()) == set(dict(r_vae.named_parameters()))
    keys = set(unet.state_dict())
    for k in ("down_blocks.0.resnets.0.temporal_res_block.conv1.weight",
              "down_blocks.0.resnets.0.time_mixer.mix_factor",
              "down_blocks.0.attentions.0.temporal_transformer_blocks.0.ff_in.net.0.proj.weight",
              "down_blocks.0.attentions.0.time_pos_embed.linear_2.weight",
              "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight",
              "add_embedding.linear_1.weight", "up_blocks.1.attentions.1.time_mixer.mix_factor"):
        assert k in keys, k
    assert unet.state_dict()["down_blocks.0.resnets.0.temporal_res_block.conv1.weight"].shape \
        == (8, 8, 3, 1, 1)
    assert unet.state_dict()[
        "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight"].shape == (8, 16)


def test_published_widths_hold_1_52_billion_parameters():
    from diffuman4d_torch.models.unet_spatiotemporal import (
        SVDUNetConfig,
        UNetSpatioTemporalConditionModel,
    )
    with torch.device("meta"):
        unet = UNetSpatioTemporalConditionModel(SVDUNetConfig())
    n = sum(p.numel() for p in unet.parameters())
    assert 1.52e9 < n < 1.53e9
