"""SVD's VAE in the port (``models/vae_temporal.py``: the SD encoder and a
temporal decoder) against the plain reference (``benchmark/reference/svd.py``)
at tiny widths, fp32 on the CPU, on the same seeded weights.

Tolerances: fp32 on both sides, the same weights; the sums differ in order
only (GroupNorm's E[x^2] - mean^2 and folded affine, the temporal conv as
three GEMMs, the mix as a lerp), a few ulps through the decoder's ~20
layers: 1e-5 of the largest magnitude (readings ~1e-7)."""

import torch

from diffuman4d_torch.models.vae_temporal import AutoencoderKLTemporalDecoder
from tests.torch_port_svd_setup import models, one_torch_thread, rel_err  # noqa: F401

TOL = 1e-5
F = 5


def test_temporal_decoder_matches_the_reference():
    (_, vae), (_, r_vae) = models()
    assert isinstance(vae, AutoencoderKLTemporalDecoder)
    assert not hasattr(vae, "post_quant_conv")
    z = torch.randn(F, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, want = vae.decode(z, F), r_vae.decode(z, F)
    assert got.shape == want.shape == (F, 64, 64, 3)
    assert rel_err(got, want) < TOL


def test_a_clip_decodes_alone_as_beside_another_clip():
    """Clips side by side in a batch do not mix: each frame of a clip is the
    same decoded alone or beside another clip, and differs when the clip's
    other frames change (the decoder is temporal)."""
    (_, vae), _ = models()
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(F, 8, 8, 4, generator=g), torch.randn(F, 8, 8, 4, generator=g)
    with torch.no_grad():
        both = vae.decode(torch.cat([a, b]), F)
        alone = vae.decode(a, F)
        other = vae.decode(torch.cat([a[:1], b[1:]]), F)
    assert rel_err(both[:F], alone) < 1e-6
    assert rel_err(other[:1], alone[:1]) > 1e-3


def test_encoder_mode_matches_the_reference():
    (_, vae), (_, r_vae) = models()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    with torch.no_grad():
        got, want = vae.encode_mode(x), r_vae.encode_mode(x)
    assert got.shape == (2, 8, 8, 4)
    assert rel_err(got, want) < TOL


def test_the_mix_is_switched_in_the_decoder():
    """``learned`` with the sides switched: ``(1 - sigmoid(m)) * spatial +
    sigmoid(m) * temporal``, from m = 0 at construction."""
    vae = AutoencoderKLTemporalDecoder()
    mixer = vae.decoder.up_blocks[0].resnets[0].time_mixer
    assert float(mixer.mix_factor.detach()) == 0.0
    with torch.no_grad():
        mixer.mix_factor.fill_(2.0)
        xs, xt = torch.ones(1, 2, 2, 1), torch.zeros(1, 2, 2, 1)
        a = torch.sigmoid(torch.tensor(2.0))
        assert torch.allclose(mixer(xs, xt), (1 - a).expand(1, 2, 2, 1))
