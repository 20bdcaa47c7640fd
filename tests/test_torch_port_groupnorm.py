"""The GroupNorm routine of ``diffuman4d_torch/ops/groupnorm.py`` on the CPU.

Its plain versions hold the arithmetic that the port's ``groupnorm_affine``
has always run and apply it as the normalisation, within fp32 rounding of the
old ``GroupNorm`` (both copied here as they were); a
plain-PyTorch mirror of the CUDA pair's two-stage reduction (per-chunk,
per-channel fp32 partials, group totals in double, the folded affine, SiLU
before the one rounding) is held to them; and the dispatch is checked on
meta tensors, which take the kernel route without a card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffuman4d_torch.models.layers import GroupNorm
from diffuman4d_torch.ops import groupnorm as gn
from diffuman4d_torch.utils.tracing import counters

# channels a group in the models: the VAE's 128 / 256 / 512, the UNet's 320 /
# 640 / 1,280 and its up blocks' concatenations (960, 1,920, 2,560), 32 groups
CPG = (4, 8, 16, 10, 20, 30, 40, 60, 80)
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed: int, B: int, H: int, W: int, C: int, dtype):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((B, H, W, C)).astype(np.float32) * 2 + 0.5)
    w = torch.from_numpy(1 + 0.2 * r.standard_normal(C).astype(np.float32))
    b = torch.from_numpy(0.2 * r.standard_normal(C).astype(np.float32))
    return x.to(dtype), w.to(dtype), b.to(dtype)


def _groupnorm_before(x, weight, bias, groups, eps):
    """``GroupNorm.forward`` as the port ran it before the routine."""
    B, H, W, C = x.shape
    xg = x.float().reshape(B, H * W, groups, C // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg.square().mean(dim=(1, 3), keepdim=True) - mean.square()).clamp(min=0.0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def _affine_before(x, gamma, beta, groups, eps):
    """``ops/conv.py``'s ``groupnorm_affine`` as it was before the routine."""
    B, H, W, C = x.shape
    xf = x.float()
    s1 = xf.mean(dim=(1, 2))
    s2 = xf.square().mean(dim=(1, 2))
    mean = s1.reshape(B, groups, -1).mean(dim=-1)
    var = s2.reshape(B, groups, -1).mean(dim=-1) - mean.square()
    rstd = torch.rsqrt(var + eps)
    rep = rstd.repeat_interleave(C // groups, dim=1)
    mrep = mean.repeat_interleave(C // groups, dim=1)
    scale = rep * gamma.float()[None, :]
    shift = beta.float()[None, :] - mrep * scale
    return scale, shift


def kernel_mirror(x, weight, bias, groups, eps, silu, sms=H100_SMS):
    """The CUDA pair's arithmetic in plain PyTorch: ``n_chunks`` chunks of
    ceil(HW / chunks) pixels per image, fp32 per-channel sums and sums of
    squares per chunk, the group's chunks and channels totalled in double,
    mean and E[x^2] - mean^2 in double, rstd rounded to fp32, the folded fp32
    affine, SiLU in fp32 and one rounding to x's dtype."""
    B, H, W, C = x.shape
    HW, cpg = H * W, C // groups
    nch = gn.n_chunks(B, HW, sms)
    chunk = -(-HW // nch)
    xf = F.pad(x.float().reshape(B, HW, C), (0, 0, 0, nch * chunk - HW))
    xf = xf.reshape(B, nch, chunk, C)
    partial = torch.stack([xf.sum(2), xf.square().sum(2)], dim=2)  # (B, nch, 2, C) fp32
    tot = partial.double().reshape(B, nch, 2, groups, cpg).sum(dim=(1, 4))  # (B, 2, G)
    n = HW * cpg
    mean = tot[:, 0] / n
    var = (tot[:, 1] / n - mean.square()).clamp(min=0.0)
    rstd = (1.0 / torch.sqrt(var + eps)).float()
    scale = rstd.repeat_interleave(cpg, dim=1) * weight.float()
    shift = bias.float() - mean.float().repeat_interleave(cpg, dim=1) * scale
    y = x.float() * scale[:, None, None] + shift[:, None, None]
    if silu:
        y = F.silu(y)
    return (scale, shift), y.to(x.dtype)


def _tol(dtype) -> float:
    # bf16: the plain version rounds the affine's output and SiLU's, the
    # mirror once; fp32: sums in another order and precision
    return 2 ** -5 if dtype == torch.bfloat16 else 1e-5


@pytest.mark.parametrize("cpg", CPG)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("silu", [False, True])
def test_plain_path_is_the_arithmetic_of_before(cpg, dtype, silu):
    """On the CPU the routine's statistics are the port's old
    ``groupnorm_affine`` bit for bit, and its output is that affine applied in
    fp32 (then SiLU in x's dtype, as the call sites applied it), bit for bit,
    through the module and the routine: the old GroupNorm within fp32 rounding
    (one bf16 ulp where the fp32 value sits at a rounding boundary)."""
    C = 32 * cpg
    x, w, b = _inputs(cpg, 2, 3, 5, C, dtype)
    for got, ref in zip(gn.groupnorm_affine(x, w, b, 32, 1e-6),
                        _affine_before(x, w, b, 32, 1e-6)):
        assert torch.equal(got, ref)
    scale, shift = _affine_before(x, w, b, 32, 1e-5)
    want = (x.float() * scale[:, None, None] + shift[:, None, None]).to(dtype)
    want = F.silu(want) if silu else want
    norm = GroupNorm(C, 32, 1e-5)
    with torch.no_grad():
        norm.weight.copy_(w.float())
        norm.bias.copy_(b.float())
    norm = norm.to(dtype)
    assert torch.equal(norm(x, silu=silu), want)
    assert torch.equal(gn.group_norm(x, w, b, 32, 1e-5, silu=silu), want)
    before = _groupnorm_before(x, w, b, 32, 1e-5)
    before = (F.silu(before) if silu else before).float()
    tol = 2 ** -7 if dtype == torch.bfloat16 else 2e-6
    assert ((want.float() - before).abs() <= tol * before.abs().clamp_min(1.0)).all()


@pytest.mark.parametrize("cpg", CPG)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("silu", [False, True])
def test_kernel_mirror_agrees_with_the_plain_version(cpg, dtype, silu):
    """The two-stage reduction (chunks ragged: 7 x 9 pixels do not split
    evenly) gives the plain version's affine within fp32 rounding and its
    output within bf16 rounding."""
    C = 32 * cpg
    x, w, b = _inputs(100 + cpg, 3, 7, 9, C, dtype)
    (scale, shift), y = kernel_mirror(x, w, b, 32, 1e-5, silu)
    ws, wsh = gn.groupnorm_affine_plain(x, w, b, 32, 1e-5)
    torch.testing.assert_close(scale, ws, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(shift, wsh, rtol=1e-5, atol=1e-5)
    want = gn.group_norm_plain(x, w, b, 32, 1e-5, silu).float()
    assert ((y.float() - want).abs() <= _tol(dtype) * want.abs().clamp_min(1.0)).all()


def test_kernel_mirror_keeps_a_large_mean():
    """E[x^2] - mean^2 with the mean 30 standard deviations off zero: the
    double totals keep the variance where the plain fp32 means do."""
    x, w, b = _inputs(7, 2, 16, 16, 320, torch.float32)
    x = x + 60.0
    (scale, shift), y = kernel_mirror(x, w, b, 32, 1e-5, True)
    want = gn.group_norm_plain(x, w, b, 32, 1e-5, True)
    assert ((y - want).abs() <= 1e-3 * want.abs().clamp_min(1.0)).all()


def test_silu_flag_equals_silu_of_the_norm():
    """``GroupNorm(silu=True)`` is ``F.silu(GroupNorm(x))``: exactly on the
    plain path, within bf16 rounding on the kernels' (SiLU before the one
    rounding)."""
    x, w, b = _inputs(3, 2, 4, 6, 320, torch.bfloat16)
    norm = GroupNorm(320, 32).to(torch.bfloat16)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
        want = F.silu(norm(x))
        assert torch.equal(norm(x, silu=True), want)
        _, y = kernel_mirror(x, w, b, 32, 1e-5, True)
    want = want.float()
    assert ((y.float() - want).abs() <= 2 ** -5 * want.abs().clamp_min(1.0)).all()
    assert (y.float() != want).any()  # one rounding fewer changes some values


@pytest.mark.parametrize("B,HW", [(2, 1024 * 1024), (32, 16 * 16), (32, 128 * 128), (24, 64 * 64),
                                  (1, 1), (3, 20)])
def test_chunks_fill_the_card_and_cover_the_image(B, HW):
    """At least two blocks per SM at B2 x 1024^2 as at B32 x 16^2; chunks of
    at least MIN_CHUNK_PX pixels unless the image is smaller; never more
    chunks than pixels."""
    nch = gn.n_chunks(B, HW, H100_SMS)
    assert 1 <= nch <= HW
    chunk = -(-HW // nch)
    assert nch * chunk >= HW and (chunk >= gn.MIN_CHUNK_PX or nch == 1)
    if HW >= 256:
        assert B * nch >= 2 * H100_SMS


def _recording(monkeypatch):
    calls = []

    def stats(x, weight, bias, groups, eps):
        calls.append(("stats", groups, eps))
        return (torch.empty(x.shape[0], x.shape[-1], device=x.device),) * 2

    def apply(x, scale, shift, *, silu=False):
        calls.append(("apply", silu))
        return torch.empty_like(x)

    monkeypatch.setattr(gn, "groupnorm_stats", stats)
    monkeypatch.setattr(gn, "groupnorm_apply", apply)
    return calls


def test_dispatch_routes_by_device_and_grad(monkeypatch):
    """A tensor off the CPU (a meta tensor stands in for a CUDA one) takes
    the kernel pair, whatever its size, unless grad is enabled and x, weight
    or bias requires grad; each call counts once as kernel or plain."""
    calls = _recording(monkeypatch)
    norm = GroupNorm(64, 32).to("meta")
    x = torch.empty(2, 4, 4, 64, device="meta")
    before = counters()

    def delta(name):
        return counters().get(name, 0) - before.get(name, 0)

    with torch.no_grad():
        y = norm(x, silu=True)
        gn.groupnorm_affine(x, norm.weight, norm.bias, 32, 1e-6)
    assert y.shape == x.shape
    assert calls == [("stats", 32, 1e-5), ("apply", True), ("stats", 32, 1e-6)]
    assert delta("groupnorm/kernel") == 2 and delta("groupnorm/plain") == 0
    norm(x)  # grad enabled, the weights require it: the eager path
    norm.requires_grad_(False)
    norm(x.requires_grad_())  # x requires it
    assert len(calls) == 3
    assert delta("groupnorm/kernel") == 2 and delta("groupnorm/plain") == 2
    norm(x.detach())  # grad enabled, nothing requires it: the kernels
    assert calls[3:] == [("stats", 32, 1e-5), ("apply", False)]
    GroupNorm(64, 32)(torch.zeros(1, 2, 2, 64))  # the CPU: plain
    assert len(calls) == 5 and delta("groupnorm/plain") == 3


def test_fused_resnet_and_vae_take_their_statistics_from_the_routine(monkeypatch):
    """The fused conv path's GroupNorm statistics come from the routine
    (``groupnorm_affine``); the plain resnet path and the VAE's last norm pass
    ``silu=True`` instead of applying SiLU after the norm."""
    from diffuman4d_torch.models import layers

    seen = []
    real_norm, real_affine = layers.group_norm, layers.groupnorm_affine
    monkeypatch.setattr(layers, "group_norm",
                        lambda *a, **k: seen.append(("norm", k["silu"])) or real_norm(*a, **k))
    monkeypatch.setattr(layers, "groupnorm_affine",
                        lambda *a, **k: seen.append(("affine",)) or real_affine(*a, **k))
    block = layers.ResnetBlock2D(8, 8, None, 4)
    with torch.no_grad():
        block(torch.randn(1, 3, 3, 8))
    assert seen == [("norm", True), ("norm", True)]
    seen.clear()
    monkeypatch.setattr(layers, "conv3x3_ok", lambda *a: True)
    monkeypatch.setattr(layers, "conv3x3", lambda x, w, b, *a, **k: torch.zeros(
        x.shape[:3] + (w.shape[0],)))
    with torch.no_grad():
        block(torch.randn(1, 3, 3, 8))
    assert seen == [("affine",), ("affine",)]
