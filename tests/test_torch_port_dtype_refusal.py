"""The loader refuses, before it loads anything, a compute dtype that the
card's attention kernels cannot take (``ROADMAP.md`` C.24).

On a CUDA device, attention ``auto`` or ``pallas`` runs the port's wgmma
kernels, which take bf16 only; the JAX package's Pallas kernels take any
dtype, so this is a deliberate deviation. The check takes the device as a
string, so it runs here without a card.
"""

from __future__ import annotations

import pytest

from diffuman4d_torch.configs.presets import DataConfig, ModelConfig, SamplerConfig
from diffuman4d_torch.sampling import loader


@pytest.mark.parametrize("device,dtype,attn", [
    ("cuda", "fp32", "auto"), ("cuda", "fp32", "pallas"), ("cuda:0", "fp32", "auto"),
    ("cuda", "fp16", "pallas")])
def test_kernel_attention_refuses_other_dtypes_on_the_card(device, dtype, attn):
    with pytest.raises(ValueError, match="model.dtype=bf16"):
        loader.check_attention_dtype(device, dtype, attn)


@pytest.mark.parametrize("device,dtype,attn", [
    ("cuda", "bf16", "auto"), ("cuda:0", "bf16", "pallas"), ("cuda", "fp32", "math"),
    ("cuda", "fp32", "xla"), ("cpu", "fp32", "auto"), ("cpu", "fp32", "pallas"),
    ("cpu", "bf16", "auto")])
def test_check_passes_bf16_plain_attention_and_the_cpu(device, dtype, attn):
    loader.check_attention_dtype(device, dtype, attn)


@pytest.mark.parametrize("attn", ["auto", "pallas"])
@pytest.mark.parametrize("with_checkpoint", [False, True])
def test_load_pipeline_refuses_fp32_on_the_card_before_loading(tmp_path, monkeypatch, attn,
                                                               with_checkpoint):
    """Both branches of ``load_pipeline`` (random weights, a diffusers
    directory) raise at once: neither builds a model nor reads a file."""
    from diffuman4d_torch.io import checkpoints

    def refuse(*a, **k):
        raise AssertionError("load_pipeline loaded something before refusing")

    for mod, name in ((loader, "build_models"), (loader, "_empty_models"),
                      (checkpoints, "load_hf_checkpoint")):
        monkeypatch.setattr(mod, name, refuse)
    model_dir = tmp_path / "model"
    if with_checkpoint:
        (model_dir / "unet").mkdir(parents=True)
    cfg = ModelConfig(model_dir=str(model_dir), arch="tiny", dtype="fp32",
                      attn_implementation=attn)
    with pytest.raises(ValueError, match="model.dtype=bf16"):
        loader.load_pipeline(cfg, SamplerConfig(), DataConfig(height=64, width=64),
                             device="cuda")
