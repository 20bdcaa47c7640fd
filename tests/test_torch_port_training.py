"""The port's training path against the JAX package, on the CPU in fp32 at
tiny widths: ``diffusion_loss`` and its gradients, two AdamW steps with
clipping, the host EMA, and the loop with resume. Weights, batches, timesteps
and noise come from numpy / the JAX keys and are handed to both sides; flax
gradients and optax moments go through the port's weight carry so they are
compared key by key. The port's attention runs ``implementation="train"``
(its plain version on the CPU), the JAX side its XLA attention."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tests import torch_port_training_setup as ts
from tests.torch_port_helpers import TINY_UNET, jax_unet, one_torch_thread  # noqa: F401

B, L, LAT = ts.B, ts.L, ts.LAT
models = ts.models


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("domain,prediction,remat", [
    ("spatial", "epsilon", False), ("temporal", "v_prediction", True),
    ("spatial", "v_prediction", True), ("temporal", "epsilon", False)])
def test_diffusion_loss_and_gradients_match_jax(models, domain, prediction, remat):
    from diffuman4d_tpu.schedulers import diffusion as jd
    from diffuman4d_tpu.training import trainer as jt
    from diffuman4d_torch.io.checkpoints import grads_from_flax
    from diffuman4d_torch.schedulers import diffusion as pd
    from diffuman4d_torch.training import trainer as pt

    jmod, jparams = models
    batch, key = ts.batch(1), jax.random.PRNGKey(7)
    jcfg = jt.TrainConfig(prediction_type=prediction, remat=False, attn_implementation=None)
    jsched = jd.Scheduler(jd.SchedulerConfig())
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jt.diffusion_loss(
        jmod, jsched, jcfg, {"params": p}, ts.jbatch(batch), key, domain)))(jparams["params"])

    unet = ts.port_model(jparams)
    cfg = pt.TrainConfig(prediction_type=prediction, remat=remat)
    tt, eps = ts.jax_draw(key)
    with unet.configured(attn_implementation="train"):
        loss = pt.diffusion_loss(unet, pd.Scheduler(pd.SchedulerConfig()), cfg, ts.tbatch(batch),
                                 domain, t=tt, eps=eps)
        loss.backward()
    assert unet.remat is False and unet.attn_implementation == "auto"  # restored
    # fp32 both sides, same inputs: summation order only
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = grads_from_flax(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in unet.named_parameters()}
    assert all(g is not None for g in got.values())
    ts.assert_by_key(got, want, 1e-4, f"gradients {domain}/{prediction}/remat={remat}", floor=1e-6)


def test_diffusion_loss_draws_from_a_generator_and_checks_arguments():
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.training import trainer as pt

    _, jparams = jax_unet(TINY_UNET, num_frames=L, latent=LAT)
    unet, sched, batch = ts.port_model(jparams), Scheduler(SchedulerConfig()), ts.tbatch(ts.batch(2))
    cfg = pt.TrainConfig(remat=False)
    with torch.no_grad():
        a = pt.diffusion_loss(unet, sched, cfg, batch, "spatial",
                              generator=torch.Generator().manual_seed(3))
        b = pt.diffusion_loss(unet, sched, cfg, batch, "spatial",
                              generator=torch.Generator().manual_seed(3))
        c = pt.diffusion_loss(unet, sched, cfg, batch, "spatial",
                              generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a)
    with pytest.raises(ValueError):
        pt.diffusion_loss(unet, sched, cfg, batch, "spatial")
    with pytest.raises(ValueError):
        pt.diffusion_loss(unet, sched, pt.TrainConfig(prediction_type="sample", remat=False),
                          batch, "spatial", generator=torch.Generator().manual_seed(3))
