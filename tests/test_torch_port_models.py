"""The port's UNet, VAE, scheduler, rays and weight carry against the JAX
package (fp32, CPU, weights carried through the port's numpy weight carry,
inputs and noise from numpy)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    TINY_UNET,
    TINY_VAE,
    j,
    jax_unet,
    jit_apply,
    jax_vae,
    n,
    port_unet,
    port_vae,
    randn,
    rng,
    t,
)

# fp32 end to end on both sides; the residual differences are summation
# order (XLA vs ATen convs/matmuls) compounded over ~40 layers
UNET_ATOL = 2e-4
VAE_ATOL = 2e-4


@pytest.fixture(scope="module")
def tiny_unet():
    mod, params = jax_unet(TINY_UNET)
    return mod, params, port_unet(TINY_UNET, params)


@pytest.mark.parametrize("domain", ["spatial", "temporal"])
def test_unet_matches_jax(tiny_unet, domain):
    mod, params, unet = tiny_unet
    L = 4
    r = rng(3)
    x = randn(r, L, 8, 8, 11)
    sk = np.clip(randn(r, L, 64, 64, 3), -1, 1)
    ts = np.array([0, 981, 500, 21], np.int32)
    tem = (np.tile(np.arange(L // 2), 2) if domain == "temporal"
           else np.zeros(L)).astype(np.int32)
    want = jit_apply(mod, num_frames=L)(params, j(x), jnp.asarray(ts), j(sk), jnp.asarray(tem))
    with torch.no_grad():
        got = unet(t(x), torch.from_numpy(ts), t(sk), torch.from_numpy(tem), num_frames=L)
    assert got.shape == want.shape
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=UNET_ATOL)


def test_unet_pose_features_path(tiny_unet):
    """Precomputed pose features give the same output as skeletons."""
    _, _, unet = tiny_unet
    r = rng(4)
    x, sk = t(randn(r, 2, 8, 8, 11)), t(np.clip(randn(r, 2, 64, 64, 3), -1, 1))
    ts = torch.tensor([10, 700])
    with torch.no_grad():
        a = unet(x, ts, sk, num_frames=2)
        b = unet(x, ts, pose_features=unet.pose_encoder(sk), num_frames=2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_unet_freeu_is_queued():
    """FreeU, once refused, now matches the JAX UNet with the same tuple
    ``(b1, b2, s1, s2)`` (the FreeU paper's SD2.1 values) and changes the
    output."""
    cfg = dict(TINY_UNET, freeu=(1.4, 1.6, 0.9, 0.2))
    mod, params = jax_unet(cfg)
    unet = port_unet(cfg, params)
    L = 4
    r = rng(11)
    x, sk = randn(r, L, 8, 8, 11), np.clip(randn(r, L, 64, 64, 3), -1, 1)
    ts = np.array([0, 981, 500, 21], np.int32)
    tem = np.tile(np.arange(L // 2), 2).astype(np.int32)
    want = jit_apply(mod, num_frames=L)(params, j(x), jnp.asarray(ts), j(sk), jnp.asarray(tem))
    plain = port_unet(TINY_UNET, params)
    with torch.no_grad():
        got = unet(t(x), torch.from_numpy(ts), t(sk), torch.from_numpy(tem), num_frames=L)
        off = plain(t(x), torch.from_numpy(ts), t(sk), torch.from_numpy(tem), num_frames=L)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=UNET_ATOL)
    assert float((got - off).abs().max()) > 1e3 * UNET_ATOL


@pytest.fixture(scope="module")
def tiny_vae():
    mod, params = jax_vae(TINY_VAE)
    return mod, params, port_vae(TINY_VAE, params)


def test_vae_encode_matches_jax(tiny_vae):
    mod, params, vae = tiny_vae
    r = rng(5)
    x = np.clip(randn(r, 2, 64, 64, 3), -1, 1)
    key = jax.random.PRNGKey(7)
    want = jit_apply(mod, method="encode")(params, j(x), key)
    # the same posterior noise, drawn with the key the JAX encode uses
    noise = np.asarray(jax.random.normal(key, want.shape, jnp.float32))
    with torch.no_grad():
        got = vae.encode(t(x), noise=t(noise))
        mean_only = vae.encode(t(x), sample=False)
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=VAE_ATOL)
    want_mean = jit_apply(mod, method="encode", sample=False)(params, j(x))
    np.testing.assert_allclose(n(mean_only), n(want_mean), rtol=0, atol=VAE_ATOL)


def test_vae_decode_matches_jax(tiny_vae):
    mod, params, vae = tiny_vae
    z = randn(rng(6), 2, 8, 8, 4)
    want = jit_apply(mod, method="decode")(params, j(z))
    with torch.no_grad():
        got = vae.decode(t(z))
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=VAE_ATOL)


def test_weight_carry_equals_export(tiny_unet, tiny_vae):
    """The port's carry gives exactly the JAX package's diffusers export,
    key for key and value for value, and loads strictly into the port."""
    from diffuman4d_tpu.io.checkpoints import export_unet_torch_keys, export_vae_torch_keys
    from diffuman4d_torch.io.checkpoints import state_dicts_from_flax

    _, up, unet = tiny_unet
    _, vp, vae = tiny_vae
    u_sd, v_sd = state_dicts_from_flax(up["params"], vp["params"])
    for mine, ref, module in ((u_sd, export_unet_torch_keys(up["params"]), unet),
                              (v_sd, export_vae_torch_keys(vp["params"]), vae)):
        assert set(mine) == set(ref) == set(module.state_dict())
        for k in ref:
            np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(ref[k]), err_msg=k)


def test_full_width_config_carries():
    """At the shipped widths the port's module tree has exactly the keys and
    shapes of the JAX export (shapes only: no full-size forward here)."""
    from diffuman4d_tpu.io.checkpoints import export_unet_torch_keys, export_vae_torch_keys
    from diffuman4d_tpu.models.unet import UNetConfig as JUNetConfig
    from diffuman4d_tpu.models.unet import UNetMultiviewCondition as JUNet
    from diffuman4d_tpu.models.vae import AutoencoderKL as JVAE
    from diffuman4d_tpu.models.vae import VAEConfig as JVAEConfig
    from diffuman4d_torch.models.unet import UNetConfig, UNetMultiviewCondition
    from diffuman4d_torch.models.vae import AutoencoderKL, VAEConfig

    ju = JUNet(JUNetConfig(), dtype=jnp.bfloat16)
    shapes = jax.eval_shape(
        lambda: ju.init(jax.random.PRNGKey(0), jnp.zeros((2, 8, 8, 11)),
                        jnp.zeros((2,), jnp.int32), jnp.zeros((2, 64, 64, 3)), num_frames=2))
    jv = JVAE(JVAEConfig())
    vshapes = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    zeros = lambda tree: jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)  # noqa: E731
    ref_u = export_unet_torch_keys(zeros(shapes["params"]))
    ref_v = export_vae_torch_keys(zeros(vshapes["params"]))
    with torch.device("meta"):
        su = UNetMultiviewCondition(UNetConfig()).state_dict()
        sv = AutoencoderKL(VAEConfig()).state_dict()
    assert {k: tuple(v.shape) for k, v in ref_u.items()} == {k: tuple(v.shape) for k, v in su.items()}
    assert {k: tuple(v.shape) for k, v in ref_v.items()} == {k: tuple(v.shape) for k, v in sv.items()}


@pytest.mark.parametrize("spacing,steps", [("leading", 3), ("leading", 36), ("trailing", 7),
                                           ("linspace", 10)])
def test_scheduler_timesteps_bit_equal(spacing, steps):
    from diffuman4d_tpu.schedulers.diffusion import Scheduler as JS
    from diffuman4d_tpu.schedulers.diffusion import SchedulerConfig as JC
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig

    js = JS(JC(kind="ddim", timestep_spacing=spacing)).set_timesteps(steps)
    ps = Scheduler(SchedulerConfig(kind="ddim", timestep_spacing=spacing)).set_timesteps(steps)
    np.testing.assert_array_equal(ps.timesteps.numpy(), np.asarray(js.timesteps))
    np.testing.assert_array_equal(ps.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    assert ps.final_alpha_cumprod == float(js.final_alpha_cumprod)
    assert ps.init_noise_sigma == float(js.init_noise_sigma)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_step_matches_jax(eta):
    from diffuman4d_tpu.schedulers.diffusion import Scheduler as JS
    from diffuman4d_tpu.schedulers.diffusion import SchedulerConfig as JC
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig

    js = JS(JC(kind="ddim", ddim_eta=eta)).set_timesteps(3)
    ps = Scheduler(SchedulerConfig(kind="ddim", ddim_eta=eta)).set_timesteps(3)
    r = rng(8)
    x, eps = randn(r, 6, 4, 4, 4), randn(r, 6, 4, 4, 4)
    idx = np.array([0, 1, 2, 0, 1, 2], np.int32)
    is_cond = np.array([True, False, False, True, False, False])
    key = jax.random.PRNGKey(3)
    want = js.step(j(eps), jnp.asarray(idx), j(x), key=key, mask=jnp.asarray(~is_cond))
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    got = ps.step(t(eps), torch.from_numpy(idx), t(x), mask=torch.from_numpy(~is_cond),
                  noise=t(noise))
    # fp32 elementwise math on both sides: only rounding-order differences
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        n(ps.timestep_of(torch.from_numpy(idx), torch.from_numpy(is_cond))),
        np.asarray(js.timestep_of(jnp.asarray(idx), jnp.asarray(is_cond))))


@pytest.mark.parametrize("kind", ["ddpm", "euler", "dpm++"])
def test_other_schedulers_are_queued(kind):
    """The kinds once refused build now, at the demo_4d step count: their
    timesteps, initial noise scale and one step from the same inputs match
    the JAX package's (DDPM with explicit noise; DPM++ with its history).
    The whole trajectories are in test_torch_port_schedulers.py."""
    from diffuman4d_tpu.schedulers.diffusion import Scheduler as JS
    from diffuman4d_tpu.schedulers.diffusion import SchedulerConfig as JC
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig

    steps = 24
    js = JS(JC(kind=kind)).set_timesteps(steps)
    ps = Scheduler(SchedulerConfig(kind=kind)).set_timesteps(steps)
    np.testing.assert_array_equal(n(ps.timesteps), np.asarray(js.timesteps, np.float32))
    assert np.float32(ps.init_noise_sigma) == np.float32(js.init_noise_sigma)
    r = rng(12)
    x, eps, noise = randn(r, 4, 4, 4, 4), randn(r, 4, 4, 4, 4), randn(r, 4, 4, 4, 4)
    idx = np.array([0, 5, 11, 23], np.int32)
    mask = np.array([False, True, True, True])
    if kind == "dpm++":
        aux = {"prev_x0": randn(r, 4, 4, 4, 4), "has_prev": np.array([True, False, True, True])}
        want, _ = js.step_with_aux(j(eps), jnp.asarray(idx), j(x),
                                   {"prev_x0": j(aux["prev_x0"]),
                                    "has_prev": jnp.asarray(aux["has_prev"])},
                                   mask=jnp.asarray(mask))
        got, _ = ps.step_with_aux(t(eps), torch.from_numpy(idx), t(x),
                                  {"prev_x0": t(aux["prev_x0"]),
                                   "has_prev": torch.from_numpy(aux["has_prev"])},
                                  mask=torch.from_numpy(mask))
    else:
        kw = {"noise": noise} if kind == "ddpm" else {}
        want = js.step(j(eps), jnp.asarray(idx), j(x), mask=jnp.asarray(mask),
                       **{k: j(v) for k, v in kw.items()})
        got = ps.step(t(eps), torch.from_numpy(idx), t(x), mask=torch.from_numpy(mask),
                      **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_rays_match_jax():
    from diffuman4d_tpu.data import rays as jr
    from diffuman4d_torch.data import rays as pr

    r = rng(9)
    B = 3
    K = np.tile(np.array([[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]], np.float32), (B, 1, 1))
    K[:, 0, 0] += randn(r, B) * 5
    poses = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    ang = randn(r, B)
    poses[:, 0, 0], poses[:, 0, 2] = np.cos(ang), np.sin(ang)
    poses[:, 2, 0], poses[:, 2, 2] = -np.sin(ang), np.cos(ang)
    poses[:, :3, 3] = randn(r, B, 3) * 2
    want = jr.calc_plucker_embeds_lowres(64, 64, j(K), j(poses), 8, 8)
    got = pr.calc_plucker_embeds_lowres(64, 64, t(K), t(poses), 8, 8)
    # fp32 matrix inverses and cross products: single-precision rounding
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=2e-5)
    np.testing.assert_allclose(n(pr.calc_relative_poses(t(poses))),
                               n(jr.calc_relative_poses(j(poses))), rtol=0, atol=2e-5)
