"""The port's DDPM, Euler and DPM-Solver++ (2M) schedulers against the JAX
package's (modelled on ``tests/test_schedulers.py`` and
``tests/test_scheduler_ab_diffusers.py``): timesteps, sigmas, the initial
noise scale, the model-input scale and whole trajectories of per-row steps
with masked rows, the DPM++ history beside them, every spacing, fp32 on the
CPU, inputs from numpy with a seed."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import j, n, randn, rng, t

# fp32 elementwise math on both sides: rounding order only, a few ulps of
# values up to ~15 (x0 divides by sqrt(alpha_bar) at high t), as the DDIM
# parity test in test_torch_port_models.py bounds it
ATOL = RTOL = 1e-6
SPACINGS = ["leading", "trailing", "linspace"]


def _pair(kind: str, steps: int, **cfg):
    from diffuman4d_tpu.schedulers.diffusion import Scheduler as JS
    from diffuman4d_tpu.schedulers.diffusion import SchedulerConfig as JC
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig

    return (JS(JC(kind=kind, **cfg)).set_timesteps(steps),
            Scheduler(SchedulerConfig(kind=kind, **cfg)).set_timesteps(steps))


@pytest.mark.parametrize("spacing", SPACINGS)
@pytest.mark.parametrize("kind,steps", [("ddpm", 10), ("euler", 7), ("euler", 36),
                                        ("dpm++", 12), ("dpm++", 36)])
def test_tables_match_jax(kind, steps, spacing):
    js, ps = _pair(kind, steps, timestep_spacing=spacing)
    np.testing.assert_array_equal(n(ps.timesteps) if kind == "euler" else ps.timesteps.numpy(),
                                  np.asarray(js.timesteps))
    if kind == "euler":
        np.testing.assert_array_equal(ps.timesteps.dtype, torch.float32)
        np.testing.assert_array_equal(n(ps.sigmas), np.asarray(js.sigmas))
        assert ps.sigmas[-1] == 0
    assert np.float32(ps.init_noise_sigma) == np.float32(js.init_noise_sigma)
    r = rng(1)
    x = randn(r, 5, 4, 4, 4)
    idx = np.array([0, 1, 2, steps - 1, steps], np.int32)
    np.testing.assert_allclose(n(ps.scale_model_input(t(x), torch.from_numpy(idx))),
                               np.asarray(js.scale_model_input(j(x), jnp.asarray(idx))),
                               rtol=RTOL, atol=ATOL)


def _trajectory_inputs(seed: int, steps: int):
    """Six rows at staggered indices (two of them conditional), a model
    output per step."""
    r = rng(seed)
    x = randn(r, 6, 4, 4, 4)
    eps = [randn(r, 6, 4, 4, 4) for _ in range(steps)]
    idx0 = np.array([0, 0, 1, 0, 2, 0], np.int32)
    is_cond = np.array([True, False, False, True, False, False])
    return r, x, eps, idx0, is_cond


@pytest.mark.parametrize("spacing", SPACINGS)
@pytest.mark.parametrize("kind,extra", [
    ("euler", {}), ("euler", {"prediction_type": "v_prediction"}),
    ("euler", {"prediction_type": "sample"}),
    ("ddpm", {"variance_type": "fixed_small"}), ("ddpm", {"variance_type": "fixed_large"}),
    ("ddpm", {"prediction_type": "v_prediction", "clip_sample": True}),
], ids=lambda v: v if isinstance(v, str) else "-".join(map(str, v.values())) or "eps")
def test_single_step_trajectory_matches_jax(kind, extra, spacing):
    steps = 6
    js, ps = _pair(kind, steps, timestep_spacing=spacing, **extra)
    r, x, eps, idx, is_cond = _trajectory_inputs(2, steps)
    jx = j(x)
    mask = ~is_cond
    for k in range(steps):
        noise = randn(r, *x.shape) if kind == "ddpm" else None
        # each step from the JAX side's state: no drift carried over
        px = ps.step(t(eps[k]), torch.from_numpy(idx), t(jx), mask=torch.from_numpy(mask),
                     noise=None if noise is None else t(noise))
        jx = js.step(j(eps[k]), jnp.asarray(idx), jx, mask=jnp.asarray(mask),
                     noise=None if noise is None else j(noise))
        np.testing.assert_allclose(n(px), np.asarray(jx), rtol=RTOL, atol=ATOL, err_msg=f"step {k}")
        np.testing.assert_array_equal(n(px)[is_cond], x[is_cond])  # masked rows pass through
        np.testing.assert_array_equal(
            n(ps.timestep_of(torch.from_numpy(idx), torch.from_numpy(is_cond))),
            np.asarray(js.timestep_of(jnp.asarray(idx), jnp.asarray(is_cond))))
        idx = idx + mask.astype(np.int32)


@pytest.mark.parametrize("spacing", SPACINGS)
@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_dpmpp_trajectory_and_history_match_jax(pred, spacing):
    steps = 6
    js, ps = _pair("dpm++", steps, timestep_spacing=spacing, prediction_type=pred)
    assert js.has_aux and ps.has_aux
    _, x, eps, idx, is_cond = _trajectory_inputs(3, steps + 2)
    jaux, paux = js.init_aux(x.shape), ps.init_aux(x.shape)
    assert paux["prev_x0"].dtype == torch.float32 and paux["has_prev"].dtype == torch.bool
    jx = j(x)
    mask = ~is_cond
    for k in range(steps):
        # each step from the JAX side's state (no drift carried over), and
        # one target sits out each step: its latent and its history stay
        m = mask & (np.arange(6) != 1 + k % 3)
        px = t(jx)
        paux = {"prev_x0": t(jaux["prev_x0"]),
                "has_prev": torch.from_numpy(np.array(jaux["has_prev"]))}
        jx, jaux = js.step_with_aux(j(eps[k]), jnp.asarray(idx), jx, jaux, mask=jnp.asarray(m))
        got, got_aux = ps.step_with_aux(t(eps[k]), torch.from_numpy(idx), px, paux,
                                        mask=torch.from_numpy(m))
        np.testing.assert_allclose(n(got), np.asarray(jx), rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {k}")
        np.testing.assert_allclose(n(got_aux["prev_x0"]), np.asarray(jaux["prev_x0"]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got_aux["has_prev"].numpy(), np.asarray(jaux["has_prev"]))
        np.testing.assert_array_equal(n(got_aux["prev_x0"])[~m], n(paux["prev_x0"])[~m])
        np.testing.assert_array_equal(n(got)[~m], n(px)[~m])
        np.testing.assert_array_equal(got_aux["has_prev"].numpy(), paux["has_prev"].numpy() | m)
        idx = idx + m.astype(np.int32)
    assert bool(got_aux["has_prev"][~is_cond].all()) and not got_aux["has_prev"][is_cond].any()


def test_dpmpp_last_step_returns_x0():
    _, ps = _pair("dpm++", 4)
    r = rng(4)
    x, eps = t(randn(r, 2, 4, 4, 4)), t(randn(r, 2, 4, 4, 4))
    idx = torch.tensor([3, 3])
    aux = ps.init_aux(x.shape)
    out, aux = ps.step_with_aux(eps, idx, x, aux)
    a = ps.alphas_cumprod[ps.timesteps[3]]
    torch.testing.assert_close(out, (x - torch.sqrt(1 - a) * eps) / torch.sqrt(a))
    torch.testing.assert_close(aux["prev_x0"], out)


@pytest.mark.parametrize("kind", ["ddim", "ddpm", "euler"])
def test_single_step_kinds_pass_history_through(kind):
    js, ps = _pair(kind, 3)
    assert not ps.has_aux and not js.has_aux
    r = rng(5)
    x, eps = randn(r, 2, 4, 4, 4), randn(r, 2, 4, 4, 4)
    noise = t(randn(r, 2, 4, 4, 4)) if kind == "ddpm" else None
    aux = {"prev_x0": torch.ones(2, 4, 4, 4)}
    if kind == "ddpm":
        # step_with_aux hands no noise on, as the JAX package hands no key
        with pytest.raises(ValueError, match="ddpm"):
            ps.step_with_aux(t(eps), torch.tensor([0, 1]), t(x), aux)
        got = ps.step(t(eps), torch.tensor([0, 1]), t(x), noise=noise)
    else:
        got, out_aux = ps.step_with_aux(t(eps), torch.tensor([0, 1]), t(x), aux)
        assert out_aux is aux
    want = js.step(j(eps), jnp.asarray([0, 1]), j(x),
                   noise=None if noise is None else j(noise.numpy()))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind,cfg", [("ddpm", {}), ("ddim", {"ddim_eta": 0.5})],
                         ids=["ddpm", "ddim_eta"])
def test_noise_drawing_steps_raise_without_noise_as_in_jax(kind, cfg):
    js, ps = _pair(kind, 3, **cfg)
    x = randn(rng(6), 2, 4, 4, 4)
    with pytest.raises(ValueError):
        js.step(j(x), jnp.asarray([0, 1]), j(x), mask=jnp.asarray([True, True]))
    with pytest.raises(ValueError):
        ps.step(t(x), torch.tensor([0, 1]), t(x), mask=torch.tensor([True, True]))
    # a generator draws the noise on the port's side
    out = ps.step(t(x), torch.tensor([0, 1]), t(x), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("class_name", ["DDPMScheduler", "EulerDiscreteScheduler",
                                        "DPMSolverMultistepScheduler"])
def test_from_config_of_every_mapped_class_matches_jax(class_name):
    from diffuman4d_tpu.schedulers.diffusion import from_config as jfrom
    from diffuman4d_torch.schedulers.diffusion import from_config

    cfg = {"_class_name": class_name, "beta_schedule": "scaled_linear", "beta_start": 0.00085,
           "beta_end": 0.012, "timestep_spacing": "leading", "steps_offset": 1,
           "solver_order": 2, "algorithm_type": "dpmsolver++", "variance_type": "fixed_small"}
    got, want = from_config(cfg), jfrom(cfg)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    got, want = got.set_timesteps(36), want.set_timesteps(36)
    np.testing.assert_array_equal(n(got.timesteps), np.asarray(want.timesteps, np.float32))
    assert got.has_aux == want.has_aux


def test_tables_and_history_follow_the_requested_device():
    """Tables on the device ``set_timesteps`` names, the history on the
    scheduler's device or the one ``init_aux`` names (the meta device
    stands in for the card here)."""
    _, ps = _pair("euler", 5)
    moved = ps.set_timesteps(5, device="meta")
    assert moved.sigmas.device.type == moved.timesteps.device.type == "meta"
    _, dpm = _pair("dpm++", 5)
    assert dpm.init_aux((3, 2, 2, 4))["prev_x0"].device.type == "cpu"
    aux = dpm.init_aux((3, 2, 2, 4), "meta")
    assert aux["prev_x0"].device.type == aux["has_prev"].device.type == "meta"
