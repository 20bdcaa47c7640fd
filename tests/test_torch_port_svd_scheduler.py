"""Euler with Karras sigmas and v-prediction (SVD-xt's scheduler) in the
port's ``schedulers/diffusion.py`` against closed forms in float64: the
sigmas (rho 7, 700 down to 0.002), the continuous timesteps 0.25 ln sigma,
the initial sigma, and the v-Euler step on the state that the Karras path
carries, the model input ``x / sqrt(sigma^2 + 1)``.

Tolerances: the port holds its tables in fp32, as diffusers does, and steps
in fp32: the sigmas equal the float64 closed form rounded to fp32 exactly;
a step's value differs from the float64 closed form by fp32 rounding of a
few products, under 1e-5 of its magnitude (the step passes through x, 700
times the state at sigma 700)."""

import numpy as np
import pytest
import torch

from diffuman4d_torch.sampling.svd_pipeline import SVD_SCHEDULER_CONFIG
from diffuman4d_torch.schedulers.diffusion import from_config

N = 25


def _karras64(n=N, lo=0.002, hi=700.0):
    ramp = np.linspace(0, 1, n)
    return (hi ** (1 / 7) + ramp * (lo ** (1 / 7) - hi ** (1 / 7))) ** 7


@pytest.fixture
def sched():
    return from_config(SVD_SCHEDULER_CONFIG).set_timesteps(N)


def test_from_config_reads_the_karras_keys(sched):
    cfg = sched.config
    assert (cfg.kind, cfg.prediction_type, cfg.use_karras_sigmas, cfg.sigma_min, cfg.sigma_max,
            cfg.timestep_type) == ("euler", "v_prediction", True, 0.002, 700.0, "continuous")


def test_karras_sigmas_and_continuous_timesteps(sched):
    want = _karras64()
    assert sched.sigmas.dtype == torch.float32 and sched.sigmas.shape == (N + 1,)
    assert torch.equal(sched.sigmas[:N], torch.tensor(want, dtype=torch.float32))
    assert float(sched.sigmas[N]) == 0.0
    assert float(sched.sigmas[0]) == pytest.approx(700.0, rel=1e-7)
    assert float(sched.sigmas[N - 1]) == pytest.approx(0.002, rel=1e-6)
    t = sched.timesteps.double().numpy()
    np.testing.assert_allclose(t, 0.25 * np.log(want), rtol=1e-6, atol=1e-6)


def test_initial_sigma(sched):
    """The state starts at the unit draw: x's sqrt(sigma_max^2 + 1) is in
    the state's scale."""
    assert sched.init_noise_sigma == 1.0


def _closed_form_step(v, x, s, s1):
    """diffusers' Euler step in float64: x0 = x / (s^2 + 1) - s v /
    sqrt(s^2 + 1), x' = x + (s1 - s) (x - x0) / s."""
    x0 = x / (s * s + 1) - s * v / np.sqrt(s * s + 1)
    return x + (s1 - s) * (x - x0) / s


@pytest.mark.parametrize("idx", [0, 7, 23, 24])
def test_v_euler_step_on_the_scaled_state(sched, idx):
    """diffusers' step on x = y sqrt(s^2 + 1), divided by sqrt(s1^2 + 1)."""
    g = torch.Generator().manual_seed(idx)
    sig = sched.sigmas.double().numpy()
    s, s1 = sig[idx], sig[idx + 1]
    y = torch.randn(3, 4, 4, 4, generator=g)
    v = torch.randn(3, 4, 4, 4, generator=g)
    t_idx = torch.full((3,), idx)
    want_y = _closed_form_step(v.double(), y.double() * np.sqrt(s * s + 1), s, s1) \
        / np.sqrt(s1 * s1 + 1)
    got_y = sched.step(v, t_idx, y, mask=torch.tensor([True, False, True]))
    assert float((got_y[[0, 2]].double() - want_y[[0, 2]]).abs().max()
                 / want_y.abs().max()) < 1e-5
    assert torch.equal(got_y[1], y[1])  # a row off the mask keeps its state
    if idx == N - 1:  # the last step lands on x0 (sigma 0)
        x0 = y.double() / np.sqrt(s * s + 1) - s * v.double() / np.sqrt(s * s + 1)
        assert float((got_y[0].double() - x0[0]).abs().max()) < 1e-5


def test_scaled_state_is_the_model_input(sched):
    """The Karras state goes to the model as it is; Euler on x divides by
    sqrt(sigma^2 + 1)."""
    y = torch.randn(2, 3, 3, 4)
    t_idx = torch.tensor([3, 3])
    assert torch.equal(sched.scale_model_input(y, t_idx), y)
    plain = from_config({"_class_name": "EulerDiscreteScheduler"}).set_timesteps(N)
    c = float(torch.sqrt(plain.sigmas[3] ** 2 + 1))
    assert torch.allclose(plain.scale_model_input(y * c, t_idx), y, rtol=1e-6, atol=1e-6)


def test_other_schedulers_keep_their_tables():
    """The fields added for Karras leave the Euler tables of a checkpoint
    without them as they were (leading spacing, interpolated sigmas)."""
    s = from_config({"_class_name": "EulerDiscreteScheduler"}).set_timesteps(12)
    ac = np.cumprod(1 - np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000) ** 2)
    ts = (np.arange(12) * (1000 // 12)).round()[::-1] + 1
    sig = np.interp(ts, np.arange(1000), np.sqrt((1 - ac) / ac))
    assert torch.equal(s.timesteps, torch.tensor(ts, dtype=torch.float32))
    assert torch.equal(s.sigmas, torch.tensor(np.concatenate([sig, [0.0]]), dtype=torch.float32))
