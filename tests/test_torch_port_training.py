"""The port's training path against the JAX package, on the CPU in fp32 at
tiny widths: ``diffusion_loss`` and its gradients, two AdamW steps with
clipping, the host EMA, and the loop with resume. Weights, batches, timesteps
and noise come from numpy / the JAX keys and are handed to both sides; flax
gradients and optax moments go through the port's weight carry so they are
compared key by key. The port's attention runs ``implementation="train"``
(its plain version on the CPU), the JAX side its XLA attention."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import TINY_UNET, j, jax_unet, n, port_unet, randn, rng, t

B, L, LAT = 2, 4, 8


def _batch(seed=0):
    r = rng(seed)
    is_cond = np.zeros((B, L), bool)
    is_cond[:, : L // 2] = True
    return {"latents_x0": randn(r, B, L, LAT, LAT, 4), "plucker": randn(r, B, L, LAT, LAT, 6),
            "skeletons": randn(r, B, L, LAT * 8, LAT * 8, 3, scale=0.5), "is_cond": is_cond}


def _jbatch(b):
    return {k: (jnp.asarray(v) if v.dtype == bool else j(v)) for k, v in b.items()}


def _tbatch(b):
    return {k: (torch.from_numpy(v) if v.dtype == bool else t(v)) for k, v in b.items()}


def _jax_draw(key, num_train_timesteps=1000):
    """The (t, eps) that the JAX ``diffusion_loss`` draws from ``key``."""
    k_t, k_eps = jax.random.split(key)
    tt = jax.random.randint(k_t, (B,), 0, num_train_timesteps, jnp.int32)
    eps = jax.random.normal(k_eps, (B, L, LAT, LAT, 4), jnp.float32)
    return torch.from_numpy(np.array(tt)), torch.from_numpy(np.array(eps))


@pytest.fixture(scope="module")
def models():
    jmod, jparams = jax_unet(TINY_UNET, num_frames=L, latent=LAT)
    return jmod, jparams


def _port_model(jparams):
    from diffuman4d_torch.models.unet import UNetConfig, UNetMultiviewCondition
    from diffuman4d_torch.io.checkpoints import load_numpy_state_dict, unet_state_dict_from_flax

    unet = UNetMultiviewCondition(UNetConfig(**TINY_UNET)).float().eval()
    load_numpy_state_dict(unet, unet_state_dict_from_flax(jparams["params"]))
    return unet


def _assert_by_key(got: dict, want: dict, rel: float, what: str, floor: float = 0.0):
    """Every tensor within ``rel`` of its largest entry (plus ``floor``,
    for a tensor that is itself a cancelling sum, as the one-element
    gradient of the pose encoder's scale is)."""
    assert set(got) == set(want), what
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        bound = rel * max(np.abs(w).max(), 1e-30) + floor
        assert np.abs(n(got[k]) - w).max() <= bound, f"{what}: {k}"


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
    batch, key = _batch(1), jax.random.PRNGKey(7)
    jcfg = jt.TrainConfig(prediction_type=prediction, remat=False, attn_implementation=None)
    jsched = jd.Scheduler(jd.SchedulerConfig())
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jt.diffusion_loss(
        jmod, jsched, jcfg, {"params": p}, _jbatch(batch), key, domain)))(jparams["params"])

    unet = _port_model(jparams)
    cfg = pt.TrainConfig(prediction_type=prediction, remat=remat)
    tt, eps = _jax_draw(key)
    with unet.configured(attn_implementation="train"):
        loss = pt.diffusion_loss(unet, pd.Scheduler(pd.SchedulerConfig()), cfg, _tbatch(batch),
                                 domain, t=tt, eps=eps)
        loss.backward()
    assert unet.remat is False and unet.attn_implementation == "auto"  # restored
    # fp32 both sides, same inputs: summation order only
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = grads_from_flax(jax.tree.map(np.asarray, jgrads))
    got = {k: p.grad for k, p in unet.named_parameters()}
    assert all(g is not None for g in got.values())
    _assert_by_key(got, want, 1e-4, f"gradients {domain}/{prediction}/remat={remat}", floor=1e-6)


def test_diffusion_loss_draws_from_a_generator_and_checks_arguments():
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.training import trainer as pt

    _, jparams = jax_unet(TINY_UNET, num_frames=L, latent=LAT)
    unet, sched, batch = _port_model(jparams), Scheduler(SchedulerConfig()), _tbatch(_batch(2))
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


# -------------------------------------------------------------- train step
def test_two_adamw_steps_match_jax(models):
    from diffuman4d_tpu.schedulers import diffusion as jd
    from diffuman4d_tpu.training import trainer as jt
    from diffuman4d_torch.io.checkpoints import adam_state_from_flax, unet_state_dict_from_flax
    from diffuman4d_torch.schedulers import diffusion as pd
    from diffuman4d_torch.training import trainer as pt

    jmod, jparams = models
    kw = dict(learning_rate=1e-3, grad_clip=1.0, remat=False, ema_decay=0.9)
    jcfg = jt.TrainConfig(attn_implementation=None, **kw)
    jstate = jt.create_train_state(jparams, jcfg)
    jstep = jax.jit(jt.make_train_step(jmod, jd.Scheduler(jd.SchedulerConfig()), jcfg))

    unet = _port_model(jparams)
    cfg = pt.TrainConfig(**kw)
    state = pt.create_train_state(unet, cfg)
    step = pt.make_train_step(unet, pd.Scheduler(pd.SchedulerConfig()), cfg)
    for i in range(2):
        batch, key = _batch(10 + i), jax.random.PRNGKey(20 + i)
        jstate, jm = jstep(jstate, _jbatch(batch), key)
        tt, eps = _jax_draw(key)
        state, m = step(state, _tbatch(batch), t=tt, eps=eps)
        assert m["step"] == int(jm["step"]) == i + 1
        assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
        # the clip is active (norm > 1), so the step depends on the norm
        assert float(jm["grad_norm"]) > 1.0
        assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])
    npy = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    # Adam's first steps move every weight by ~lr whatever its gradient, so
    # 1e-5 of the largest entry holds the update to ~1% of itself
    # 1e-5 of each tensor's largest entry holds the update (~lr per step) to
    # ~1% of itself. Where a gradient entry is itself rounding noise, Adam's
    # m / (sqrt(v) + eps) is a sign and the two sides may step apart: at most
    # 0.5% of a tensor's entries may exceed that bound, none by more than 10x
    want = unet_state_dict_from_flax(npy(jstate.params["params"]))
    _assert_by_key(state.params, want, 1e-4, "params")
    for k, w in want.items():
        err = np.abs(n(state.params[k]) - w)
        assert (err > 1e-5 * np.abs(w).max()).mean() <= 0.005, k
    assert max(np.abs(n(state.params[k]) - n(p0)).max()
               for k, p0 in unet_state_dict_from_flax(npy(jparams["params"])).items()) > 1e-3
    _assert_by_key(state.ema_params, unet_state_dict_from_flax(npy(jstate.ema_params)), 1e-4, "ema")
    jadam = adam_state_from_flax(npy(jstate.opt_state))
    assert jadam["count"] == state.opt_state["count"] == 2
    _assert_by_key(state.opt_state["mu"], jadam["mu"], 1e-3, "mu")
    _assert_by_key(state.opt_state["nu"], jadam["nu"], 1e-3, "nu")
    # the module's working copy was refreshed from the masters
    for k, p in unet.named_parameters():
        assert torch.equal(p, state.params[k])


@pytest.mark.parametrize("kind,warmup", [("constant", 0), ("constant", 5), ("cosine", 0),
                                         ("cosine", 4)])
def test_lr_schedules_match_optax(kind, warmup):
    from diffuman4d_tpu.training import trainer as jt
    from diffuman4d_torch.training import trainer as pt

    kw = dict(learning_rate=3e-4, lr_schedule=kind, warmup_steps=warmup, total_steps=40)
    want = jt.make_lr_schedule(jt.TrainConfig(**kw))
    got = pt.make_lr_schedule(pt.TrainConfig(**kw))
    for count in (0, 1, 3, 4, 5, 6, 20, 39, 40, 100):
        w = float(want(count)) if callable(want) else float(want)
        # optax evaluates the cosine in fp32
        assert got(count) == pytest.approx(w, rel=1e-6, abs=1e-6 * 3e-4), count


def test_train_config_defaults_match_and_adafactor_is_not_ported():
    import dataclasses

    from diffuman4d_tpu.training import trainer as jt
    from diffuman4d_torch.training import trainer as pt

    assert dataclasses.asdict(pt.TrainConfig()) == dataclasses.asdict(jt.TrainConfig())
    # Adafactor is ported (tests/test_torch_port_adafactor.py holds it to optax)
    opt = pt.make_optimizer(pt.TrainConfig(optimizer="adafactor"))
    state = opt.init({"w": torch.zeros(256, 128), "b": torch.zeros(256)})
    assert sorted(state) == ["count", "v", "v_col", "v_row"]
    assert sorted(state["v_row"]) == sorted(state["v_col"]) == ["w"] and sorted(state["v"]) == ["b"]
    with pytest.raises(ValueError):
        pt.make_optimizer(pt.TrainConfig(optimizer="sgd"))
    with pytest.raises(ValueError):
        pt.make_lr_schedule(pt.TrainConfig(lr_schedule="linear"))


# ---------------------------------------------------------------------- EMA
def _small_setup():
    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.sampling.loader import build_models
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig

    cfg = UNetConfig(in_channels=11, block_out_channels=(8, 16), num_attention_heads=(1, 2),
                     layers_per_block=1, norm_num_groups=4, num_3d_attn_blocks=1)
    unet, vae = build_models(cfg, VAEConfig(block_out_channels=(4, 4, 8, 8), layers_per_block=1),
                             device="cpu", dtype=torch.float32, seed=0)
    return unet, vae, Scheduler(SchedulerConfig())


def test_host_ema_matches_device_ema():
    """Same seeds, same batch: the host shadow after 4 steps equals the
    in-step device EMA (the same fp32 update), and the parameter
    trajectories, which do not depend on the EMA, are identical."""
    from diffuman4d_torch.training.ema import HostEMA
    from diffuman4d_torch.training.trainer import TrainConfig, create_train_state, make_train_step

    batch = _tbatch(_batch(3))

    def run(ema_host: bool):
        unet, _, sched = _small_setup()
        cfg = TrainConfig(learning_rate=1e-3, remat=False, ema_decay=0.9, ema_host=ema_host)
        state = create_train_state(unet, cfg)
        step = make_train_step(unet, sched, cfg)
        hema = HostEMA(state.params, 0.9) if ema_host else None
        for i in range(4):
            if hema is not None:
                hema.fold()
            state, _ = step(state, batch, generator=torch.Generator().manual_seed(i))
            if hema is not None:
                hema.stage(state.params)
        if hema is not None:
            hema.fold()
            return state, hema.materialize()
        return state, state.ema_params

    state_dev, ema_dev = run(False)
    state_host, ema_host = run(True)
    assert state_host.ema_params is None
    for k in state_dev.params:
        assert torch.equal(state_dev.params[k], state_host.params[k])
        torch.testing.assert_close(ema_host[k], ema_dev[k], rtol=2e-6, atol=1e-7)
    k0 = next(iter(ema_host))
    assert not torch.allclose(state_host.params[k0], ema_host[k0])  # the shadow lags


def test_host_ema_spaced_updates_and_roundtrip():
    from diffuman4d_torch.training.ema import HostEMA

    ema = HostEMA({"w": torch.ones(4, 4)}, 0.9, update_every=3)
    assert ema.decay == pytest.approx(0.9 ** 3)
    assert [ema.should_update(s) for s in range(4)] == [True, False, False, True]
    ema.stage({"w": torch.zeros(4, 4)})
    ema.fold()
    ema.fold()  # a fold without a stage is a no-op
    torch.testing.assert_close(ema.shadow[0], torch.full((4, 4), 0.9 ** 3))
    other = HostEMA({"w": torch.ones(4, 4)}, 0.5)
    other.load(ema.materialize())
    assert torch.equal(other.shadow[0], ema.shadow[0]) and other.nbytes == 64
    with pytest.raises(ValueError):
        ema.stage({"v": torch.zeros(4, 4)})
    with pytest.raises(ValueError):
        HostEMA({"w": torch.ones(1)}, 1.0)


# --------------------------------------------------------------------- loop
def _loop_setup(tmp, scene_dir):
    from diffuman4d_torch.data import SpaTemDataset
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline
    from diffuman4d_torch.training.data import WindowBatcher, WindowBatcherConfig

    unet, vae, sched = _small_setup()
    pipe = Diffuman4DPipeline(unet, vae, sched, image_size=64, device="cpu")
    dataset = SpaTemDataset(data_dir=scene_dir, scene_label="scene0", height=64, width=64)
    batcher = WindowBatcher(dataset, WindowBatcherConfig(
        window_size=2, tem_labels=["000000", "000001"], input_spa_labels=["00", "03"]))
    return pipe, batcher


@pytest.mark.parametrize("ema_host", [False, True], ids=["device_ema", "host_ema"])
def test_loop_trains_checkpoints_and_resumes(tmp_path, ema_host):
    """4 steps in one run equal 2 steps, a stop, and a resumed run to 4:
    parameters, moments, EMA and step, bit for bit."""
    from diffuman4d_torch.data import make_synthetic_scene
    from diffuman4d_torch.training.loop import LoopConfig, train
    from diffuman4d_torch.training.trainer import TrainConfig

    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, "scene0", num_cams=6, num_frames=2, image_size=64)
    tcfg = TrainConfig(learning_rate=1e-3, ema_decay=0.9, ema_host=ema_host)

    def run(out, steps):
        pipe, batcher = _loop_setup(tmp_path, scene)
        lcfg = LoopConfig(steps=steps, window_size=2, checkpoint_every=2, log_every=1,
                          out_dir=str(tmp_path / out), seed=5)
        return train(pipe, batcher, lcfg, tcfg), pipe

    full, _ = run("full", 4)
    run("resumed", 2)
    resumed, pipe = run("resumed", 4)
    assert full.step == resumed.step == 4 and full.opt_state["count"] == 4
    for k in full.params:
        assert torch.equal(full.params[k], resumed.params[k]), k
        assert torch.equal(full.opt_state["nu"][k], resumed.opt_state["nu"][k]), k
    # the module carries the trained weights
    assert all(torch.equal(p, resumed.params[k]) for k, p in pipe.unet.named_parameters())
    files = sorted(p.name for p in (tmp_path / "resumed").iterdir())
    assert files == ["ckpt_0000002.pt", "ckpt_0000004.pt", "metrics.jsonl", "state_0000002.pt",
                     "state_0000004.pt"]
    recs = [json.loads(x) for x in (tmp_path / "resumed" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert [r["domain"] for r in recs] == ["spatial", "temporal"] * 2
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in recs)
    load = lambda d, f: torch.load(tmp_path / d / f, weights_only=True)  # noqa: E731
    a, b = load("full", "ckpt_0000004.pt")["unet"], load("resumed", "ckpt_0000004.pt")["unet"]
    assert set(a) == set(dict(pipe.unet.named_parameters()))  # diffusers key names
    assert all(torch.equal(a[k], b[k]) for k in a)  # the EMA weights, resumed exactly
    assert not torch.equal(a["conv_in.weight"], full.params["conv_in.weight"])


def test_loop_main_loads_a_jax_checkpoint(tmp_path):
    """``python -m diffuman4d_torch.training.loop model_dir=...`` loads a
    diffusers directory the JAX package wrote (through ``load_pipeline``,
    storage bf16 as in the JAX loop, compute fp32) and trains from it as
    ``train`` does on the same weights carried by ``state_dicts_from_flax``."""
    from diffuman4d_tpu.io.checkpoints import save_hf_checkpoint
    from diffuman4d_tpu.models.unet import UNetConfig
    from diffuman4d_tpu.models.vae import VAEConfig
    from diffuman4d_torch.data import SpaTemDataset, make_synthetic_scene
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.training.data import WindowBatcher, WindowBatcherConfig
    from diffuman4d_torch.training.loop import LoopConfig, main, train
    from tests.torch_port_helpers import TINY_VAE, jax_vae, port_vae

    _, uparams = jax_unet(TINY_UNET)
    _, vparams = jax_vae(TINY_VAE)
    save_hf_checkpoint(str(tmp_path / "model"), {"unet": uparams, "vae": vparams},
                       UNetConfig(**TINY_UNET), VAEConfig(**TINY_VAE))
    make_synthetic_scene(str(tmp_path / "scene"), "scene0", num_cams=6, num_frames=2,
                         image_size=64)
    assert main([f"data_dir={tmp_path / 'scene'}", "scene_label=scene0", "height=64",
                 "width=64", "steps=2", "window_size=2", "input_spa_labels=00,03",
                 f"model_dir={tmp_path / 'model'}", "dtype=fp32", "device=cpu",
                 f"out_dir={tmp_path / 'main'}"]) == 0

    # the same weights rounded to bf16 storage, carried into fp32 modules
    bf16 = lambda tree: jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)  # noqa: E731
    pipe = Diffuman4DPipeline(port_unet(TINY_UNET, bf16(uparams)),
                              port_vae(TINY_VAE, bf16(vparams)),
                              Scheduler(SchedulerConfig()), image_size=64, device="cpu")
    batcher = WindowBatcher(
        SpaTemDataset(data_dir=str(tmp_path / "scene"), scene_label="scene0", height=64,
                      width=64),
        WindowBatcherConfig(window_size=2, tem_labels=["000000", "000001"],
                            input_spa_labels=["00", "03"]))
    train(pipe, batcher, LoopConfig(steps=2, window_size=2, out_dir=str(tmp_path / "ref")))

    read = lambda d: json.loads((tmp_path / d / "metrics.jsonl").read_text().splitlines()[0])  # noqa: E731
    assert read("main")["loss"] == pytest.approx(read("ref")["loss"], rel=1e-6)
    got = torch.load(tmp_path / "main" / "state_0000002.pt", weights_only=True)["params"]
    want = torch.load(tmp_path / "ref" / "state_0000002.pt", weights_only=True)["params"]
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7)
