"""The port's Adafactor against the JAX package's (``optax.adafactor`` in
``make_optimizer``), on the CPU in fp32: the optimiser alone on parameters
with and without a factored second moment, two train steps of a toy UNet
through both packages' ``make_train_step``, the size of the state, and the
loop's resume of an Adafactor state. Parameters and gradients come from
numpy in the flax layouts; the port steps their torch-layout transposes."""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import j, jax_unet, n, randn, rng, t

# flax layout -> torch layout, per rank: conv kernels (kh, kw, in, out) ->
# (out, in, kh, kw), dense kernels (in, out) -> (out, in), vectors as they are
TO_TORCH = {4: (3, 2, 0, 1), 2: (1, 0), 1: (0,)}
# flax shapes: a conv kernel factored over two unequal dims (128 in, 256
# out), a square one (the factored axes swap roles between the layouts), a
# dense kernel (256 in, 128 out), a dense kernel with one dim >= 128 (kept
# whole), a conv kernel below 128 (kept whole), a bias
SHAPES = {"conv": (3, 3, 128, 256), "conv_square": (3, 3, 128, 128), "dense": (256, 128),
          "dense_thin": (8, 200), "conv_small": (3, 3, 16, 32), "bias": (256,)}
FACTORED = {"conv", "conv_square", "dense"}
# fp32 on both sides, the same operations in another order: the updates
# and the second moments agree to within 1e-5 of each tensor's largest entry
REL = 1e-5


def _torch_layout(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(x, TO_TORCH[x.ndim]))


def _flax_factored(shape) -> tuple[int, int] | None:
    """optax's ``_factored_dims`` (read from the installed optax)."""
    from optax._src.factorized import _factored_dims

    return _factored_dims(shape, True, 128)


def _moment_in_torch_layout(jstate: dict, flax_shape, reduced_torch_axis: int) -> np.ndarray:
    """The optax factored moment that averages over the same physical axis
    as the port's moment over ``reduced_torch_axis``, in the port's axis
    order."""
    perm = TO_TORCH[len(flax_shape)]
    d1, d0 = _flax_factored(flax_shape)
    axis = perm[reduced_torch_axis]  # the flax axis it averages over
    arr = np.asarray(jstate["v_row"] if axis == d0 else jstate["v_col"])
    assert axis in (d0, d1)
    kept = [perm[i] for i in range(len(flax_shape)) if i != reduced_torch_axis]
    return np.transpose(arr, [a - (a > axis) for a in kept])


def _close(got, want, what: str, rel: float = REL) -> None:
    want = np.asarray(want, np.float32)
    bound = rel * max(np.abs(want).max(), 1e-30)
    assert np.abs(n(got) - want).max() <= bound, (what, np.abs(n(got) - want).max(), bound)


@pytest.mark.parametrize("weight_decay", [1e-2, 0.0], ids=["wd1e-2", "wd0"])
def test_adafactor_matches_optax(weight_decay):
    """Three steps of the clipped Adafactor chain on the same parameters
    and gradients: each step's update, the parameters and the second
    moments, with the weight decay added after the learning rate."""
    import optax

    from diffuman4d_tpu.training import trainer as jt
    from diffuman4d_torch.training import trainer as pt

    r = rng(3)
    params = {k: randn(r, *s, scale=0.05) for k, s in SHAPES.items()}
    # a grad_clip above every step's global norm except the second (clip active)
    kw = dict(optimizer="adafactor", learning_rate=0.1, weight_decay=weight_decay, grad_clip=20.0)
    jopt = jt.make_optimizer(jt.TrainConfig(**kw))
    jparams = {k: j(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    opt = pt.make_optimizer(pt.TrainConfig(**kw))
    tparams = {k: t(_torch_layout(v)) for k, v in params.items()}
    state = opt.init(tparams)

    jupdate = jax.jit(jopt.update)
    for step, scale in enumerate((0.01, 1.0, 0.02)):
        grads = {k: randn(r, *s, scale=scale) for k, s in SHAPES.items()}
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
        assert (norm > 20.0) == (step == 1)
        before = {k: v.clone() for k, v in tparams.items()}
        updates, jstate = jupdate({k: j(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        g_norm = opt.update({k: t(_torch_layout(v)) for k, v in grads.items()}, state, tparams)
        assert g_norm.item() == pytest.approx(norm, rel=1e-5)  # fp32 sums
        assert state["count"] == step + 1
        for k in SHAPES:
            _close(tparams[k] - before[k], _torch_layout(np.asarray(updates[k])),
                   f"step {step + 1} update {k}")
            _close(tparams[k], _torch_layout(np.asarray(jparams[k])), f"step {step + 1} {k}")

    # the factored state: optax's FactoredState sits in the chain after the clip
    fstate = next(s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda x: hasattr(x, "v_row")) if hasattr(s, "v_row"))
    assert int(fstate.count) == state["count"] == 3
    assert set(state["v_row"]) == set(state["v_col"]) == FACTORED
    assert set(state["v"]) == set(SHAPES) - FACTORED
    for k, s in SHAPES.items():
        jk = {"v_row": fstate.v_row[k], "v_col": fstate.v_col[k]}
        if k in FACTORED:
            d1, d0 = pt.factored_dims(tparams[k].shape)
            assert _flax_factored(s) is not None
            _close(state["v_row"][k], _moment_in_torch_layout(jk, s, d0), f"v_row {k}")
            _close(state["v_col"][k], _moment_in_torch_layout(jk, s, d1), f"v_col {k}")
        else:
            assert _flax_factored(s) is None and pt.factored_dims(tparams[k].shape) is None
            _close(state["v"][k], _torch_layout(np.asarray(fstate.v[k])), f"v {k}")


def test_adafactor_state_is_rows_plus_cols_and_under_half_of_adamw():
    from diffuman4d_torch.training import trainer as pt

    params = {k: torch.zeros(_torch_layout(np.zeros(s, np.float32)).shape)
              for k, s in SHAPES.items()}
    ada = pt.make_optimizer(pt.TrainConfig(optimizer="adafactor")).init(params)
    adam = pt.make_optimizer(pt.TrainConfig(optimizer="adamw")).init(params)
    # (256, 128, 3, 3): 128 x 9 + 256 x 9 values, not 294,912
    assert ada["v_row"]["conv"].shape == (128, 3, 3)
    assert ada["v_col"]["conv"].shape == (256, 3, 3)
    assert ada["v_row"]["dense"].shape == (128,) and ada["v_col"]["dense"].shape == (256,)
    assert "conv" not in ada["v"] and ada["v"]["dense_thin"].shape == (200, 8)

    def numel(state):
        return sum(x.numel() for slot, d in state.items() if slot != "count"
                   for x in d.values())

    assert numel(ada) <= 0.55 * numel(adam) / 2  # well under one of Adam's two moments
    assert numel(ada) <= 0.55 * numel(adam)


# ------------------------------------------------------------ train steps
B, L, LAT = 1, 4, 8
# two stages (the JAX package's Adafactor test's UNet): a short XLA compile
SMALL_UNET = dict(in_channels=11, block_out_channels=(8, 16), num_attention_heads=(1, 2),
                  layers_per_block=1, norm_num_groups=4, num_3d_attn_blocks=1)


def _batch(seed):
    r = rng(seed)
    is_cond = np.zeros((B, L), bool)
    is_cond[:, : L // 2] = True
    return {"latents_x0": randn(r, B, L, LAT, LAT, 4), "plucker": randn(r, B, L, LAT, LAT, 6),
            "skeletons": randn(r, B, L, LAT * 8, LAT * 8, 3, scale=0.5), "is_cond": is_cond}


def test_two_adafactor_train_steps_match_jax():
    """Both packages' ``make_train_step`` with Adafactor, the same weights,
    batches and draws: the loss and the parameters after two steps."""
    from diffuman4d_tpu.schedulers import diffusion as jd
    from diffuman4d_tpu.training import trainer as jt
    from diffuman4d_torch.io.checkpoints import unet_state_dict_from_flax
    from diffuman4d_torch.schedulers import diffusion as pd
    from diffuman4d_torch.training import trainer as pt
    from tests.torch_port_helpers import port_unet

    jmod, jparams = jax_unet(SMALL_UNET, num_frames=L, latent=LAT)
    kw = dict(optimizer="adafactor", learning_rate=1e-3, remat=False)
    jcfg = jt.TrainConfig(attn_implementation=None, **kw)
    jstate = jt.create_train_state(jparams, jcfg)
    jstep = jax.jit(jt.make_train_step(jmod, jd.Scheduler(jd.SchedulerConfig()), jcfg))
    unet = port_unet(SMALL_UNET, jparams)
    cfg = pt.TrainConfig(**kw)
    state = pt.create_train_state(unet, cfg)
    step = pt.make_train_step(unet, pd.Scheduler(pd.SchedulerConfig()), cfg)
    for i in range(2):
        batch, key = _batch(30 + i), jax.random.PRNGKey(40 + i)
        jb = {k: (jnp.asarray(v) if v.dtype == bool else j(v)) for k, v in batch.items()}
        jstate, jm = jstep(jstate, jb, key)
        k_t, k_eps = jax.random.split(key)
        tt = torch.from_numpy(np.array(jax.random.randint(k_t, (B,), 0, 1000, jnp.int32)))
        eps = torch.from_numpy(np.array(jax.random.normal(k_eps, (B, L, LAT, LAT, 4))))
        tb = {k: (torch.from_numpy(v) if v.dtype == bool else t(v)) for k, v in batch.items()}
        state, m = step(state, tb, t=tt, eps=eps)
        assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    npy = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    want = unet_state_dict_from_flax(npy(jstate.params["params"]))
    start = unet_state_dict_from_flax(npy(jparams["params"]))
    assert state.opt_state["count"] == 2 and not state.opt_state["v_row"]  # widths < 128
    # Adafactor's first step moves each weight by lr * rms(w) * sign(g), so
    # an entry whose gradient is rounding noise may step the other way: the
    # steps agree to 1e-3 of each tensor's largest step at 99.5% of the
    # entries, and to 5e-2 at all of them
    for k, w in want.items():
        got, ref = n(state.params[k]) - start[k], w - start[k]
        err = np.abs(got - ref)
        top = max(np.abs(ref).max(), 1e-30)
        assert (err > 1e-3 * top).mean() <= 0.005, k
        assert err.max() <= 5e-2 * top, k
    moved = max(np.abs(n(state.params[k]) - start[k]).max() for k in want)
    assert moved > 1e-4
    # the module's working copy was refreshed from the masters
    for k, p in unet.named_parameters():
        assert torch.equal(p, state.params[k])


# --------------------------------------------------------------------- loop
def _loop_setup(scene_dir):
    from diffuman4d_torch.data import SpaTemDataset
    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.sampling.loader import build_models
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.training.data import WindowBatcher, WindowBatcherConfig

    # a 128-wide second stage: its convs and projections have a factored moment
    cfg = UNetConfig(in_channels=11, block_out_channels=(8, 128), num_attention_heads=(1, 2),
                     layers_per_block=1, norm_num_groups=4, num_3d_attn_blocks=1)
    unet, vae = build_models(cfg, VAEConfig(block_out_channels=(4, 4, 8, 8), layers_per_block=1),
                             device="cpu", dtype=torch.float32, seed=0)
    pipe = Diffuman4DPipeline(unet, vae, Scheduler(SchedulerConfig()), image_size=64,
                              device="cpu")
    dataset = SpaTemDataset(data_dir=scene_dir, scene_label="scene0", height=64, width=64)
    batcher = WindowBatcher(dataset, WindowBatcherConfig(
        window_size=2, tem_labels=["000000", "000001"], input_spa_labels=["00", "03"]))
    return pipe, batcher


def test_loop_resumes_an_adafactor_state_exactly(tmp_path):
    """4 steps in one run equal 2 steps, a stop, and a resumed run to 4:
    parameters and every second moment, bit for bit; a state of another
    optimiser is refused."""
    from diffuman4d_torch.data import make_synthetic_scene
    from diffuman4d_torch.training.loop import LoopConfig, train
    from diffuman4d_torch.training.trainer import TrainConfig

    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, "scene0", num_cams=6, num_frames=2, image_size=64)
    tcfg = TrainConfig(optimizer="adafactor", learning_rate=1e-3, ema_decay=0.9, ema_host=True,
                       ema_update_every=2)

    def run(out, steps, cfg=tcfg):
        pipe, batcher = _loop_setup(scene)
        lcfg = LoopConfig(steps=steps, window_size=2, checkpoint_every=2, log_every=1,
                          out_dir=str(tmp_path / out), seed=5)
        return train(pipe, batcher, lcfg, cfg)

    full = run("full", 4)
    run("resumed", 2)
    resumed = run("resumed", 4)
    assert full.step == resumed.step == 4 and resumed.opt_state["count"] == 4
    assert full.opt_state["v_row"] and full.opt_state["v"]
    for k in full.params:
        assert torch.equal(full.params[k], resumed.params[k]), k
    for slot in ("v_row", "v_col", "v"):
        assert set(full.opt_state[slot]) == set(resumed.opt_state[slot])
        for k, v in full.opt_state[slot].items():
            assert torch.equal(v, resumed.opt_state[slot][k]), (slot, k)
    recs = [json.loads(x) for x in (tmp_path / "resumed" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    # an AdamW run cannot resume from an Adafactor state
    with pytest.raises(KeyError, match="optimiser state"):
        run("resumed", 6, dataclasses.replace(tcfg, optimizer="adamw"))
