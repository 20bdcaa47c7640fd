"""Shared setup of the port's data- and tensor-parallel training tests
(``tests/test_torch_port_dp_{training,adafactor}.py``): the JAX oracle (the
JAX train step jitted on a 2 x 2 device mesh of the conftest's 8 CPU
devices, ``shard_params_for_tp(min_size=2**10)``, a ``P("data")`` batch) and
the port's steps on four gloo CPU ranks, run side by side, and the
comparison of the two at the one-card tests' tolerances."""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np

from diffuman4d_torch.parallel import distributed as pdist
from tests import torch_port_dist_worker as worker
from tests.torch_port_helpers import TINY_UNET, j, jax_unet

TIMEOUT_S = 180.0
B, L, LAT = 2, 4, 8
MIN_SIZE = 2**10


def _batch(seed: int) -> dict:
    r = np.random.default_rng(seed)
    is_cond = np.zeros((B, L), bool)
    is_cond[:, : L // 2] = True
    rnd = lambda *s, scale=1.0: (r.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return {"latents_x0": rnd(B, L, LAT, LAT, 4), "plucker": rnd(B, L, LAT, LAT, 6),
            "skeletons": rnd(B, L, LAT * 8, LAT * 8, 3, scale=0.5), "is_cond": is_cond}


def _jax_draw(key) -> tuple:
    """The (t, eps) the JAX ``diffusion_loss`` draws from ``key``."""
    k_t, k_eps = jax.random.split(key)
    tt = jax.random.randint(k_t, (B,), 0, 1000, jnp.int32)
    return np.array(tt), np.array(jax.random.normal(k_eps, (B, L, LAT, LAT, 4), jnp.float32))


def flax_to_port(tree) -> dict:
    from diffuman4d_torch.io.checkpoints import unet_state_dict_from_flax

    return unet_state_dict_from_flax(jax.tree.map(np.asarray, tree))


def _find(node, attr: str):
    """The optax sub-state that has ``attr`` (any nesting of tuples)."""
    if hasattr(node, attr):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            if (hit := _find(child, attr)) is not None:
                return hit
    return None


def _close_by_key(got: dict, want: dict, rel: float, what: str, floor: float = 0.0) -> None:
    """Every tensor within ``rel`` of its largest entry (plus ``floor``)."""
    assert set(got) == set(want), what
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        bound = rel * max(np.abs(w).max(), 1e-30) + floor
        assert np.abs(np.asarray(got[k]) - w).max() <= bound, f"{what}: {k}"


def jax_setup():
    """(module, params, 2 x 2 mesh, params placed on it) of the JAX side."""
    from diffuman4d_tpu.parallel.mesh import make_mesh, shard_params_for_tp

    jmod, jparams = jax_unet(TINY_UNET, num_frames=L, latent=LAT)
    jmesh = make_mesh(data=2, model=2)
    placed = {"params": shard_params_for_tp(jparams["params"], jmesh, min_size=MIN_SIZE)}
    return jmod, jparams, jmesh, placed


def _port_ranks(args: tuple, out: dict) -> None:
    try:
        out["ranks"] = pdist.spawn_cpu_ranks(worker.train_steps, 4, args, timeout_s=TIMEOUT_S)
    except BaseException as e:  # re-raised in the test's thread
        out["error"] = e


def two_steps_match_jax(setup, optimizer: str, domain: str) -> None:
    """Two train steps on a 2 x 2 mesh in both packages (the port's four
    ranks run while the JAX step compiles), then the comparison."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from diffuman4d_tpu.schedulers import diffusion as jd
    from diffuman4d_tpu.training import trainer as jt

    jmod, jparams, jmesh, placed = setup
    kw = dict(optimizer=optimizer, learning_rate=1e-3, grad_clip=1.0, remat=False,
              ema_decay=0.9, weight_decay=1e-2)
    batches = [_batch(10 + i) for i in range(2)]
    keys = [jax.random.PRNGKey(20 + i) for i in range(2)]
    state0 = flax_to_port(jparams["params"])
    port: dict = {}
    thread = threading.Thread(target=_port_ranks, args=(
        (2, 2, TINY_UNET, state0, kw, domain, batches, [_jax_draw(k) for k in keys], MIN_SIZE),
        port))
    thread.start()
    jcfg = jt.TrainConfig(attn_implementation=None, **kw)
    jstate = jt.create_train_state(placed, jcfg)
    jstep = jax.jit(jt.make_train_step(jmod, jd.Scheduler(jd.SchedulerConfig()), jcfg, domain))
    dshard = NamedSharding(jmesh, P("data"))
    jmetrics, nus = [], []
    for batch, key in zip(batches, keys):
        jb = {k: jax.device_put(jnp.asarray(v) if v.dtype == bool else j(v), dshard)
              for k, v in batch.items()}
        jstate, jm = jstep(jstate, jb, key)
        jmetrics.append({k: float(v) for k, v in jm.items()})
        if optimizer == "adamw":
            nus.append(flax_to_port(_find(jstate.opt_state, "nu").nu))
    thread.join()
    if "error" in port:
        raise port["error"]
    ranks = port["ranks"]

    for r in ranks:
        for m, jm in zip(r["metrics"], jmetrics):
            assert m["step"] == int(jm["step"])
            assert abs(m["loss"] - jm["loss"]) <= 1e-5 * jm["loss"]
            assert jm["grad_norm"] > 1.0  # the clip is active
            assert abs(m["grad_norm"] - jm["grad_norm"]) <= 1e-4 * jm["grad_norm"]
        assert r["module_is_masters"]
    # every sharded master, moment and shadow is this rank's half along dim 0
    placement = ranks[0]["placement"]
    sharded = {k for k, d in placement.items() if d is not None}
    whole = {k: v.shape for k, v in state0.items()}
    assert sharded
    for r in ranks:
        assert r["placement"] == placement
        for slot, shapes in r["shapes"].items():
            for k, s in shapes.items():
                want = ((whole[k][0] // 2,) + whole[k][1:]) if k in sharded else whole[k]
                assert s == want, (slot, k)
        bytes_ = r["metrics"][-1]["state_bytes"]
        assert bytes_["masters"] == 4 * sum(np.prod(s) for s in r["shapes"]["params"].values())
        assert bytes_["ema"] == bytes_["masters"]
    assert ranks[0]["metrics"][-1]["state_bytes"]["masters"] < 4 * sum(
        v.size for v in state0.values())

    got = ranks[0]["state"]
    want = flax_to_port(jstate.params["params"])
    if optimizer == "adamw":
        # tests/test_torch_port_training.py::test_two_adamw_steps_match_jax:
        # 1e-4 of each tensor's largest entry, and 1e-5 at 99.5% of its
        # entries. The one exception is an entry whose gradient is rounding
        # noise, where Adam's update m / (sqrt(v) + eps) turns the noise
        # into a step of up to lr: where JAX's clipped gradient of either
        # step (read from its nu) is under 10 eps, the 1e-4 bound gives way
        # to 2 lr a step. (The JAX step on this 2 x 2 mesh and on one device
        # differ by 0.7e-4 there in the pose encoder's deep convs; the port
        # on one card and on 2 x 2 by 1e-5.)
        adam = _find(jstate.opt_state, "mu")
        assert got["count"] == int(adam.count) == 2
        for k, w in want.items():
            err, top = np.abs(got["params"][k] - w), np.abs(w).max()
            g1 = np.sqrt(nus[0][k] / 1e-3)
            g2 = np.sqrt(np.maximum(nus[1][k] - 0.999 * nus[0][k], 0.0) / 1e-3)
            noise = np.minimum(g1, g2) < 10 * 1e-8
            assert err[~noise].max(initial=0.0) <= 1e-4 * top, k
            assert err[noise].max(initial=0.0) <= 2 * 2 * kw["learning_rate"], k
            assert (err > 1e-5 * top).mean() <= 0.005, k
        _close_by_key(got["mu"], flax_to_port(adam.mu), 1e-3, "mu")
        _close_by_key(got["nu"], flax_to_port(adam.nu), 1e-3, "nu")
    else:
        # tests/test_torch_port_adafactor.py::test_two_adafactor_train_steps_match_jax
        for k, w in want.items():
            step, ref = got["params"][k] - state0[k], w - state0[k]
            err, top = np.abs(step - ref), max(np.abs(ref).max(), 1e-30)
            assert (err > 1e-3 * top).mean() <= 0.005, k
            assert err.max() <= 5e-2 * top, k
        fact = _find(jstate.opt_state, "v_row")
        assert got["count"] == 2 and not got["v_row"]  # widths < 128: no factored moment
        _close_by_key(got["v"], flax_to_port(fact.v), 1e-3, "v")
    _close_by_key(got["ema"], flax_to_port(jstate.ema_params), 1e-4, "ema")
