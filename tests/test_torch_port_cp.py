"""Context parallelism of the port (``diffuman4d_torch/ops/context_parallel.py``,
``parallel/cp_unet.py``) against the JAX package's under ``shard_map`` on
the conftest's 8-device CPU mesh (the models: ``tests/test_context_parallel.py``
and ``tests/test_cp_unet.py``). The port's side runs on 2 or 4 gloo CPU
ranks (``tests/torch_port_dist_worker.py``); fp32 on both sides, within
2e-5 as in ``tests/test_cp_unet.py``. The two CFG halves of every input
differ (the second half's K / V are scaled and shifted), so a rank that kept
both halves' keys would be far off."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from diffuman4d_torch.parallel import distributed as pdist
from tests import torch_port_dist_worker as worker
from tests.torch_port_helpers import jax_unet, one_torch_thread, port_unet  # noqa: F401

TIMEOUT_S = 120.0
TOL = dict(rtol=2e-5, atol=2e-5)
# tests/test_cp_unet.py's TINY: two stages, the mid block's attention 3D
# (its K/V gathered), the outer stage's per-frame (rank-local)
TINY = dict(in_channels=11, block_out_channels=(8, 16), num_attention_heads=(1, 2),
            layers_per_block=1, norm_num_groups=4, num_3d_attn_blocks=1)
L, HW = 8, 8  # frames per CFG half, latent side


def _jax_mesh(model: int):
    from diffuman4d_tpu.parallel.mesh import make_mesh

    return make_mesh(data=1, model=model)


def _halves_differ(x: np.ndarray, groups: int) -> np.ndarray:
    """Scale and shift the second of ``groups`` sequence halves (axis 1)."""
    if groups == 2:
        x = x.copy()
        half = x.shape[1] // 2
        x[:, half:] = 3.0 * x[:, half:] + 2.0
    return x


@pytest.mark.parametrize("world,groups", [(2, 2), (4, 2), (4, 1)])
def test_cp_attention_grouped_matches_jax(world, groups):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from diffuman4d_tpu.ops.context_parallel import cp_attention_grouped

    r = np.random.default_rng(world * 10 + groups)
    q, k, v = (r.standard_normal((1, 64, 2, 8)).astype(np.float32) for _ in range(3))
    k, v = _halves_differ(k, groups), _halves_differ(v, groups)
    spec = P(None, "model", None, None)
    want = np.asarray(jax.jit(shard_map(
        lambda a, b, c: cp_attention_grouped(a, b, c, axis="model", groups=groups,
                                             implementation="xla"),
        mesh=_jax_mesh(world), in_specs=(spec,) * 3, out_specs=spec))(q, k, v))
    parts = pdist.spawn_cpu_ranks(worker.cp_attention, world, (q, k, v, groups),
                                  timeout_s=TIMEOUT_S)
    got = np.concatenate(parts, axis=1)
    np.testing.assert_allclose(got, want, **TOL)
    # each group attends its own half only: attending both halves is far off
    if groups == 2:
        from diffuman4d_torch.ops.flash_attention import attention_plain

        leaky = attention_plain(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
        assert np.abs(leaky - want).max() > 0.1


def test_shard_attention_over_mesh_matches_jax():
    """The whole-sequence convenience (``tests/test_context_parallel.py:14``)
    on four ranks: each attends its query slice, every rank gets it all."""
    from diffuman4d_tpu.ops.context_parallel import shard_attention_over_mesh

    r = np.random.default_rng(5)
    q, k, v = (r.standard_normal((2, 64, 2, 8)).astype(np.float32) for _ in range(3))
    want = np.asarray(shard_attention_over_mesh(_jax_mesh(4), q, k, v, implementation="xla"))
    outs = pdist.spawn_cpu_ranks(worker.shard_attention, 4, (q, k, v), timeout_s=TIMEOUT_S)
    for got in outs:
        np.testing.assert_allclose(got, want, **TOL)


def test_route_takes_cp_shapes_by_their_keys():
    """Under context parallelism the 3D attention has Sq < Sk: ``route``
    looks the table up by Sq but must hold Sk to the single pass's 4,096
    keys. The temporal mid block at model 4 (Sq 3,072, Sk 6,144) goes to
    the d = 64 skewed kernel; every CP shape of the bench's windows routes
    to a kernel whose gate admits its Sk."""
    from diffuman4d_torch.ops import flash_attention as fa
    from diffuman4d_torch.ops.attention import route

    assert route((1, 3072, 20, 64), (1, 6144, 20, 64))[0] == "flash_d64"
    for b, sq, sk, h in [(1, 32768, 65536, 10), (1, 8192, 16384, 20), (1, 2048, 4096, 20),
                         (1, 16384, 65536, 10), (1, 49152, 98304, 10), (1, 12288, 24576, 20),
                         (1, 3072, 6144, 20), (1, 1536, 6144, 20)]:
        name, params = route((b, sq, h, 64), (b, sk, h, 64))
        if name.startswith("single_pass"):
            assert fa.single_pass_ok(sk, params["block_q"], 64, params.get("block_b", 1))
        else:
            assert name == "flash_d64", (sq, sk, name)


@pytest.fixture(scope="module")
def tiny():
    mod, params = jax_unet(TINY)
    unet = port_unet(TINY, params)
    return mod, params, unet


def _inputs(groups: int, seed: int = 1):
    r = np.random.default_rng(seed)
    B = groups * L
    x = r.standard_normal((B, HW, HW, 11)).astype(np.float32)
    if groups == 2:
        x[L:] = 3.0 * x[L:] + 2.0
    t = np.full((B,), 500, np.int32)
    tem = np.tile(np.arange(L, dtype=np.int32), groups)
    pf = r.standard_normal((B, HW, HW, TINY["block_out_channels"][0])).astype(np.float32)
    return x, t, tem, pf


@pytest.mark.parametrize("world,groups", [(2, 2), (4, 2), (4, 1)],
                         ids=["model2-cfg", "model4-cfg", "model4-nocfg"])
def test_cp_unet_forward_matches_jax_and_one_rank(tiny, world, groups):
    from diffuman4d_tpu.parallel.cp_unet import cp_comm_budget, make_cp_unet_apply

    mod, params, unet = tiny
    x, t, tem, pf = _inputs(groups)
    jfn = make_cp_unet_apply(mod, _jax_mesh(world))
    want = np.asarray(jax.jit(lambda p, x, t, tem, pf: jfn(p, x, t, tem, L, pose_features=pf))(
        params, x, t, tem, pf))
    state = {n: p.detach().numpy() for n, p in unet.state_dict().items()}
    res = pdist.spawn_cpu_ranks(worker.cp_unet, world, (TINY, state, x, t, tem, pf, L),
                                timeout_s=TIMEOUT_S)
    for r in res:  # every rank of the model group holds the whole batch
        np.testing.assert_array_equal(r["out"], res[0]["out"])
    np.testing.assert_allclose(res[0]["out"], want, **TOL)
    with torch.no_grad():
        one = unet(*(torch.from_numpy(a) for a in (x, t)), tem_indices=torch.from_numpy(tem),
                   num_frames=L, pose_features=torch.from_numpy(pf)).numpy()
    np.testing.assert_allclose(res[0]["out"], one, **TOL)
    # one K and one V all-gather per 3D transformer layer, as the JAX
    # package's communication model counts them
    budget = cp_comm_budget(mod.config, num_frames=L, latent_hw=HW, groups=groups,
                            n_model=world)
    assert [r["all_gathers"] for r in res] == [budget["expected_all_gathers"]] * world


def test_cp_refusals_match_jax(tiny):
    """Shards may never mix CFG halves, and every shard needs two frames
    (the 3D gating is decided from local shapes): the JAX package's errors."""
    from diffuman4d_tpu.parallel.cp_unet import make_cp_unet_apply as jax_cp

    from diffuman4d_torch.parallel.cp_unet import make_cp_unet_apply
    from diffuman4d_torch.parallel.mesh import Mesh

    mod, params, unet = tiny
    # (model axis, frames, groups, error)
    cases = [(1, 2, 2, "multiple of the CFG group"), (2, 1, 2, "need >= 2")]
    for model, frames, groups, error in cases:
        x, t, tem, pf = (a[: groups * frames] for a in _inputs(groups))
        with pytest.raises(ValueError) as jerr:
            jax_cp(mod, _jax_mesh(model))(params, x, t, tem, frames, pose_features=pf)
        with pytest.raises(ValueError) as perr:
            make_cp_unet_apply(unet, Mesh(1, model))(
                *(torch.from_numpy(a) for a in (x, t, tem)), frames,
                pose_features=torch.from_numpy(pf))
        assert str(perr.value) == str(jerr.value) and error in str(perr.value)


@pytest.mark.parametrize("frames,latent,groups,n", [(16, 128, 2, 2), (24, 128, 1, 4),
                                                     (12, 128, 2, 8)])
def test_comm_budget_matches_jax_at_production(frames, latent, groups, n):
    from diffuman4d_tpu.models.unet import UNetConfig as JaxUNetConfig
    from diffuman4d_tpu.parallel import cp_unet as jcp

    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.parallel import cp_unet as pcp

    assert pcp.three_d_attention_layers(UNetConfig()) == \
        jcp.three_d_attention_layers(JaxUNetConfig())
    got = pcp.cp_comm_budget(UNetConfig(), num_frames=frames, latent_hw=latent, groups=groups,
                             n_model=n)
    assert got == jcp.cp_comm_budget(JaxUNetConfig(), num_frames=frames, latent_hw=latent,
                                     groups=groups, n_model=n)
    assert got["n_3d_layers"] == 11 and got["expected_all_gathers"] == 22
