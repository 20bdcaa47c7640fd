"""Grid-state files crossing between the JAX package and the port: fresh
states are byte-equal, the port resumes a JAX-written state and the JAX
package a port-written one, both with the JAX package's noise, within the
slice test's tolerance (the setup is ``tests/torch_port_resume_setup.py``;
the port's own resume tests are ``tests/test_torch_port_resume.py``)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from tests.torch_port_helpers import one_torch_thread  # noqa: F401 -- an autouse fixture
from tests.torch_port_resume_setup import (  # noqa: F401 -- env is a fixture
    LATENT_ATOL,
    _jax,
    _jpegs,
    _port,
    _run_tasks,
    _shared_loads,
    env,
)


@pytest.fixture(scope="module")
def jref(env):
    """The JAX package's uninterrupted run."""
    s = _jax(env, env.root / "jref")
    s.execute_tasks()
    return s


# ------------------------------------------------------------- across packages
def _port_jax_noise(env, out, **kw):
    """A port sampler on the cross-package pipeline, its grid noise drawn
    from the JAX keys, served the shared loads."""
    from diffuman4d_torch.sampling import pipeline as pp

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pp.Diffuman4DPipeline, "init_noise",
                   lambda self, spa, tem, seed: env.jnoise.init_noise(spa, tem, seed))
        return _shared_loads(env, _port(env, out, pipe=env.xpipe, **kw))


def _assert_close_to_jax(jref, got):
    np.testing.assert_array_equal(got.grid_t_idx, np.asarray(jref.grid_t_idx))
    np.testing.assert_allclose(np.asarray(got.grid_latents, np.float32),
                               np.asarray(jref.grid_latents), rtol=0, atol=LATENT_ATOL)
    names = lambda s: sorted(_jpegs(s.output_dir))  # noqa: E731
    assert names(got) == names(jref) and len(names(got)) == 24


def test_fresh_states_are_byte_equal_across_packages(env, tmp_path):
    port = _port_jax_noise(env, tmp_path / "port")
    jax_s = _jax(env, tmp_path / "jax")
    port.save_state(tasks_done=2)
    jax_s.save_state(tasks_done=2)
    assert Path(port._state_path).read_bytes() == Path(jax_s._state_path).read_bytes()


def test_jax_state_resumes_in_the_port(env, jref, tmp_path):
    jpart = _jax(env, tmp_path)
    for i, task in enumerate(jpart.all_tasks[0]):
        jpart.execute_one_task(task, jpart._task_key(0, i))
    jpart.execute_one_task(jpart.all_tasks[1][0], jpart._task_key(1, 0))
    jpart._completed_rounds = 1
    jpart.save_state(tasks_done=1)
    written = Path(jpart._state_path).read_bytes()
    del jpart
    port = _port_jax_noise(env, tmp_path)
    assert (port._completed_rounds, port._resume_tasks_done) == (1, 1)
    port.save_state(tasks_done=1)  # read and written back: the same bytes
    assert Path(port._state_path).read_bytes() == written
    port.execute_tasks()
    _assert_close_to_jax(jref, port)


def test_port_state_resumes_in_jax(env, jref, tmp_path):
    from diffuman4d_tpu.io.gridstate import read_state

    _run_tasks(_port_jax_noise(env, tmp_path), 1, 1)
    resumed = _jax(env, tmp_path)
    assert (resumed._completed_rounds, resumed._resume_tasks_done) == (1, 1)
    resumed.execute_tasks()
    _assert_close_to_jax(jref, resumed)
    meta, _ = read_state(resumed._state_path)
    assert (meta["completed_rounds"], meta["tasks_done_in_round"]) == (3, 0)
