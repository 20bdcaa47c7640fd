"""The port's demo_4d report and temporal proof against the JAX scripts
on the CPU, at the tiny shape on demo_4d's preset cut to 6 cameras x 4
frames (inputs 0 and 3, window 2):

- ``demo4d_report``'s JSON equals ``scripts/demo4d_report.py``'s on the
  same ``sessions.jsonl``, grid state (written by the JAX package) and
  images tree, but for ``notes``, which in the script record its TPU
  chain's history;
- ``temporal_wave_proof``'s seeded round-1 state is byte-equal to the state
  the script's seeding (``scripts/temporal_wave_proof.py:128-136``) makes
  the JAX sampler write for the same grid, and the temporal task run from
  it passes the sampler's grid checks.

``tests/test_torch_port_tools_chain.py`` holds the chain and the slice."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

from tests.torch_port_helpers import TINY_UNET, TINY_VAE, jax_unet, jax_vae  # noqa: F401
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 -- autouse fixture

ROOT = Path(__file__).resolve().parents[1]
GRID = ["sampler.spa_label_range=[0,6,1]", "sampler.tem_label_range=[0,4,1]",
        "sampler.input_spa_labels=[0,3]", "sampler.window_size=2"]
TINY = ["--device", "cpu", "--arch", "tiny", "--size", "64"]


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_report_equals_the_scripts(tmp_path, monkeypatch, capsys):
    from diffuman4d_tpu.io.gridstate import write_state
    from diffuman4d_torch import demo4d_report

    phases = {"task/sliding_denoise": {"count": 2, "total_s": 3.0, "mean_s": 1.5, "max_s": 2.0}}
    sessions = tmp_path / "sessions.jsonl"
    sessions.write_text("".join(json.dumps(r) + "\n" for r in [
        {"session": 1, "rc": 0, "wall_s": 40, "start_round": 0, "start_tasks": 0, "tasks": 2,
         "exec_s": 30.5, "phases": phases, "complete": False},
        {"session": 2, "rc": 1, "wall_s": 3, "complete": False}]))
    out = tmp_path / "out"
    t_idx = np.zeros((48, 150), np.int32)
    t_idx[2:20] = 6
    t_idx[5, :3] = 12
    write_state(str(out / "state" / "grid_state.d4d"),
                {"seed": 0, "completed_rounds": 1, "tasks_done_in_round": 3, "bf16_bits": []},
                {"latents": np.zeros((48, 150, 1, 1, 4), np.float32), "t_idx": t_idx})
    for cam, frames in (("00", 3), ("07", 2)):
        (out / "images" / cam).mkdir(parents=True)
        for f in range(frames):
            (out / "images" / cam / f"{f:06d}.jpg").write_bytes(b"jpg")
    (out / "images" / "07" / "notes.txt").write_text("not an image")
    (out / "images" / "stray.jpg").write_bytes(b"not in a camera directory")

    monkeypatch.setattr(sys, "argv", ["demo4d_report.py", "--sessions", str(sessions),
                                      "--outdir", str(out), "--out", str(tmp_path / "j.json")])
    _jax_script("demo4d_report").main()
    assert demo4d_report.main(["--sessions", str(sessions), "--outdir", str(out),
                               "--out", str(tmp_path / "p.json"), "--device", "cpu"]) == 0
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "p.json").read_text())
    assert got["images_on_disk"] == 5 and got["grid"]["cells_in_flight"] == 18 * 150
    want.pop("notes"), got.pop("notes")
    assert got == want


def test_temporal_wave_proof_seeds_the_scripts_state(tmp_path, capsys):
    import jax.numpy as jnp

    from diffuman4d_tpu.data.dataset import SpaTemDataset as JDataset
    from diffuman4d_tpu.sampling import pipeline as jp
    from diffuman4d_tpu.sampling.sampler import SlidingIterativeSampler as JSampler
    from diffuman4d_tpu.schedulers import diffusion as jd
    from diffuman4d_torch import temporal_wave_proof
    from diffuman4d_torch.io.gridstate import read_state

    scene, out = tmp_path / "scene", tmp_path / "out"
    assert temporal_wave_proof.main([*TINY, "--task-budget", "1", "--scene", str(scene),
                                     "--out", str(out), *GRID]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["tasks"] == 1 and rep["state"] == [1, 1]
    seeded = (out / "state" / "grid_state_seeded.d4d").read_bytes()
    _, data = read_state(str(out / "state" / "grid_state_seeded.d4d"))

    # the script's seeding on a JAX sampler of the same grid, its latents
    # set to the port's (the two packages draw other noise by design)
    jmod, jparams = jax_unet(TINY_UNET)
    vmod, vparams = jax_vae(TINY_VAE)
    jpipe = jp.Diffuman4DPipeline(
        jmod, vmod, jd.Scheduler(jd.SchedulerConfig(kind="ddim")),
        {"unet": jparams, "vae": vparams},
        sliding=jp.SlidingConfig(window_size=2, sliding_stride=2,
                                 split_cfg_domains=("temporal",)), image_size=64)
    sampler = JSampler(JDataset(data_dir=str(scene), scene_label="0811_06", height=64, width=64),
                       jpipe, output_dir=str(tmp_path / "jax"), spa_label_range=(0, 6, 1),
                       tem_label_range=(0, 4, 1), input_spa_labels=[0, 3])
    sampler.grid_latents = jnp.asarray(np.asarray(data["latents"]))
    spa = jpipe.sliding.steps_per_alt
    input_rows = [sampler._spa_index[s] for s in sampler.input_spa_labels]
    t_idx = np.full(sampler.grid_t_idx.shape, spa, np.int32)
    t_idx[input_rows, :] = 0
    sampler.grid_t_idx = t_idx
    sampler._completed_rounds = 1
    sampler.save_state()
    assert (tmp_path / "jax" / "state" / "grid_state.d4d").read_bytes() == seeded

    # the task ran from it: round 2's first task (camera 01) one step on,
    # the other targets at round 1's end, the inputs at 0
    meta, after = read_state(str(out / "state" / "grid_state.d4d"))
    assert (meta["completed_rounds"], meta["tasks_done_in_round"]) == (1, 1)
    want = t_idx.copy()
    want[1] += spa
    np.testing.assert_array_equal(np.asarray(after["t_idx"]), want)
    assert np.isfinite(np.asarray(after["latents"])).all()
