"""The port's CLI end to end against the JAX package.

One tiny synthetic scene (6 cameras x 2 frames at 64^2, inputs [0, 3]),
window 2, two alternation rounds (spatial, then temporal with split CFG),
``evaluating=true``, fp32 compute over the default bf16 weight storage.
The weights are one diffusers directory that the JAX package's
``save_hf_checkpoint`` writes from perturbed tiny params; both sides load
it. The port runs through ``diffuman4d_torch.cli.main([..., "device=cpu"])``
with the JAX package's noise injected; the JAX side runs through the
pieces its CLI calls (``build_config`` -> ``load_pipeline`` ->
``SlidingIterativeSampler.execute_tasks`` -> ``export_to_nerfstudio`` ->
``evaluate_results``), which keeps its XLA compiles short. Both write the
grid state; the port's must carry the JAX package's meta and timestep
indices, its latents within the slice test's tolerance. A second port call
on the finished directory resumes, runs no task and exports again, and
``save_debug_grids=true`` writes the JAX package's file set."""

from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

IMAGE = 64
LATENT = IMAGE // 8
ARGS = [
    "data.scene_label=scene0",
    f"data.height={IMAGE}",
    f"data.width={IMAGE}",
    "model.arch=tiny",
    "model.dtype=fp32",
    "model.attn_implementation=xla",
    "sampler.spa_label_range=[0,6,1]",
    "sampler.tem_label_range=[0,2,1]",
    "sampler.input_spa_labels=[0,3]",
    "sampler.window_size=2",
    "sampler.alternation_rounds=2",
    "evaluating=true",
]
# written by the port's CLI only: its run logs and counters
NOT_COMPARED = ("config_tree.log", "job.log", "counters.json")
# the grid states' latents: fp32 on both sides, summation order only (the
# slice test's bound)
LATENT_ATOL = 2e-4
# the JPEGs on disk: decoded images within one uint8 level (in 0.004% of
# their values here) re-encoded at quality 95 may move by a few levels
# around such a value; measured here: equal
JPEG_MAX_DIFF = 4
JPEG_MEAN_DIFF = 0.01
# metrics of those JPEGs against the same ground truth (measured here:
# 1.1e-5 dB and 1.3e-6: fp32 sums in another order, fp64 SSIM blurs)
PSNR_ATOL = 1e-3
SSIM_ATOL = 1e-4


def _files(root: Path) -> list[str]:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*")
                  if p.is_file() and not p.relative_to(root).as_posix().startswith(NOT_COMPARED))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX output dir, port output dir, JAX decodes, port decodes, rc, JAX
    pipeline)."""
    from diffuman4d_tpu.configs.presets import build_config as jbuild_config
    from diffuman4d_tpu.data.dataset import SpaTemDataset as JDataset
    from diffuman4d_tpu.data.metrics import evaluate_results as jevaluate
    from diffuman4d_tpu.data.synthetic import make_synthetic_scene
    from diffuman4d_tpu.io import native as jnative
    from diffuman4d_tpu.io.checkpoints import save_hf_checkpoint
    from diffuman4d_tpu.io.nerfstudio import export_to_nerfstudio as jexport
    from diffuman4d_tpu.models.unet import UNetConfig
    from diffuman4d_tpu.models.vae import VAEConfig
    from diffuman4d_tpu.sampling.loader import load_pipeline as jload
    from diffuman4d_tpu.sampling.sampler import SlidingIterativeSampler as JSampler
    from diffuman4d_tpu.utils.tracing import dump_report
    from diffuman4d_torch import cli
    from diffuman4d_torch.sampling.loader import TINY_UNET, TINY_VAE
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline
    from tests.torch_port_helpers import jax_unet, jax_vae

    root = tmp_path_factory.mktemp("cli")
    data, model = root / "data", root / "model"
    make_synthetic_scene(str(data), "scene0", num_cams=6, num_frames=2, image_size=IMAGE)
    # the loader's model.arch=tiny shape, with perturbed weights
    _, uparams = jax_unet(TINY_UNET)
    _, vparams = jax_vae(TINY_VAE)
    save_hf_checkpoint(str(model), {"unet": uparams, "vae": vparams}, UNetConfig(**TINY_UNET),
                       VAEConfig(**TINY_VAE))
    args = ARGS + [f"data.data_dir={data}", f"model.model_dir={model}"]

    # the JAX side, through the pieces of its CLI
    jax_out = root / "jax"
    cfg = jbuild_config(args + [f"sampler.output_dir={jax_out}"])
    jnative.available()  # settles its decoder lookup before any threaded load
    dataset = JDataset(data_dir=cfg.data.data_dir, scene_label=cfg.data.scene_label,
                       height=cfg.data.height, width=cfg.data.width,
                       has_gt_target=cfg.data.has_gt_target, skeletons_uint8=True)
    jpipe = jload(cfg.model, cfg.sampler, cfg.data)
    jdecoded: list = []
    decode = jpipe.decode
    jpipe.decode = lambda latents: jdecoded.append(np.asarray(decode(latents))) or jdecoded[-1]
    jsampler = JSampler(dataset, jpipe, output_dir=cfg.sampler.output_dir,
                        spa_label_range=cfg.sampler.spa_label_range,
                        tem_label_range=cfg.sampler.tem_label_range,
                        input_spa_labels=cfg.sampler.input_spa_labels, seed=cfg.sampler.seed)
    jsampler.execute_tasks()
    dump_report(str(jax_out / "phases.json"))
    jexport(str(data / "scene0"), str(jax_out), jsampler.input_spa_labels)
    jevaluate(str(data), "scene0", str(jax_out), jsampler.input_spa_labels)

    # the port, through its CLI, with the JAX package's noise
    port_out = root / "port"
    pdecoded: list = []
    pdecode = Diffuman4DPipeline.decode
    with pytest.MonkeyPatch.context() as mp:
        _inject_jax_noise(mp, jpipe)
        mp.setattr(Diffuman4DPipeline, "decode", lambda self, latents:
                   pdecoded.append(pdecode(self, latents)) or pdecoded[-1])
        rc = cli.main(args + [f"sampler.output_dir={port_out}", "device=cpu"])
    return jax_out, port_out, jdecoded, pdecoded, rc, jpipe


def _inject_jax_noise(mp, jpipe) -> None:
    """The port's pipeline draws the JAX pipeline's initial and posterior
    noise (``ROADMAP.md`` C.4)."""
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline

    mp.setattr(Diffuman4DPipeline, "init_noise", lambda self, spa, tem, seed:
               torch.from_numpy(np.array(jpipe.init_noise(spa, tem, seed))))
    mp.setattr(Diffuman4DPipeline, "posterior_noise", lambda self, labels: torch.stack([
        torch.from_numpy(np.array(jax.random.normal(
            jpipe._frame_key(lb), (LATENT, LATENT, 4)))) for lb in labels]))


def test_cli_writes_the_jax_package_files(runs):
    jax_out, port_out, _, _, rc, _ = runs
    assert rc == 0
    files = _files(port_out)
    assert files == _files(jax_out)
    assert len([f for f in files if f.startswith("images/")]) == 12  # 6 cameras x 2 frames
    assert {"metrics.json", "phases.json", "transforms.json", "transforms_input.json",
            "export_manifest.json"} <= set(files)
    assert (port_out / "config_tree.log").is_file() and (port_out / "job.log").is_file()
    for name in ("transforms.json", "transforms_input.json", "export_manifest.json"):
        assert json.loads((port_out / name).read_text()) == json.loads((jax_out / name).read_text())
    frames = json.loads((port_out / "transforms_input.json").read_text())["frames"]
    assert {f["camera_label"] for f in frames} == {"00", "03"}
    phases = json.loads((port_out / "phases.json").read_text())
    assert {"cli/sampling", "cli/to_nerfstudio", "cli/evaluate", "task/sliding_denoise"} <= set(
        phases)
    assert phases["task/sliding_denoise"]["count"] == 6  # 2 spatial + 4 temporal tasks
    assert json.loads((port_out / "counters.json").read_text())["sampler/tasks"] == 6


def test_cli_grid_state_matches_jax(runs):
    from diffuman4d_torch.io.gridstate import read_state

    jax_out, port_out, _, _, _, _ = runs
    meta, got = read_state(str(port_out / "state" / "grid_state.d4d"))
    jmeta, want = read_state(str(jax_out / "state" / "grid_state.d4d"))
    assert meta == jmeta == {"seed": 0, "completed_rounds": 2, "tasks_done_in_round": 0,
                             "bf16_bits": []}
    assert list(got) == list(want) == ["latents", "t_idx"]
    np.testing.assert_array_equal(got["t_idx"], want["t_idx"])
    assert got["latents"].dtype == want["latents"].dtype == np.float32
    np.testing.assert_allclose(got["latents"], want["latents"], rtol=0, atol=LATENT_ATOL)


def _cli_args(port_out: Path) -> list[str]:
    root = port_out.parent
    return ARGS + [f"data.data_dir={root / 'data'}", f"model.model_dir={root / 'model'}"]


def test_cli_on_a_finished_directory_resumes_and_exports_again(runs, tmp_path, capsys):
    import shutil

    from diffuman4d_torch import cli

    _, port_out, _, _, _, _ = runs
    out = tmp_path / "again"
    shutil.copytree(port_out, out)
    before = {rel: (out / rel).read_bytes() for rel in _files(out)
              if rel.startswith(("images/", "state/"))}
    (out / "metrics.json").unlink()
    (out / "transforms.json").unlink()
    assert cli.main(_cli_args(port_out) + [f"sampler.output_dir={out}", "device=cpu"]) == 0
    assert {rel: (out / rel).read_bytes() for rel in before} == before
    assert (out / "metrics.json").is_file() and (out / "transforms.json").is_file()
    phases = json.loads((out / "phases.json").read_text())
    assert {"cli/sampling", "cli/to_nerfstudio", "cli/evaluate"} <= set(phases)
    assert not any(k.startswith("task/") for k in phases)  # no task ran
    assert "[sampler] resumed after round 2\n" in capsys.readouterr().out


def test_cli_debug_grids_write_the_jax_package_files(runs, tmp_path):
    """``sampler.save_debug_grids=true``: one grid per task, as the JAX
    sampler writes them."""
    from diffuman4d_tpu.configs.presets import build_config as jbuild_config
    from diffuman4d_tpu.data.dataset import SpaTemDataset as JDataset
    from diffuman4d_tpu.sampling.loader import load_pipeline as jload
    from diffuman4d_tpu.sampling.sampler import SlidingIterativeSampler as JSampler
    from diffuman4d_torch import cli

    _, port_out, _, _, _, _ = runs
    args = _cli_args(port_out) + ["sampler.save_debug_grids=true", "evaluating=false",
                                  "to_nerfstudio=false"]
    cfg = jbuild_config(args + [f"sampler.output_dir={tmp_path / 'jax'}"])
    dataset = JDataset(data_dir=cfg.data.data_dir, scene_label=cfg.data.scene_label,
                       height=cfg.data.height, width=cfg.data.width, skeletons_uint8=True)
    JSampler(dataset, jload(cfg.model, cfg.sampler, cfg.data), output_dir=cfg.sampler.output_dir,
             spa_label_range=cfg.sampler.spa_label_range,
             tem_label_range=cfg.sampler.tem_label_range,
             input_spa_labels=cfg.sampler.input_spa_labels,
             save_debug_grids=True).execute_tasks()
    assert cli.main(args + [f"sampler.output_dir={tmp_path / 'port'}", "device=cpu"]) == 0
    port = [f for f in _files(tmp_path / "port") if f != "phases.json"]
    assert port == _files(tmp_path / "jax")
    grids = [f for f in port if f.startswith("grids/")]
    # 2 spatial tasks (one per frame), then 4 temporal (one per target camera)
    assert grids == ["grids/alt1_tem000000.jpg", "grids/alt1_tem000001.jpg",
                     "grids/alt2_spa01.jpg", "grids/alt2_spa02.jpg", "grids/alt2_spa04.jpg",
                     "grids/alt2_spa05.jpg"]


def test_cli_images_match_jax(runs):
    jax_out, port_out, jdecoded, pdecoded, _, _ = runs
    # the temporal round decodes its 4 target cameras' 2 frames each
    assert len(pdecoded) == len(jdecoded) == 4
    got, want = np.concatenate(pdecoded).astype(int), np.concatenate(jdecoded).astype(int)
    assert got.shape == want.shape == (8, IMAGE, IMAGE, 3)
    assert np.abs(got - want).max() <= 1
    assert np.mean(got == want) > 0.99
    for rel in _files(port_out):
        if rel.startswith("images/"):
            a = np.asarray(Image.open(port_out / rel), np.int32)
            b = np.asarray(Image.open(jax_out / rel), np.int32)
            assert np.abs(a - b).max() <= JPEG_MAX_DIFF, rel
            assert np.abs(a - b).mean() <= JPEG_MEAN_DIFF, rel


def test_cli_metrics_match_jax(runs):
    jax_out, port_out, _, _, _, _ = runs
    got = json.loads((port_out / "metrics.json").read_text())
    want = json.loads((jax_out / "metrics.json").read_text())
    assert [v["key"] for v in got["values"]] == [v["key"] for v in want["values"]]
    assert len(got["values"]) == 8  # 4 target cameras x 2 frames
    for g, w in zip(got["values"], want["values"]):
        assert abs(g["psnr"] - w["psnr"]) <= PSNR_ATOL, g["key"]
        assert abs(g["ssim"] - w["ssim"]) <= SSIM_ATOL, g["key"]
        assert np.isnan(g["lpips"]) and np.isnan(w["lpips"])
    assert got["mean"]["lpips"] is None and want["mean"]["lpips"] is None


# ------------------------------------------------------------------ refusals
def test_cli_without_a_card_exits_and_never_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    from diffuman4d_torch import cli
    from diffuman4d_torch.sampling import loader

    def refuse(*a, **k):
        raise AssertionError("the CLI built a pipeline without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(loader, "load_pipeline", refuse)
    out = tmp_path / "out"
    assert cli.main(ARGS + [f"sampler.output_dir={out}"]) != 0
    assert cli.main(ARGS + [f"sampler.output_dir={out}", "device=cuda"]) != 0
    assert "device=cpu" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("override", ["sampler.tasks_per_wave=2",
                                      "sampler.split_cfg_domains=[spatial,frames]"])
def test_cli_refuses_options_not_ported(runs, tmp_path, override):
    """Two overrides that the JAX CLI runs and the port's CLI refused until
    it gained them: ``tasks_per_wave`` is read by nothing there, and its
    pipeline only tests ``split_cfg_domains`` for membership (so
    ``[spatial,frames]`` splits the spatial CFG and fuses the temporal one:
    the same function in another batching). The port's CLI with each, the
    JAX draws injected, refuses neither and writes the JAX CLI's files and
    its grid state."""
    from diffuman4d_tpu.configs.presets import build_config as jbuild_config
    from diffuman4d_torch import cli
    from diffuman4d_torch.io.gridstate import read_state
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline

    jax_out, port_out, _, _, _, jpipe = runs
    jcfg = jbuild_config(_cli_args(port_out) + [override])
    pipes: list = []
    init = Diffuman4DPipeline.__init__
    out = tmp_path / "port"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Diffuman4DPipeline, "__init__", lambda self, *a, **k:
                   init(self, *a, **k) or pipes.append(self))
        _inject_jax_noise(mp, jpipe)
        assert cli.main(_cli_args(port_out) + [f"sampler.output_dir={out}", "device=cpu",
                                               override]) == 0
    assert pipes and set(pipes[0].sliding.split_cfg_domains) == set(jcfg.sampler.split_cfg_domains)
    assert _files(out) == _files(jax_out)
    for name in ("transforms.json", "transforms_input.json", "export_manifest.json"):
        assert json.loads((out / name).read_text()) == json.loads((jax_out / name).read_text())
    meta, got = read_state(str(out / "state" / "grid_state.d4d"))
    jmeta, want = read_state(str(jax_out / "state" / "grid_state.d4d"))
    assert meta == jmeta
    np.testing.assert_array_equal(got["t_idx"], want["t_idx"])
    np.testing.assert_allclose(got["latents"], want["latents"], rtol=0, atol=LATENT_ATOL)
