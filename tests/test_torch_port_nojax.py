"""The port never imports jax, flax, optax, orbax, yaml, safetensors or the
JAX package.

``tests/conftest.py`` imports jax into this process, so the check runs in a
fresh interpreter in which ``import jax`` / ``flax`` / ``optax`` / ``orbax``
/ ``yaml`` / ``safetensors`` fail (the card machine has neither PyYAML nor
safetensors): it builds a tiny random-weight model with the port, runs one
demo_3d spatial task through the port's sampler on a synthetic scene and
then demo_4d's three rounds with streamed pose features, stopped by a task
budget and resumed, the skeleton-latent UNet with FreeU under DPM++
(stopped and resumed, its history included) and under Euler, two budgeted
sessions of the demo_4d prefix script,
then two steps of the port's training loop, end to end on the CPU, runs the
port's CLI once (``exp=demo_3d`` at ``model.arch=tiny``, ``device=cpu``,
with the nerfstudio export and the metrics), writes and reloads a
diffusers checkpoint, imports the attention tuner and routes its hot shapes
through the committed dispatch table, imports the forward benchmark, the
port's bench and its two training scripts, the multi-device modules
(``parallel/``, ``ops/context_parallel.py``, the dry run), the tensor-parallel
placement, the preprocessing stages (a visual hull carved on the CPU), the
measurement and demo_4d tools (``profile_*``, ``attn_ceiling``,
``bench_flash_backward``, ``show_schedule``, ``probe_temporal_mem``,
``temporal_wave_proof``, ``demo4d_slice`` / ``_chain`` / ``_report``), and
finally checks that no module of those packages or of ``diffuman4d_tpu``
was loaded."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import sys, tempfile
    for blocked in ("jax", "flax", "optax", "orbax", "yaml", "safetensors"):
        sys.modules[blocked] = None

    import numpy as np
    import torch

    from diffuman4d_torch.data import SpaTemDataset, make_synthetic_scene
    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.sampling.loader import build_models
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline, SlidingConfig
    from diffuman4d_torch.sampling.sampler import SlidingIterativeSampler
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig

    unet_cfg = UNetConfig(block_out_channels=(8, 8, 16, 16), num_attention_heads=(1, 1, 2, 2),
                          layers_per_block=1, norm_num_groups=4)
    unet, vae = build_models(unet_cfg, VAEConfig(block_out_channels=(4, 4, 8, 8),
                                                 layers_per_block=1),
                             device="cpu", dtype=torch.float32, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp_dir_gone = tmp + "/none"
        make_synthetic_scene(tmp, "scene0", num_cams=6, num_frames=1, image_size=64)
        pipe = Diffuman4DPipeline(unet, vae, Scheduler(SchedulerConfig()),
                                  SlidingConfig(window_size=2, alternation_rounds=1),
                                  image_size=64)
        sampler = SlidingIterativeSampler(
            SpaTemDataset(data_dir=tmp, scene_label="scene0", height=64, width=64), pipe,
            output_dir=tmp + "/out", spa_label_range=(0, 6, 1), tem_label_range=(0, 1, 1),
            input_spa_labels=[0, 3])
        sampler.execute_tasks()
        assert torch.isfinite(sampler.grid_latents).all()
        assert sorted(set(sampler.grid_t_idx.ravel().tolist())) == [0, 2]

        # demo_4d's schedule at the tiny shape: a run stopped by its task
        # budget within the temporal round (whose tasks stream their pose
        # features) and resumed equals the uninterrupted run
        make_synthetic_scene(tmp + "/d", "scene0", num_cams=6, num_frames=4, image_size=64)

        def demo4d(out, **kw):
            streamed = Diffuman4DPipeline(
                unet, vae, Scheduler(SchedulerConfig()),
                SlidingConfig(window_size=2, sliding_stride=2, alternation_rounds=3,
                              split_cfg_domains=("temporal",)),
                image_size=64, pose_cache_mb=0)
            return SlidingIterativeSampler(
                SpaTemDataset(data_dir=tmp + "/d", scene_label="scene0", height=64, width=64),
                streamed, output_dir=out, spa_label_range=(0, 6, 1), tem_label_range=(0, 4, 1),
                input_spa_labels=[0, 3], **kw)

        full = demo4d(tmp + "/d_full")
        full.execute_tasks()
        part = demo4d(tmp + "/d_part", task_budget=6)
        part.execute_tasks()
        assert part._tasks_run == 6 and part._completed_rounds == 1
        resumed = demo4d(tmp + "/d_part")
        assert (resumed._completed_rounds, resumed._resume_tasks_done) == (1, 2)
        resumed.execute_tasks()
        assert torch.equal(resumed.grid_latents, full.grid_latents)
        assert (resumed.grid_t_idx == full.grid_t_idx).all()

        # the checkpoint variants: the skeleton-latent UNet with FreeU under
        # DPM++ (its history in the grid and the state; stopped by a task
        # budget and resumed) and under Euler
        import dataclasses

        from diffuman4d_torch.models.freeu import FreeUConfig

        skel_unet, skel_vae = build_models(
            dataclasses.replace(unet_cfg, in_channels=15, enable_pose_encoder=False,
                                freeu=tuple(FreeUConfig())),
            VAEConfig(block_out_channels=(4, 4, 8, 8), layers_per_block=1),
            device="cpu", dtype=torch.float32, seed=1)

        def variant(out, kind, **kw):
            p = Diffuman4DPipeline(skel_unet, skel_vae, Scheduler(SchedulerConfig(kind=kind)),
                                   SlidingConfig(window_size=2, sliding_stride=2,
                                                 alternation_rounds=2,
                                                 split_cfg_domains=("temporal",)),
                                   image_size=64)
            return SlidingIterativeSampler(
                SpaTemDataset(data_dir=tmp + "/d", scene_label="scene0", height=64, width=64),
                p, output_dir=out, spa_label_range=(0, 6, 1), tem_label_range=(0, 4, 1),
                input_spa_labels=[0, 3], **kw)

        full = variant(tmp + "/v_full", "dpm++")
        full.execute_tasks()
        variant(tmp + "/v_part", "dpm++", task_budget=5).execute_tasks()
        resumed = variant(tmp + "/v_part", "dpm++")
        assert (resumed._completed_rounds, resumed._resume_tasks_done) == (1, 1)
        resumed.execute_tasks()
        assert torch.equal(resumed.grid_latents, full.grid_latents)
        assert all(torch.equal(resumed.grid_aux[k], full.grid_aux[k]) for k in full.grid_aux)
        euler = variant(tmp + "/v_euler", "euler")
        euler.execute_tasks()
        assert torch.isfinite(euler.grid_latents).all()

        # the prefix script: a budgeted session on the 48 x 150 grid, then a resume
        from diffuman4d_torch import demo4d_prefix

        for budget in ("2", "1"):
            assert demo4d_prefix.main(["--scene", tmp + "/p", "--out", tmp + "/p_out",
                                       "--size", "64", "--arch", "tiny", "--device", "cpu",
                                       "--task-budget", budget]) == 0
        from diffuman4d_torch.io.gridstate import read_state

        meta, _ = read_state(tmp + "/p_out/state/grid_state.d4d")
        assert (meta["completed_rounds"], meta["tasks_done_in_round"]) == (0, 3)

        # the train path: two steps (one spatial, one temporal window batch)
        from diffuman4d_torch.training.data import WindowBatcher, WindowBatcherConfig
        from diffuman4d_torch.training.loop import LoopConfig, train
        from diffuman4d_torch.training.trainer import TrainConfig

        make_synthetic_scene(tmp + "/t", "scene0", num_cams=6, num_frames=2, image_size=64)
        batcher = WindowBatcher(
            SpaTemDataset(data_dir=tmp + "/t", scene_label="scene0", height=64, width=64),
            WindowBatcherConfig(window_size=2, tem_labels=["000000", "000001"],
                                input_spa_labels=["00", "03"]))
        before = unet.conv_in.weight.detach().clone()
        state = train(pipe, batcher, LoopConfig(steps=2, window_size=2, out_dir=tmp + "/run"),
                      TrainConfig(learning_rate=1e-3))
        assert state.step == 2 and not torch.equal(before, unet.conv_in.weight)
        assert all(torch.isfinite(p).all() for p in state.params.values())

        # the CLI: production demo_3d's preset at the tiny shape, on the CPU
        from diffuman4d_torch import cli

        make_synthetic_scene(tmp + "/c", "scene0", num_cams=6, num_frames=1, image_size=64)
        out = tmp + "/cli"
        assert cli.main(["exp=demo_3d", f"data.data_dir={tmp}/c", "data.scene_label=scene0",
                         "data.height=64", "data.width=64", "model.arch=tiny",
                         "model.dtype=fp32", "sampler.spa_label_range=[0,6,1]",
                         "sampler.input_spa_labels=[0,3]", "sampler.window_size=2",
                         f"sampler.output_dir={out}", "evaluating=true", "device=cpu"]) == 0
        import json

        assert len(json.load(open(out + "/metrics.json"))["values"]) == 4
        assert len(json.load(open(out + "/transforms.json"))["frames"]) == 6

        # a diffusers directory, written and read without the safetensors package
        from diffuman4d_torch.io.checkpoints import load_hf_checkpoint, save_hf_checkpoint

        save_hf_checkpoint(tmp + "/model", unet, vae)
        ucfg, _, _, ustate, _ = load_hf_checkpoint(tmp + "/model", dtype=torch.float32)
        assert ucfg == unet.config
        assert all(torch.equal(v, ustate[k]) for k, v in unet.state_dict().items())

    # the attention tuner's entry point and the table-driven route
    from diffuman4d_torch import tune_attention
    from diffuman4d_torch.ops.attention import _dispatch_table, route
    from diffuman4d_torch.ops.flash_attention import KERNELS

    assert len(_dispatch_table()) == len(tune_attention.HOT_SHAPES)
    for _, b, s, h, d in tune_attention.HOT_SHAPES:
        assert route((b, s, h, d), (b, s, h, d))[0] in KERNELS
    assert tune_attention.main(["--quick"]) == 2  # no card: refuses to sweep
    from diffuman4d_torch import bench_attention_fwd

    assert bench_attention_fwd.main(["--baseline", "."]) == 2  # no card: refuses to time
    # the measurement entry points: the bench and the two training scripts
    from diffuman4d_torch import bench, train_run_chip, train_step_chip

    assert bench.BASELINE_CAM_FRAMES_PER_SEC == 0.55
    # the multi-device modules: the rank mesh, the process group, context
    # parallelism and the dry run (its ranks are spawned, each jax-free too)
    from diffuman4d_torch import dryrun_multichip
    from diffuman4d_torch.ops import context_parallel
    from diffuman4d_torch.parallel import cp_unet, distributed, mesh

    assert distributed.initialize("cpu") is False and mesh.make_mesh().size == 1
    assert cp_unet.cp_comm_budget(UNetConfig(), 16, 128)["expected_all_gathers"] == 22
    assert context_parallel.cp_attention_grouped.all_gathers == 0
    assert dryrun_multichip.SCENE["num_cams"] == 6
    assert train_step_chip.parse_args([]).optimizer == "adafactor"
    assert train_run_chip.summarize(tmp_dir_gone) == {"error": "no metrics yet"}
    # data- and tensor-parallel training: the placement on a model axis of 2
    assert set(mesh.shard_params_for_tp(dict(unet.named_parameters()), mesh.Mesh(1, 2),
                                        min_size=2**10).values()) == {None, 0}
    # the preprocessing stages: the modules, and a hull carved on the CPU
    from diffuman4d_torch.preprocess import (  # noqa: F401
        background, dna_extract, download, draw_skeleton, keypoints, pipeline, skeleton_data,
        triangulate, visual_hull)

    yy, xx = np.mgrid[0:32, 0:32]
    P = np.array([[[40.0, 0, 16, 0], [0, 40, 16, 0], [0, 0, 1, 3]]], np.float32)
    hull = visual_hull.carve_visual_hull(((xx - 16) ** 2 + (yy - 16) ** 2 < 64)[None], P,
                                         bounds=(-1, 1, -1, 1, -1, 1), voxel_size=0.1,
                                         device="cpu")
    assert len(hull) > 0
    # the measurement and demo_4d tools, and their shared frame
    from diffuman4d_torch import (  # noqa: F401
        attn_ceiling, bench_flash_backward, demo4d_chain, demo4d_report, demo4d_slice,
        probe_temporal_mem, profile_unet_units, profile_units, profile_vae, profile_vae_conv,
        profile_window, show_schedule, temporal_wave_proof)
    from diffuman4d_torch.utils import units  # noqa: F401

    assert probe_temporal_mem.schedule("temporal", 8)["chunk"] == 5
    assert profile_units.plan("tiny") and show_schedule.main(["--device", "cpu"]) == 0
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml",
                                           "safetensors", "diffuman4d_tpu")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    print("PORT_OK")
""")


def test_port_runs_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    # tiny shapes run as fast on one thread; a thread per core would contend
    # with the other test workers' threads
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "PORT_OK" in proc.stdout
