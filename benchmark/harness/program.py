"""The program under test, the model family's pipeline (built by
``benchmark/families/<family>.py`` from the port's public constructors) in
the port's sampler, and the one general traffic generator that every mix
file drives.

A mix file (``benchmark/traffic/<traffic>.json``) gives the experiment preset
(``exp``: ``demo_3d`` or ``demo_4d``) with its sampler settings stated
(window, stride, rounds, denoising steps, the CFG domains split), the scene
(cameras, frames, image size, frames rendered, scene seed), the frames of
the grid, the round the window resumes at (0: fresh jobs, one after
another; r > 0: a grid state seeded with rounds 1..r complete, resumed into
round r + 1) and the pose-feature budget.

The window is ``SlidingIterativeSampler.execute_tasks``: whole fresh jobs
(round 0; a further job only where the last one's time says it ends within
the seconds) or the resumed round under the sampler's own ``task_budget``
(the seconds over one task as the warm-up predicts it). No intra-round
state is written in it (``checkpoint_every_tasks=0``).

Recorders (public attributes only): the scheduler's ``step`` /
``step_with_aux`` of the first job's window steps, and ``decode``'s input
latents and images.
"""

from __future__ import annotations

import json
import os.path as osp
import shutil
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.reference import data as ref_data
from benchmark.reference import windows as ref_windows
from benchmark.traffic.gridstate import write_state
from benchmark.traffic.scene import make_synthetic_scene

STATE_SEED_OFFSET = 0x5EED


def scene_dir(traffic: dict, cache: str) -> tuple[str, str]:
    """(data dir, scene label) of the mix's scene, rendered once into
    ``cache`` (a marker file says it is complete)."""
    sc = traffic["scene"]
    label = (f"scene_c{sc['cams']}_f{traffic['frames']}_s{sc['image_size']}"
             f"_u{sc['unique_frames']}_seed{sc['seed']}")
    root = osp.join(cache, "scenes")
    done = osp.join(root, label, ".complete")
    if not osp.isfile(done):
        shutil.rmtree(osp.join(root, label), ignore_errors=True)
        make_synthetic_scene(root, label, num_cams=sc["cams"], num_frames=traffic["frames"],
                             image_size=sc["image_size"], seed=sc["seed"],
                             unique_frames=sc["unique_frames"])
        open(done, "w").close()
    return root, label


@dataclass
class Shape:
    """The window's shapes, from the mix and the sampler settings."""

    domain: str
    rows_per_window: int
    windows_per_task: int
    n_denoise: int
    steps_per_alt: int
    total_steps: int
    split_cfg: bool
    cfg_on: bool
    decodes: bool

    @property
    def denoiser_calls_per_step(self) -> int:
        return 2 if (self.cfg_on and self.split_cfg) else 1

    @property
    def denoiser_batch(self) -> int:
        return self.rows_per_window * (2 if self.cfg_on and not self.split_cfg else 1)


@dataclass
class Recorder:
    """Clones of the scheduler's inputs and outputs while ``recording``
    (the first job's window steps, in order), and the decode calls' latents
    and images."""

    recording: bool = True
    steps: list = field(default_factory=list)
    decodes: list = field(default_factory=list)

    def install(self, pipeline) -> None:
        sched = pipeline.scheduler
        for name in ("step", "step_with_aux"):
            setattr(sched, name, self._wrap(getattr(sched, name), name == "step_with_aux"))
        pipeline.decode = self._wrap_decode(pipeline.decode)

    def _wrap(self, fn, has_aux: bool):
        def step(*args, **kw):
            out = fn(*args, **kw)
            if self.recording:
                aux_in = args[3] if has_aux else None
                lat, aux_out = out if has_aux else (out, None)
                self.steps.append({
                    "t_idx": args[1].detach().cpu().numpy().copy(),
                    "x": args[2].detach().clone(),
                    "aux": None if aux_in is None else {k: v.clone() for k, v in aux_in.items()},
                    "out": lat.detach().clone(),
                    "aux_out": None if aux_out is None else {k: v.clone()
                                                             for k, v in aux_out.items()},
                })
            return out
        return step

    def _wrap_decode(self, fn):
        def decode(latents):
            images = fn(latents)
            self.decodes.append((latents, images))
            return images
        return decode


class Program:
    """One configuration under one mix: the model family's pipeline with its
    weights, the scene, the sampler."""

    def __init__(self, cell, seed: int, device, cache: str, image_size: int | None = None,
                 overrides: dict | None = None):
        from diffuman4d_torch.configs.presets import build_config
        from diffuman4d_torch.sampling.loader import DTYPES, sliding_from

        self.cell, self.family = cell, cell.family
        self.seed, self.device = int(seed), torch.device(device)
        # ``overrides``: {config key: {sub-key: value}} merged into the
        # configuration's groups (the tests' tiny widths)
        self.config = {**cell.config, **{k: {**cell.config[k], **v}
                                         for k, v in (overrides or {}).items()}}
        config = self.config
        traffic = cell.traffic
        self.size = image_size or config["image_size"]
        self.data_root, self.scene = scene_dir(
            {**traffic, "scene": {**traffic["scene"], "image_size": self.size}}, cache)
        self.out_root = osp.join(cache, "out", cell.name)
        shutil.rmtree(self.out_root, ignore_errors=True)
        self.cfg = build_config([
            f"exp={traffic['exp']}", f"data.data_dir={self.data_root}",
            f"data.scene_label={self.scene}", f"data.height={self.size}",
            f"data.width={self.size}", f"sampler.seed={self.seed}",
        ] + [f"sampler.{k}={json.dumps(v)}"
             for k, v in self.family.sampler_settings(config).items()] + [
            f"sampler.tem_label_range=[0, {traffic['frames']}, 1]",
            f"sampler.output_dir={osp.join(self.out_root, 'job0')}",
        ] + [f"sampler.{k}={json.dumps(v)}" for k, v in traffic["sampler"].items()])
        self.dtype = DTYPES[config["dtype"]]
        self.sliding = sliding = sliding_from(self.cfg.sampler)
        self.pipeline = self.family.build_pipeline(self)
        sm = traffic["sampler"]
        rounds = sm["alternation_rounds"]
        steps_per_alt, total_steps = ref_windows.step_counts(
            sm["window_size"], sm["sliding_stride"], sm["num_denoising_steps"], False, rounds)
        r = traffic["resume_round"]
        domain = ["spatial", "temporal"][r % 2]
        n_inputs = len(self.cfg.sampler.input_spa_labels)
        n_targets = traffic["scene"]["cams"] - n_inputs if domain == "spatial" \
            else traffic["frames"]
        n_in = n_inputs if domain == "spatial" else n_targets
        windows = ref_windows.windows(np.arange(n_in, n_in + n_targets), np.arange(n_in),
                                      domain, sliding.window_size, sliding.sliding_stride,
                                      sliding.sliding_shift, sliding.bidirectional)
        self.shape = Shape(
            domain=domain,
            rows_per_window=windows.shape[1],
            windows_per_task=windows.shape[0],
            n_denoise=sliding.num_denoising_steps, steps_per_alt=steps_per_alt,
            total_steps=total_steps, split_cfg=domain in sliding.split_cfg_domains,
            cfg_on=sliding.do_cfg, decodes=r == rounds - 1)

    # -- set-up ---------------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def task_seconds(self, step_s: float) -> float:
        sh = self.shape
        return sh.windows_per_task * sh.n_denoise * step_s * 1.05 + 1.0

    def build_sampler(self, job: int, **kw):
        from diffuman4d_torch.cli import build_sampler

        self.cfg.sampler.output_dir = osp.join(self.out_root, f"job{job}")
        return build_sampler(self.cfg, self.pipeline, checkpoint_every_tasks=0, **kw)

    def seed_state(self) -> dict[str, np.ndarray]:
        """Write a grid state with rounds 1..resume_round complete into job
        0's output directory: latents from the seed, targets at the round's
        end index, inputs at 0, and for a multistep scheduler its history
        (every target with a previous x0). Returns the arrays written."""
        sh, cfg, tr = self.shape, self.cfg, self.cell.traffic
        S, T = tr["scene"]["cams"], tr["frames"]
        lat = self.pipeline.latent_size
        gen = torch.Generator(device=self.device).manual_seed(self.seed + STATE_SEED_OFFSET)
        grid = torch.randn((S, T, lat, lat, 4), generator=gen, device=self.device)
        arrays = {"latents": grid.to(torch.bfloat16).view(torch.int16).cpu().numpy()
                  .view(np.uint16)}
        targets = np.array([i not in cfg.sampler.input_spa_labels for i in range(S)])
        if self.pipeline.scheduler.has_aux:
            prev = 0.5 * torch.randn((S, T, lat, lat, 4), generator=gen, device=self.device)
            arrays["aux_has_prev"] = np.repeat(targets[:, None], T, axis=1)
            arrays["aux_prev_x0"] = prev.cpu().numpy()
        t_idx = np.zeros((S, T), np.int32)
        t_idx[targets] = tr["resume_round"] * sh.steps_per_alt
        arrays["t_idx"] = t_idx
        meta = {"seed": self.seed, "completed_rounds": tr["resume_round"],
                "tasks_done_in_round": 0, "bf16_bits": ["latents"]}
        write_state(osp.join(self.out_root, "job0", "state", "grid_state.d4d"), meta, arrays)
        return arrays

    # -- labels of the tasks ------------------------------------------------
    def task_labels(self, sampler, task) -> list[tuple[str, str, str]]:
        """The rows of ``task`` as the reference loader names them (the
        temporal condition track by the reference's own nearest camera)."""
        scene = self.scene
        if task.domain == "spatial":
            return [(scene, s, task.domain_label) for s in sampler.spa_labels]
        cams = ref_data.parse_cameras(osp.join(self.data_root, scene, "transforms.json"))
        cond = ref_data.nearest_input(cams, task.domain_label, sampler.input_spa_labels)
        return [(scene, spa, tem) for spa in (cond, task.domain_label)
                for tem in sampler.tem_labels]

    def task_is_cond(self, sampler, task) -> np.ndarray:
        """Which rows of ``task`` (as :meth:`task_labels` orders them) are
        conditional: input cameras in a spatial task, the condition track
        (the first half) in a temporal one."""
        labels = self.task_labels(sampler, task)
        if task.domain == "spatial":
            return np.array([lb[1] in sampler.input_spa_labels for lb in labels])
        return np.arange(len(labels)) < len(labels) // 2

    def task_cells(self, sampler, task) -> tuple[np.ndarray, np.ndarray]:
        """(camera, frame) grid indices of ``task``'s rows."""
        labels = self.task_labels(sampler, task)
        return (np.array([sampler.spa_labels.index(lb[1]) for lb in labels]),
                np.array([sampler.tem_labels.index(lb[2]) for lb in labels]))

    def preload(self, sampler, task) -> None:
        """Load ``task``'s sample now, in set-up, and hand it to the
        sampler's first ``load_sample`` of that task: the window starts with
        its first task's inputs loaded, as the IO thread has them for every
        task of a round but the first."""
        sample = [sampler.load_sample(task)]
        load = sampler.load_sample

        def load_sample(t):
            if t is task and sample:
                return sample.pop()
            return load(t)
        sampler.load_sample = load_sample

    def task_windows(self, sampler, task) -> np.ndarray:
        """The window rows of ``task`` by the reference's schedule."""
        sl = self.pipeline.sliding
        is_cond = self.task_is_cond(sampler, task)
        inputs, targets = np.nonzero(is_cond)[0], np.nonzero(~is_cond)[0]
        return ref_windows.windows(targets, inputs, task.domain, sl.window_size,
                                   sl.sliding_stride, sl.sliding_shift, sl.bidirectional)
