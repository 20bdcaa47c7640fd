"""Sliding-iterative sampler, serial path (counterpart of
``diffuman4d_tpu/sampling/sampler.py``).

Owns the camera x frame latent grid -- one device tensor (S, T, h, w, 4)
plus an int32 (S, T) timestep-index grid on the host -- and runs the
alternation rounds' tasks one after another. Initial noise is seeded per
grid cell, so results do not depend on task order. Each task's stages are
timed as ``task/*`` phases (``utils/tracing.py``). Task waves over several
devices (``ROADMAP.md`` A.7), grid-state resume and run budgets (A.3.b) and
debug grids (A.3.e) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from diffuman4d_torch.sampling.outputs import check_sampling_results, save_final_images
from diffuman4d_torch.sampling.windows import build_windows
from diffuman4d_torch.data import Sample, SpaTemDataset
from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline
from diffuman4d_torch.utils.tracing import phase


@dataclass
class Task:
    alt: int  # 1-based alternation round
    domain: str  # "spatial" | "temporal"
    domain_label: str  # frame label (spatial) or target camera label (temporal)


class SlidingIterativeSampler:
    def __init__(
        self,
        dataset: SpaTemDataset,
        pipeline: Diffuman4DPipeline,
        output_dir: str = "./results/debug",
        spa_label_range: tuple[int, int, int] | None = (0, 48, 1),
        tem_label_range: tuple[int, int, int] | None = (0, 150, 1),
        spa_labels: list[int] | None = None,
        tem_labels: list[int] | None = None,
        input_spa_labels: list[int] = (1, 13, 25, 37),
        seed: int = 0,
    ):
        self.dataset = dataset
        self.pipeline = pipeline
        self.output_dir = output_dir
        self.seed = seed
        cfg = pipeline.sliding

        if spa_labels is not None:
            self.spa_labels = [f"{int(i):02d}" for i in spa_labels]
        else:
            self.spa_labels = [f"{int(i):02d}" for i in range(*spa_label_range)]
        if tem_labels is not None:
            self.tem_labels = [f"{int(i):06d}" for i in tem_labels]
        else:
            self.tem_labels = [f"{int(i):06d}" for i in range(*tem_label_range)]
        self.input_spa_labels = [f"{int(i):02d}" for i in input_spa_labels]
        self.target_spa_labels = [s for s in self.spa_labels if s not in self.input_spa_labels]

        if cfg.window_size > len(self.target_spa_labels):
            raise ValueError(f"window_size ({cfg.window_size}) > num target cameras "
                             f"({len(self.target_spa_labels)})")
        if len(self.target_spa_labels) % cfg.sliding_stride != 0:
            raise ValueError("num target cameras % sliding_stride != 0")
        if len(self.tem_labels) % cfg.sliding_stride != 0:
            raise ValueError("num frames % sliding_stride != 0")
        if cfg.alternation_rounds > 1 and cfg.window_size > len(self.tem_labels):
            raise ValueError("window_size must be <= num frames when alternation_rounds > 1")

        self._spa_index = {s: i for i, s in enumerate(self.spa_labels)}
        self._tem_index = {t: i for i, t in enumerate(self.tem_labels)}

        S, T = len(self.spa_labels), len(self.tem_labels)
        ss, tt = np.meshgrid(np.arange(S), np.arange(T), indexing="ij")
        noise = pipeline.init_noise(ss.reshape(-1), tt.reshape(-1), seed)
        self.grid_latents = noise.reshape(
            (S, T, pipeline.latent_size, pipeline.latent_size, pipeline.latent_channels))
        self.grid_t_idx = np.zeros((S, T), np.int32)
        self.all_tasks = self.prepare_tasks()
        self._completed_rounds = 0

    def prepare_tasks(self) -> list[list[Task]]:
        """Round i alternates spatial / temporal."""
        rounds = self.pipeline.sliding.alternation_rounds
        domains = (["spatial", "temporal"] * rounds)[:rounds]
        return [
            [Task(i + 1, d, lb)
             for lb in (self.tem_labels if d == "spatial" else self.target_spa_labels)]
            for i, d in enumerate(domains)
        ]

    def _grid_cells(self, labels) -> tuple[np.ndarray, np.ndarray]:
        spa = np.asarray([self._spa_index[lb[1]] for lb in labels])
        tem = np.asarray([self._tem_index[lb[2]] for lb in labels])
        return spa, tem

    def load_sample(self, task: Task) -> Sample:
        if task.domain == "spatial":
            spa_labels, tem_labels = self.spa_labels, [task.domain_label]
        else:
            spa_labels, tem_labels = [task.domain_label], self.tem_labels
        sample = self.dataset.get_item(
            scene_label=self.dataset.scene_label,
            spa_labels=spa_labels,
            tem_labels=tem_labels,
            input_spa_labels=self.input_spa_labels,
        )
        if task.domain == "temporal":
            n = len(sample.labels)
            cm = np.ones(n, np.float32)
            cm[: n // 2] = 0.0
            sample.cond_masks = cm
        return sample

    def _windows_for(self, task: Task, n_rows: int) -> np.ndarray:
        cfg = self.pipeline.sliding
        if task.domain == "spatial":
            targets = np.asarray([i for i, s in enumerate(self.spa_labels)
                                  if s not in self.input_spa_labels])
            inputs = np.asarray([i for i, s in enumerate(self.spa_labels)
                                 if s in self.input_spa_labels])
        else:
            inputs = np.arange(n_rows // 2)
            targets = np.arange(n_rows // 2, n_rows)
        return build_windows(targets, inputs, task.domain, cfg.window_size, cfg.sliding_stride,
                             cfg.sliding_shift, cfg.bidirectional)

    def execute_one_task(self, task: Task, sample: Sample | None = None) -> None:
        if sample is None:
            with phase("task/load_sample"):
                sample = self.load_sample(task)
        spa, tem = self._grid_cells(sample.labels)
        with phase("task/prepare_conditions"):
            cond = self.pipeline.prepare_conditions(sample)
        dev = self.grid_latents.device
        spa_t = torch.from_numpy(spa).to(dev)
        tem_t = torch.from_numpy(tem).to(dev)
        latents = self.grid_latents[spa_t, tem_t]
        t_idx = self.grid_t_idx[spa, tem]
        windows = self._windows_for(task, len(sample.labels))
        with phase("task/sliding_denoise"):
            latents, t_idx = self.pipeline.sliding_denoise(cond, latents, t_idx, windows,
                                                           task.domain)
        self.grid_latents[spa_t, tem_t] = latents
        self.grid_t_idx[spa, tem] = t_idx
        with phase("task/decode_save"):
            self._save_task_outputs(sample, latents, t_idx)

    def _save_task_outputs(self, sample: Sample, latents: torch.Tensor, t_idx: np.ndarray) -> None:
        """Decode and write the fully denoised rows; input rows are written
        as their ground-truth pixels."""
        done = t_idx == self.pipeline.sliding.total_steps
        if done.any():
            rows = np.nonzero(done)[0]
            images = self.pipeline.decode(latents[torch.from_numpy(rows).to(latents.device)])
            save_final_images(images, [sample.labels[i] for i in rows],
                              [sample.crops[i] for i in rows], self.output_dir)
        inp = np.nonzero(sample.cond_masks == 0.0)[0]
        if inp.size:
            save_final_images(sample.pixel_values[inp] * 0.5 + 0.5,
                              [sample.labels[i] for i in inp],
                              [sample.crops[i] for i in inp], self.output_dir)

    def validate_grid(self, after_rounds: int) -> None:
        """Every target cell sits at rounds * steps_per_alt, every input
        cell at 0, and every latent is finite."""
        expected = after_rounds * self.pipeline.sliding.steps_per_alt
        tgt = self.grid_t_idx[[self._spa_index[s] for s in self.target_spa_labels]]
        if (tgt != expected).any():
            raise ValueError(f"grid inconsistent after round {after_rounds}: target cells at "
                             f"{np.unique(tgt)}, expected {expected}")
        if (self.grid_t_idx[[self._spa_index[s] for s in self.input_spa_labels]] != 0).any():
            raise ValueError("grid inconsistent: input-camera cells advanced")
        if not bool(torch.isfinite(self.grid_latents.float()).all()):
            raise ValueError("grid contains non-finite latents")

    def execute_tasks(self) -> None:
        """All rounds, one task at a time."""
        for round_idx, tasks in enumerate(self.all_tasks):
            for task in tasks:
                self.execute_one_task(task)
            self._completed_rounds = round_idx + 1
            self.validate_grid(self._completed_rounds)
        if not check_sampling_results(self.spa_labels, self.tem_labels, self.output_dir):
            raise ValueError("Sampling failed: output grid incomplete.")
