"""Sliding-iterative sampler, serial path (counterpart of
``diffuman4d_tpu/sampling/sampler.py``).

Owns the camera x frame latent grid -- one device tensor (S, T, h, w, 4)
plus an int32 (S, T) timestep-index grid on the host, and for a multistep
scheduler (DPM++) its per-latent history ``grid_aux`` on the device: fp32
``prev_x0`` (S, T, h, w, 4) and bool ``has_prev`` (S, T) -- and runs the
alternation rounds' tasks one after another. Initial noise is seeded per
grid cell, so results do not depend on task order.

Grid state: after every round and every ``checkpoint_every_tasks`` tasks the
grid is written to ``state/grid_state.d4d`` (``io/gridstate.py``; a bf16
grid as its uint16 bits, the history as ``aux_prev_x0`` / ``aux_has_prev``),
and a new sampler on the same output directory
always resumes from it: rounds already done are skipped, and so are the first
``tasks_done_in_round`` tasks of the next (tasks of a round touch disjoint
cells, so a prefix count describes the state). A state of another seed or
grid shape is ignored, and so is a state whose history names differ from
the grid's (a DPM++ grid then starts afresh); a grid without history
ignores a state's. ``task_budget`` / ``time_budget_s`` stop a run
cleanly after that many tasks or past that many seconds, with the state
saved. The next task's sample loads on one IO thread while the current one
denoises, and finished rows are decoded and written on one saver thread;
every checkpoint and grid check first waits for the saver, so a state never
claims a task whose images are not on disk. The condition caches are
cleared at every domain switch. The JAX sampler's ``resume=False``,
``checkpoint_rounds=False`` and ``save_crop_params`` are not ported: no
entry point sets them.

Task waves (:meth:`execute_tasks_parallel`, the JAX sampler's
``execute_tasks_parallel`` / ``_execute_waves``): over a mesh of ranks
(``parallel/mesh.py``) each wave is ``mesh.shape["data"]`` tasks, data row
r taking task i + r, a short last wave padded with the round's last task.
Every rank of a model group loads, prepares and denoises the same task
(deterministic, so nothing is broadcast; a model axis above 1 splits each
window step, ``pipeline.enable_context_parallel``), and its model-rank 0
saves the task's images. Every rank holds a replica of the grid: after a
wave the wave's latents, timestep indices and multistep history are
all-gathered over the data axis into every replica. Rank 0 alone writes
the state, after every rank has flushed its saves; the end-of-run check
unions every rank's saved cells. The JAX sampler's per-task noise keys
(``_task_key``) have no counterpart: the port's noise is drawn per grid cell
and per frame label. The host mirror is not ported.

Each task's stages are timed as ``task/*`` phases (``utils/tracing.py``;
profiler ranges of the same names while a profiler records):
``load_sample`` and ``decode_save`` on their threads, overlapping the main
thread's ``prepare_conditions`` and ``sliding_denoise``, so the phases sum
to more than the wall time; the decode runs on the card's one stream, so
its device time also lands inside the main thread's next synchronised
phase. Inside ``decode_save``, ``save/decode`` is timed on the card (from
its first to its last operation on that stream, with whatever the main
thread queued between) and ``save/write_images`` (the JPEG writes) on the
host. The main thread's waits are ``task/prefetch_wait`` (for the IO
thread's next sample) and ``task/save_wait`` (in :meth:`_flush_saves`, for
the saver). A wave adds ``wave/gather``. The pipeline's spans (``cond/*``,
``denoise/window_step``) nest inside. Counters: ``sampler/tasks`` and
``sampler/latent_steps`` (the grid moves of the tasks run).
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from diffuman4d_torch.data import Sample, SpaTemDataset
from diffuman4d_torch.data.cameras import nearest_input_camera
from diffuman4d_torch.io.gridstate import read_state, write_state
from diffuman4d_torch.parallel import distributed as pdist
from diffuman4d_torch.sampling.outputs import (
    check_sampling_results,
    save_debug_grid,
    save_final_images,
)
from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline
from diffuman4d_torch.sampling.windows import build_windows
from diffuman4d_torch.utils.tracing import RankedLogger, count, phase

log = logging.getLogger(__name__)
rlog = RankedLogger(__name__)


@dataclass
class Task:
    alt: int  # 1-based alternation round
    domain: str  # "spatial" | "temporal"
    domain_label: str  # frame label (spatial) or target camera label (temporal)


def _to_host_bits(x: torch.Tensor) -> np.ndarray:
    """Device tensor -> host numpy, bf16 as its uint16 bit patterns."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).cpu().numpy().view(np.uint16)
    return x.cpu().numpy()


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
        save_debug_grids: bool = False,
        checkpoint_every_tasks: int = 24,
        task_budget: int | None = None,
        time_budget_s: float | None = None,
    ):
        # task_budget: stop cleanly after this many tasks of this call, with
        # an intra-round state saved; time_budget_s: stop after the first
        # task that ends past this many seconds from the start of
        # execute_tasks. checkpoint_every_tasks: intra-round state cadence
        # (0: round ends only).
        self.task_budget = task_budget
        self.time_budget_s = time_budget_s
        self._exec_t0: float | None = None
        self._tasks_run = 0
        self.checkpoint_every_tasks = checkpoint_every_tasks
        self.dataset = dataset
        self.pipeline = pipeline
        self.output_dir = output_dir
        self.seed = seed
        if save_debug_grids and not getattr(dataset, "target_pixels", True):
            raise ValueError("save_debug_grids needs GT target pixels; construct the dataset "
                             "with target_pixels=True")
        self.save_debug_grids = save_debug_grids
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
        # the frames are slid over only in a temporal round (round 2 on)
        if cfg.alternation_rounds > 1 and len(self.tem_labels) % cfg.sliding_stride != 0:
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
        self.grid_aux = None
        if pipeline.scheduler.has_aux:
            flat = pipeline.scheduler.init_aux((S * T,) + tuple(self.grid_latents.shape[2:]),
                                               self.grid_latents.device)
            self.grid_aux = {k: v.reshape((S, T) + v.shape[1:]) for k, v in flat.items()}
        self.all_tasks = self.prepare_tasks()
        self._completed_rounds = 0
        self._resume_tasks_done = 0
        self._saver: ThreadPoolExecutor | None = None
        self._save_futs: list = []
        self._saved_cells: set[tuple[str, str]] = set()  # (spa, tem) written by this process
        self._try_resume()

    # -- grid state --------------------------------------------------------
    @property
    def _state_path(self) -> str:
        return osp.join(self.output_dir, "state", "grid_state.d4d")

    @property
    def _legacy_state_path(self) -> str:
        return osp.join(self.output_dir, "state", "grid_state.npz")

    def _budget_out(self) -> bool:
        """True when this call should stop after the current task:
        ``task_budget`` tasks run, or the clock past ``time_budget_s``."""
        if self.task_budget is not None and self._tasks_run >= self.task_budget:
            return True
        return (self.time_budget_s is not None and self._exec_t0 is not None
                and time.perf_counter() - self._exec_t0 > self.time_budget_s)

    def save_state(self, tasks_done: int = 0) -> None:
        """Write the grid. ``tasks_done`` > 0 marks an intra-round state:
        that many tasks of round ``_completed_rounds`` (the 0-based next
        round) are already in the grid, and a resume skips them. Every rank
        holds the grid; rank 0 writes it."""
        if pdist.rank() != 0:
            return
        with phase("save_state/d2h", sync=False):
            arrays = {"latents": _to_host_bits(self.grid_latents)}
            # in name order, as the JAX sampler's (key-sorted) history
            for k, v in sorted((self.grid_aux or {}).items()):
                arrays[f"aux_{k}"] = _to_host_bits(v)
        arrays["t_idx"] = np.ascontiguousarray(self.grid_t_idx)
        meta = {
            "seed": self.seed,
            "completed_rounds": int(self._completed_rounds),
            "tasks_done_in_round": int(tasks_done),
            "bf16_bits": ["latents"] if self.grid_latents.dtype == torch.bfloat16 else [],
        }
        with phase("save_state/write", sync=False):
            write_state(self._state_path, meta, arrays)

    def _try_resume(self) -> bool:
        if osp.isfile(self._state_path):
            load = self._resume_from_d4d
        elif osp.isfile(self._legacy_state_path):
            load = self._resume_from_npz
        else:
            return False
        with phase("resume/load", sync=False):  # the upload is a blocking copy
            return load()

    def _resumed(self, completed_rounds: int, tasks_done: int) -> bool:
        self._completed_rounds = completed_rounds
        self._resume_tasks_done = tasks_done
        print(f"[sampler] resumed after round {completed_rounds}"
              + (f" + {tasks_done} tasks" if tasks_done else ""), flush=True)
        return True

    def _mismatched(self, seed: int, shape) -> bool:
        if seed != self.seed or tuple(shape) != tuple(self.grid_latents.shape):
            print("[sampler] found grid state with mismatched seed/shape -- ignoring", flush=True)
            return True
        return False

    def _restore_aux(self, data) -> bool:
        """The JAX sampler's rule for a state's ``aux_*`` arrays: a grid
        without history ignores them; a grid with history takes them when
        their names are its own, and otherwise ignores the whole state."""
        if self.grid_aux is None:
            return True
        if {k[4:] for k in data if k.startswith("aux_")} != set(self.grid_aux):
            print("[sampler] state lacks multistep history -- ignoring state", flush=True)
            return False
        self.grid_aux = {
            k: torch.from_numpy(np.array(data[f"aux_{k}"])).to(v.device, v.dtype)
            for k, v in self.grid_aux.items()}
        return True

    def _resume_from_d4d(self) -> bool:
        meta, data = read_state(self._state_path)
        if self._mismatched(int(meta["seed"]), data["latents"].shape) or \
                not self._restore_aux(data):
            return False
        lat = np.array(data["latents"])  # a writable host copy of the memmap
        dev, dtype = self.grid_latents.device, self.grid_latents.dtype
        if "latents" in meta.get("bf16_bits", []):
            grid = torch.from_numpy(lat.view(np.int16)).to(dev).view(torch.bfloat16)
        else:
            grid = torch.from_numpy(lat).to(dev)
        self.grid_latents = grid.to(dtype)
        self.grid_t_idx = np.array(data["t_idx"], np.int32)
        return self._resumed(int(meta["completed_rounds"]),
                             int(meta.get("tasks_done_in_round", 0)))

    def _resume_from_npz(self) -> bool:
        """Legacy ``np.savez`` states (the JAX package's older runs)."""
        data = np.load(self._legacy_state_path)
        if self._mismatched(int(data["seed"]), data["latents"].shape) or \
                not self._restore_aux({k: data[k] for k in data.files}):
            return False
        self.grid_latents = torch.from_numpy(np.array(data["latents"])).to(
            self.grid_latents.device, self.grid_latents.dtype)
        self.grid_t_idx = data["t_idx"].astype(np.int32)
        tasks_done = int(data["tasks_done_in_round"]) if "tasks_done_in_round" in data.files else 0
        return self._resumed(int(data["completed_rounds"]), tasks_done)

    # ----------------------------------------------------------------------
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

    def _load_timed(self, task: Task) -> Sample:
        with phase("task/load_sample", sync=False):  # host only: no device sync
            return self.load_sample(task)

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

    def task_labels(self, task: Task) -> list[tuple[str, str, str]]:
        """The (scene, spa, tem) row labels ``load_sample`` gives ``task``,
        without reading a file: every rank scatters every task of a wave."""
        scene = self.dataset.scene_label
        if task.domain == "spatial":
            return [(scene, spa, task.domain_label) for spa in self.spa_labels]
        cameras = self.dataset.cameras[scene]
        cond_spa = self.input_spa_labels[nearest_input_camera(
            cameras[task.domain_label].pose, [cameras[s].pose for s in self.input_spa_labels])]
        return [(scene, spa, tem) for spa in (cond_spa, task.domain_label)
                for tem in self.tem_labels]

    def _denoise_task(self, task: Task, sample: Sample):
        """One task's conditions and sliding denoise from the grid's rows.
        Returns (latents, t_idx, aux) of the task's rows, not yet scattered."""
        spa, tem = self._grid_cells(sample.labels)
        with phase("task/prepare_conditions"):
            cond = self.pipeline.prepare_conditions(sample)
        dev = self.grid_latents.device
        spa_t = torch.from_numpy(spa).to(dev)
        tem_t = torch.from_numpy(tem).to(dev)
        latents = self.grid_latents[spa_t, tem_t]
        t_idx = self.grid_t_idx[spa, tem]
        aux = None if self.grid_aux is None else {
            k: v[spa_t, tem_t] for k, v in self.grid_aux.items()}
        windows = self._windows_for(task, len(sample.labels))
        with phase("task/sliding_denoise"):
            out = self.pipeline.sliding_denoise(cond, latents, t_idx, windows, task.domain,
                                                aux=aux)
        count("sampler/tasks")
        count("sampler/latent_steps", int((out[1].astype(np.int64) - t_idx).sum()))
        return out

    def _scatter(self, labels, latents: torch.Tensor, t_idx: np.ndarray,
                 aux: dict | None) -> None:
        """Write a task's rows (``labels``' cells) into the grid."""
        spa, tem = self._grid_cells(labels)
        dev = self.grid_latents.device
        spa_t = torch.from_numpy(spa).to(dev)
        tem_t = torch.from_numpy(tem).to(dev)
        self.grid_latents[spa_t, tem_t] = latents
        self.grid_t_idx[spa, tem] = t_idx
        for k, v in (aux or {}).items():
            self.grid_aux[k][spa_t, tem_t] = v

    def execute_one_task(self, task: Task, sample: Sample | None = None,
                         save_async: bool = False) -> None:
        if sample is None:
            sample = self._load_timed(task)
        latents, t_idx, aux = self._denoise_task(task, sample)
        self._scatter(sample.labels, latents, t_idx, aux)
        if save_async and self._saver is not None:
            # decode + JPEG writes overlap the next task's denoise; joined by
            # _flush_saves before any checkpoint or grid check
            self._save_futs.append(
                self._saver.submit(self._save_task_outputs, task, sample, latents, t_idx))
        else:
            self._save_task_outputs(task, sample, latents, t_idx)

    def _flush_saves(self) -> None:
        """Join pending saves, re-raising the first failure."""
        futs, self._save_futs = self._save_futs, []
        if not futs:
            return
        with phase("task/save_wait", sync=False):
            for f in futs:
                f.result()

    @staticmethod
    def _next_sample(fut) -> Sample | None:
        """The IO thread's prefetched sample (``None`` without one)."""
        if fut is None:
            return None
        with phase("task/prefetch_wait", sync=False):
            return fut.result()

    @torch.no_grad()  # no_grad is thread-local: the saver thread needs its own
    def _save_task_outputs(self, task: Task, sample: Sample, latents: torch.Tensor,
                           t_idx: np.ndarray) -> None:
        """Decode and write the fully denoised rows; input rows are written
        as their ground-truth pixels; optionally the task's debug grid."""
        # no device synchronise: the decode's copy to the host waits for its
        # own work, a synchronise would wait for the main thread's as well
        with phase("task/decode_save", sync=False):
            done = t_idx == self.pipeline.sliding.total_steps
            if done.any():
                rows = np.nonzero(done)[0]
                with phase("save/decode", device=self.pipeline.device.type == "cuda"):
                    images = self.pipeline.decode(
                        latents[torch.from_numpy(rows).to(latents.device)])
                with phase("save/write_images", sync=False):
                    save_final_images(images, [sample.labels[i] for i in rows],
                                      [sample.crops[i] for i in rows], self.output_dir)
                self._saved_cells.update(sample.labels[i][1:3] for i in rows)
            inp = np.nonzero(sample.cond_masks == 0.0)[0]
            if inp.size:
                with phase("save/write_images", sync=False):
                    save_final_images(sample.pixel_values[inp] * 0.5 + 0.5,
                                      [sample.labels[i] for i in inp],
                                      [sample.crops[i] for i in inp], self.output_dir)
                self._saved_cells.update(sample.labels[i][1:3] for i in inp)
            if self.save_debug_grids:
                self._save_debug_grid(task, sample, latents)

    def _save_debug_grid(self, task: Task, sample: Sample, latents: torch.Tensor) -> None:
        """Rows: blended skeletons, inputs, outputs (input rows dimmed) and
        the L1 error, as the JAX package writes them."""
        images = self.pipeline.decode(latents).astype(np.float32) / 255.0
        inputs01 = sample.pixel_values * 0.5 + 0.5
        sk01 = (sample.skeletons.astype(np.float32) / 255.0
                if sample.skeletons.dtype == np.uint8 else sample.skeletons * 0.5 + 0.5)
        outputs = images.copy()
        outputs[sample.cond_masks == 0.0] *= 0.2
        rows = {
            "skeleton": sk01 * 0.8 + inputs01 * 0.2,
            "input": inputs01,
            "output": outputs,
            "error": np.clip(np.abs(images - inputs01), 0.0, 1.0),
        }
        tag = "spa" if task.domain == "temporal" else "tem"
        save_debug_grid(rows, self.output_dir, f"alt{task.alt}_{tag}{task.domain_label}")

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
        if not bool(torch.isfinite(self.grid_latents).all()):
            raise ValueError("grid contains non-finite latents")

    def execute_tasks(self) -> None:
        """Every task not yet in the grid, one at a time, with the round-end
        checks, the checkpoints, the budgets and the completeness check.

        The next task's sample loads on an IO thread (samples do not depend
        on the grid, so prefetching across a round boundary is exact) and a
        task's outputs are decoded and written on a saver thread."""
        self._exec_t0 = time.perf_counter()
        todo: list[tuple[int, int, Task]] = []
        for round_idx, tasks in enumerate(self.all_tasks):
            if round_idx < self._completed_rounds:
                continue
            start, self._resume_tasks_done = self._resume_tasks_done, 0
            todo.extend((round_idx, task_idx, task) for task_idx, task in enumerate(tasks)
                        if task_idx >= start)

        prefetch = ThreadPoolExecutor(max_workers=1)
        self._saver = ThreadPoolExecutor(max_workers=1)
        fut = None
        try:
            for j, (round_idx, task_idx, task) in enumerate(todo):
                sample = self._next_sample(fut)
                fut = prefetch.submit(self._load_timed, todo[j + 1][2]) if j + 1 < len(todo) \
                    else None
                self.execute_one_task(task, sample=sample, save_async=True)
                done = task_idx + 1
                self._tasks_run += 1
                budget_out = self._budget_out()
                n_round = len(self.all_tasks[round_idx])
                if done == n_round:
                    self._round_end(round_idx)
                elif self.checkpoint_every_tasks > 0 and (
                        budget_out or done % self.checkpoint_every_tasks == 0):
                    self._checkpoint(tasks_done=done)
                log.info("round %d/%d (%s): task %d/%d done", round_idx + 1,
                         len(self.all_tasks), task.domain, done, n_round)
                if budget_out and (round_idx, done) != (len(self.all_tasks) - 1,
                                                        len(self.all_tasks[-1])):
                    log.info("budget (tasks=%s, time=%s s) reached at round %d task %d/%d -- "
                             "state saved, stopping for resume", self.task_budget,
                             self.time_budget_s, round_idx + 1, done, n_round)
                    self._flush_saves()
                    return
            self._flush_saves()
        finally:
            prefetch.shutdown(wait=True, cancel_futures=True)
            self._saver.shutdown(wait=True)
            self._saver = None
        if not check_sampling_results(self.spa_labels, self.tem_labels, self.output_dir):
            raise ValueError("Sampling failed: output grid incomplete.")

    def execute_tasks_parallel(self, mesh) -> None:
        """Every task not yet in the grid, in waves of ``mesh.shape["data"]``
        tasks over a mesh of ranks (every rank calls it, with its own
        sampler on the same output directory): round-end checks,
        checkpoints on the wave cadence, budgets and the completeness check
        as in :meth:`execute_tasks`. This rank's next task loads on an IO
        thread and its outputs are written on a saver thread.
        ``time_budget_s`` is refused above one rank: a clock could stop the
        ranks at different waves."""
        n_wave, (row,) = mesh.shape["data"], pdist.local_data_rows(mesh)
        saves = mesh.index("model") == 0
        multi = pdist.is_multi()
        if multi and self.time_budget_s is not None:
            raise ValueError(
                "time_budget_s is single-process only (a clock-based stop "
                "branch is not deterministic across hosts); size multi-host "
                "sessions with task_budget instead"
            )
        self._exec_t0 = time.perf_counter()
        waves: list[tuple[int, int, int]] = []  # (round, first task, wave number in the round)
        for round_idx, tasks in enumerate(self.all_tasks):
            if round_idx < self._completed_rounds:
                continue
            start, self._resume_tasks_done = self._resume_tasks_done, 0
            waves.extend((round_idx, i, w) for w, i in enumerate(range(start, len(tasks), n_wave)))

        def mine(w: int) -> Task:
            """This rank's task of wave ``w``: a short last wave repeats the
            round's last task."""
            round_idx, i, _ = waves[w]
            tasks = self.all_tasks[round_idx]
            return tasks[min(i + row, len(tasks) - 1)]

        dev = self.grid_latents.device
        prefetch = ThreadPoolExecutor(max_workers=1)
        self._saver = ThreadPoolExecutor(max_workers=1)
        fut = None
        try:
            for w, (round_idx, i, w_num) in enumerate(waves):
                tasks = self.all_tasks[round_idx]
                n_real = min(n_wave, len(tasks) - i)
                task = mine(w)
                sample = self._next_sample(fut) if fut is not None else self._load_timed(task)
                fut = prefetch.submit(self._load_timed, mine(w + 1)) if w + 1 < len(waves) \
                    else None
                latents, t_idx, aux = self._denoise_task(task, sample)
                with phase("wave/gather"):
                    lat_b = pdist.gather_wave_rows(mesh, latents)
                    ti_b = pdist.gather_wave_rows(mesh, torch.from_numpy(t_idx).to(dev))
                    ti_b = ti_b.cpu().numpy()
                    aux_b = {k: pdist.gather_wave_rows(mesh, v) for k, v in (aux or {}).items()}
                for k in range(n_real):  # padded duplicates are not scattered twice
                    self._scatter(self.task_labels(tasks[i + k]), lat_b[k], ti_b[k],
                                  {n: v[k] for n, v in aux_b.items()})
                if saves and row < n_real:
                    self._save_futs.append(self._saver.submit(
                        self._save_task_outputs, task, sample, latents, t_idx))
                done = i + n_real
                self._tasks_run += n_real
                budget_out = self._budget_out()
                last = (round_idx, done) == (len(self.all_tasks) - 1, len(tasks))
                if done == len(tasks):
                    self._round_end(round_idx)
                elif self.checkpoint_every_tasks > 0 and (
                        budget_out
                        or (w_num + 1) % max(1, -(-self.checkpoint_every_tasks // n_wave)) == 0):
                    self._checkpoint(tasks_done=done)
                rlog.info("round %d/%d (%s): tasks %d-%d/%d done", round_idx + 1,
                          len(self.all_tasks), task.domain, i + 1, done, len(tasks))
                if budget_out and not last:
                    rlog.info("budget (tasks=%s) reached at round %d task %d/%d -- state "
                              "saved, stopping for resume", self.task_budget, round_idx + 1,
                              done, len(tasks))
                    self._flush_saves()
                    return
            self._flush_saves()
        finally:
            prefetch.shutdown(wait=True, cancel_futures=True)
            self._saver.shutdown(wait=True)
            self._saver = None
        self._check_coverage()

    def _checkpoint(self, tasks_done: int = 0) -> None:
        """The state, once every rank's outputs are on disk: a state never
        claims a task whose images are missing."""
        self._flush_saves()
        pdist.barrier()
        self.save_state(tasks_done=tasks_done)

    def _round_end(self, round_idx: int) -> None:
        """After a round's last wave: the grid check, the state and, at a
        domain switch, the condition caches cleared."""
        self._flush_saves()
        self._completed_rounds = round_idx + 1
        self.validate_grid(self._completed_rounds)
        self._checkpoint()
        nxt = round_idx + 1
        if (nxt < len(self.all_tasks) and self.all_tasks[nxt]
                and self.all_tasks[nxt][0].domain != self.all_tasks[round_idx][0].domain):
            # the finished domain's rows are not revisited soon
            self.pipeline.clear_condition_caches()

    def _check_coverage(self) -> None:
        """Every grid cell saved by some rank (in this run or, for a resumed
        one, on disk already); then rank 0 counts the files."""
        cov = np.zeros((len(self.spa_labels), len(self.tem_labels)), bool)
        for s, t in self._saved_cells:
            cov[self._spa_index[s], self._tem_index[t]] = True
        for s, si in self._spa_index.items():
            d = osp.join(self.output_dir, "images", s)
            if osp.isdir(d):
                for f in os.listdir(d):
                    ti = self._tem_index.get(f[:-4])
                    if f.endswith(".jpg") and ti is not None:
                        cov[si, ti] = True
        cov_all = np.stack(pdist.all_gather_object(cov)).any(axis=0)
        if not cov_all.all():
            raise ValueError(
                f"Sampling failed: {int((~cov_all).sum())} grid cells saved by no process.")
        if pdist.rank() == 0 and not check_sampling_results(
                self.spa_labels, self.tem_labels, self.output_dir):
            raise ValueError("Sampling failed: output grid incomplete.")
