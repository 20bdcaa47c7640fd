"""SamplingRunner: the user-facing orchestration facade (counterpart of
``diffuman4d_tpu/sampling/runner.py``; reference:
src/samplers/sampling_runner.py:14-84).

The public surface is the JAX package's: ``inference()`` /
``evaluate()`` / ``to_nerfstudio()``. ``inference`` runs over a mesh of
ranks (``parallel/mesh.py``; by default every rank of the process group on
the ``data`` axis): a mesh of more than one rank runs task waves, and a
``model`` axis above 1 also splits each window step's frames over its ranks
(context parallelism). A 1 x 1 mesh, a one-card run, keeps the sampler's
serial path with its IO-thread prefetch, where the JAX runner runs waves of
one (``ROADMAP.md`` C); the two give the same bytes.
"""

from __future__ import annotations

import logging
import os.path as osp

from diffuman4d_torch.sampling.sampler import SlidingIterativeSampler

log = logging.getLogger(__name__)


class SamplingRunner:
    def __init__(self, sampler: SlidingIterativeSampler, mesh=None):
        # mesh: a parallel.mesh.Mesh; None = every rank on the data axis
        self.sampler = sampler
        self.mesh = mesh

    def _resolve_mesh(self):
        if self.mesh is not None:
            return self.mesh
        from diffuman4d_torch.parallel.distributed import global_mesh

        return global_mesh()

    def inference(self) -> None:
        """All alternation rounds + completeness check
        (sampling_runner.py:45-62). The mesh decides the parallelism: the
        ``data`` axis runs task waves, a ``model`` axis above 1 puts all its
        ranks on one task's window steps, so a (1, N) mesh spends N cards on
        one task's latency."""
        mesh = self._resolve_mesh()
        if mesh.size == 1:
            self.sampler.execute_tasks()
            return
        if mesh.shape["model"] > 1:
            log.info("context-parallel window steps over %d ranks ('model' axis)%s",
                     mesh.shape["model"], f" x {mesh.shape['data']} task waves ('data' axis)"
                     if mesh.shape["data"] > 1 else "")
            self.sampler.pipeline.enable_context_parallel(mesh)
        else:
            log.info("task waves over %d ranks", mesh.shape["data"])
        self.sampler.execute_tasks_parallel(mesh)

    def _dump_phases(self) -> None:
        """Per-phase time table -> phases.json + job log, and the counters
        (tasks, latent steps, cache hits and misses, kernel builds) ->
        counters.json. The CLI calls it once, after its last stage, so the
        table also holds the export and evaluation."""
        from diffuman4d_torch.utils.tracing import counters, dump_counters, dump_report, report

        rep = report()
        if rep:
            dump_report(osp.join(self.sampler.output_dir, "phases.json"))
            log.info("phase report: %s", rep)
        if counters():
            dump_counters(osp.join(self.sampler.output_dir, "counters.json"))

    def evaluate(self, data_dir: str, scene_label: str, **kwargs) -> dict:
        """Masked PSNR/SSIM/LPIPS vs GT (sampling_runner.py:64-77), on the
        pipeline's device."""
        from diffuman4d_torch.data.metrics import evaluate_results

        kwargs.setdefault("device", self.sampler.pipeline.device)
        return evaluate_results(
            data_dir=data_dir,
            scene_label=scene_label,
            output_dir=self.sampler.output_dir,
            input_spa_labels=self.sampler.input_spa_labels,
            **kwargs,
        )

    def to_nerfstudio(self, scene_dir: str) -> str:
        """Export generated images for 3DGS/4DGS (sampling_runner.py:79-84)."""
        from diffuman4d_torch.io.nerfstudio import export_to_nerfstudio

        return export_to_nerfstudio(
            scene_dir=scene_dir,
            output_dir=self.sampler.output_dir,
            input_spa_labels=self.sampler.input_spa_labels,
        )
