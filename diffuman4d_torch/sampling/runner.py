"""SamplingRunner: the user-facing orchestration facade (counterpart of
``diffuman4d_tpu/sampling/runner.py``; reference:
src/samplers/sampling_runner.py:14-84).

The public surface is the JAX package's: ``inference()`` /
``evaluate()`` / ``to_nerfstudio()``. ``inference`` runs the sampler's
serial path, one task after another on the pipeline's device, resuming from
the output directory's grid state. The JAX runner's task waves over a device
mesh and its context-parallel window steps (its ``runner.py:37-63``) are not
ported yet (``ROADMAP.md`` A.7).
"""

from __future__ import annotations

import logging
import os.path as osp

from diffuman4d_torch.sampling.sampler import SlidingIterativeSampler

log = logging.getLogger(__name__)


class SamplingRunner:
    def __init__(self, sampler: SlidingIterativeSampler):
        self.sampler = sampler

    def inference(self) -> None:
        """All alternation rounds + completeness check
        (sampling_runner.py:45-62)."""
        self.sampler.execute_tasks()

    def _dump_phases(self) -> None:
        """Per-phase wall-clock table -> phases.json + job log. The CLI
        calls it once, after its last stage, so the table also holds the
        export and evaluation."""
        from diffuman4d_torch.utils.tracing import dump_report, report

        rep = report()
        if rep:
            dump_report(osp.join(self.sampler.output_dir, "phases.json"))
            log.info("phase report: %s", rep)

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
