"""The benchmark's frozen state writer against the port's sampler: the seeded
round-1 state is resumed into round 2, DPM++ history and all."""

import numpy as np
import torch

from benchmark.harness import spec as sp
from benchmark.harness.program import Program

from conftest import TINY


def test_seeded_state_resumes_into_round_two(tmp_path):
    cell = sp.load_cell("skel-temporal")
    prog = Program(cell, 5, torch.device("cpu"), str(tmp_path), 64, TINY)
    seeded = prog.seed_state()
    s = prog.build_sampler(0)
    assert s._completed_rounds == 1 and s.all_tasks[1][0].domain == "temporal"
    lat = s.grid_latents.view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(lat, seeded["latents"])
    assert np.array_equal(s.grid_t_idx, seeded["t_idx"])
    assert set(s.grid_aux) == {"prev_x0", "has_prev"}
    assert np.array_equal(s.grid_aux["prev_x0"].numpy(), seeded["aux_prev_x0"])
    assert np.array_equal(s.grid_aux["has_prev"].numpy(), seeded["aux_has_prev"])
    targets = [i for i, c in enumerate(s.spa_labels) if c not in s.input_spa_labels]
    assert (s.grid_t_idx[targets] == prog.shape.steps_per_alt).all()
    s.task_budget = 1
    before = s.grid_t_idx.copy()
    s.execute_tasks()
    moved = s.grid_t_idx - before
    assert moved.sum() == len(s.tem_labels) * prog.shape.steps_per_alt
    assert (moved[s.spa_labels.index(s.all_tasks[1][0].domain_label)]
            == prog.shape.steps_per_alt).all()
