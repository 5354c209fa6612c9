"""Each cell's control, the reference put in the program's place in the
precision below the configuration's, comes out not correct: at a CPU
test's size for the sweep (float8 rounding needs no card), and at the
cell's own size on the card for both (TF32 exists only there)."""

import time

import pytest
import torch
from bench_small import small
from conftest import ROOT

import controls
import harness

SWEEP, TRAIN = "resnet_base_bf16.sweep_6ch_600s", "resnet_base_f32.train_b32"


def _job(cell, seed, device):
    return harness.Job(cell=cell, seed=seed, seconds=1.0, trace=False, device=device,
                       started=time.perf_counter())


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > limit for k, limit in limits.items() if k in readings)


@pytest.mark.parametrize("seed", [2147483811, 2147483812])
def test_the_sweep_control_fails_at_a_small_size(seed):
    cell = harness.find_cell(ROOT, SWEEP, small)
    out = controls.sweep_control(_job(cell, seed, torch.device("cpu")))
    assert _fails(out["control_fp8"], cell.check["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("name,control", [(SWEEP, "control_fp8"), (TRAIN, "control_tf32")])
def test_each_control_fails_at_the_cells_size(card, name, control):
    cell = harness.find_cell(ROOT, name)
    run = controls.sweep_control if cell.driver == "sweep" else controls.train_control
    for seed in (2147483821, 2147483822, 2147483823):
        assert _fails(run(_job(cell, seed, card))[control], cell.check["limits"])
