"""The control (the reference in the precision below the configuration's,
in the program's place) reads far above the program: at a tiny size on
the CPU here, and on the card at the cell's own size against the cell's
limits (``-m gpu``)."""

import os

import pytest
import torch

from perfbench import readings, run
from perfbench.tests.tiny import TINY

SEED = 2 ** 33 + 31
CELLS = ["fusion_serve_b4", "fusion_train_b4", "lidar_sensor_10hz",
         "fusion_train_dp4"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(cell):
    program = run.run_once(cell, SEED, 1.0, False, device="cpu",
                           overrides=TINY)[1]
    control = readings.control_numbers(cell, SEED, "cpu", TINY)
    held = run.load_cell(cell).limits
    assert max(control[k] / max(program[k], 1e-12) for k in held) >= 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's size")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_on_the_card(card, cell):
    os.chdir(run.ROOT)
    limits = run.load_cell(cell).limits
    numbers = readings.control_numbers(cell, SEED, "cuda")
    assert any(numbers[k] > limits[k] for k in limits)
