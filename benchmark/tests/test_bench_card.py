"""On the card, at each cell's own size: the control (the reference in
TF32 in the program's place) fails the cell's limits on three seeds.

    python -m pytest -m gpu benchmark/tests/test_bench_card.py
"""

import pytest
import torch

from benchmark import calibrate, check, harness

CELLS = [w["name"] for w in
         harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cell_limits(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run with -m gpu on the card")
    cell = harness.Cell(name)
    for seed in (7001, 7002, 7003):
        numbers = calibrate.stand_in(cell, seed, "cuda", "tf32")
        ok, rows = check.verdict(numbers, cell.limits)
        assert not ok, rows
