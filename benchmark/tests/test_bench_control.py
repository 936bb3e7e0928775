"""The control on the card: the reference at the precision below the
cell's (TF32 products for float32, float32 for float64), put in the
program's place, fails the cell's limits, while the program's own runs
pass them; each cell at a size a test run holds, on three seeds.  The
readings at the cells' own sizes come from ``python3 -m
benchmark.readings`` (PERF.md)."""

import copy
import json
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's runs are the card's kernels")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(card, name):
    from benchmark import readings, run as RUN

    cell = RUN.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["tiles"] = {k: max(64, min(v // 8, 2048))
                          for k, v in cell.config["tiles"].items()}
    cell.check = dict(cell.check, columns_per_call=128, block_columns=128)
    limits = cell.check["limits"]
    for seed in (11, 2**31 + 3, 977):
        res = RUN.run(cell, seed, 0.5, False, card)
        assert res["correct"], res["checks"]
        ctl = readings.control_numbers(cell, seed, card)
        assert any(ctl[k][0] > limits[k] for k in limits), ctl
