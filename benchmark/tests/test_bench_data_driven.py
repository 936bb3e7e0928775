"""The harness finds a configuration, a traffic mix, a cell and a
per-layer metric by name, from files it has not seen, with no edit to any
file that is there: a new cell is data and one small reader."""

import json
import shutil
from pathlib import Path

import pytest

from benchmark import run as RUN

BENCH = Path(__file__).resolve().parents[1]


@pytest.fixture
def new_bench(tmp_path):
    """A checkout holding the benchmark as it is plus one new
    configuration, traffic mix, cell and per-layer metric."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "urban_mix.json").read_text())
    cfg.update(name="tiny_street", nlay=2,
               tiles={"Urban": 6, "SimpleUrban": 3, "InfiniteStreet": 3, "Flat": 2})
    (root / "benchmark" / "configs" / "tiny_street.json").write_text(json.dumps(cfg))
    (root / "benchmark" / "traffic" / "f64_two.json").write_text(json.dumps(
        {"dtype": "float64", "input_sets": 2}))
    (root / "benchmark" / "workloads" / "tiny_street.f64_two.json").write_text(json.dumps(
        {"check": {"columns_per_call": 8, "block_columns": 4,
                   "limits": {"max_err": 1e-9, "rms_err": 1e-10}}}))
    (root / "benchmark" / "metrics" / "dispatch.traced_calls.py").write_text(
        '"""dispatch.traced_calls: the calls traced."""\n\n\ndef read(t):\n    return t.n\n')
    spec["configs"].append({"name": "tiny_street", "source": "https://example.org/tiny",
                            "file": "benchmark/configs/tiny_street.json", "reduced": []})
    spec["workloads"].append({"name": "tiny_street.f64_two", "config": "tiny_street",
                              "traffic": "f64_two", "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "dispatch.traced_calls", "unit": "calls",
                              "better": "lower", "source": "program_counter",
                              "layer": "dispatch and compiled programs",
                              "moves": "columns_per_s", "workloads": ["tiny_street.f64_two"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, before


@pytest.mark.parametrize("trace", [False, True], ids=["end_to_end", "traced"])
def test_new_cell_from_files_alone(new_bench, trace):
    root, before = new_bench
    cell = RUN.load_cell("tiny_street.f64_two", bench=root / "benchmark")
    assert cell.config["name"] == "tiny_street" and cell.traffic["input_sets"] == 2
    res = RUN.run(cell, 2**31 + 5, 0.2, trace, device="cpu")
    assert res["correct"] is True and res["attempted"] >= 1
    if trace:
        assert res["metrics"]["dispatch.traced_calls"]["value"] == 2
    else:
        assert set(res["metrics"]) == {"columns_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    after = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p in before}
    assert after == before
