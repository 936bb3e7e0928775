"""A run with the timed path broken underneath comes out not correct: the
harness past its look for a card (run() on the CPU, with the program's
plain versions), each cell at a tiny size, once per fault this system can
have (an answer altered where it is produced; half of the batch left
out).  The same run unbroken, in float64, comes out correct."""

import copy
import json
import sys
import types
from pathlib import Path

import pytest
import torch

from benchmark import check as CK
from benchmark import run as RUN

from spartacus_surface_tpu_torch.models.dispatch import run_radsurf

BENCH = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


def tiny(name):
    cell = RUN.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["tiles"] = {k: max(3, v // 16384) for k, v in cfg["tiles"].items()}
    cfg["nlay"] = min(cfg["nlay"], 4)
    cfg["radsurf"].update(nsw=min(cfg["radsurf"]["nsw"], 2), nlw=min(cfg["radsurf"]["nlw"], 2))
    cell.config = cfg
    cell.check = dict(cell.check, columns_per_call=64, block_columns=16)
    return cell


def altered(config, arrays, device):
    """One answer altered where it is produced: a field 1 % off."""
    out = run_radsurf(config, arrays, device)
    out["sw_norm_diff"]["ground_dn"] *= 1.01
    return out


def half_left_out(config, arrays, device):
    """Half of the batch left out: the second half's outputs never written."""
    out = run_radsurf(config, arrays, device)
    C = arrays["dz"].shape[0]
    for group in out.values():
        for v in group.values():
            v[C // 2:] = 0.0
    return out


@pytest.mark.parametrize("fault", [altered, half_left_out], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    res = RUN.run(tiny(name), 2**31 + 17, 0.1, False, device="cpu", solve=fault)
    assert res["correct"] is False
    assert res["failed"] == res["calls_checked"] > 0
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_unbroken_is_correct():
    res = RUN.run(tiny("rami5.f64"), 2**31 + 17, 0.1, False, device="cpu")
    assert res["correct"] is True and res["failed"] == 0
    assert all(c["value"] < 1e-12 for c in res["checks"].values())


def test_nonfinite_is_not_correct():
    def nan(config, arrays, device):
        out = run_radsurf(config, arrays, device)
        out["lw_norm"]["veg_abs"][0, 0, 0] = torch.nan
        return out

    cell = tiny("rami5.f64")
    cell.check = dict(cell.check, columns_per_call=10**6)  # every column
    res = RUN.run(cell, 3, 0.1, False, device="cpu", solve=nan)
    assert res["correct"] is False
    assert res["checks"]["max_err"]["value"] == float("inf")


def test_jax_loaded_after_the_window_prints_no_result(monkeypatch, capsys):
    """JAX loaded in the check, after the window and the traced run: the
    run prints no result and exits with code 3; without it, the result."""
    reference = CK.reference_outputs

    def loads_jax(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return reference(*a, **kw)

    monkeypatch.setattr(CK, "reference_outputs", loads_jax)
    res = RUN.run(tiny("rami5.f64"), 5, 0.1, False, device="cpu")
    assert RUN.emit(res) == 3
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err
    monkeypatch.delitem(sys.modules, "jax")
    assert RUN.emit(res) == 0
    out, _ = capsys.readouterr()
    assert json.loads(out.splitlines()[-1])["correct"] is True
