"""The port's one-shot checks (spartacus_surface_tpu_torch.checks) on the
CPU, at small sizes.

* every checks.SHAPES entry once, in its order, at a small shape on the
  plain versions: its gate passed, its findings; off the card AUTO
  resolves to one shot;
* chip_smoke.py's shapes phase names a check that raises, fails, and runs
  the rest;
* the energy-budget gate: its bars, and a column with a sub-threshold roof
  held to the scan route's residual;
* the result helpers fields_of and max_rel_err;
* checks and entry import with JAX and the JAX package blocked.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spartacus_surface_tpu_torch import checks as C
from spartacus_surface_tpu_torch import entry as E
from spartacus_surface_tpu_torch.models.solver import SolverOptions
from spartacus_surface_tpu_torch.ops.launches import COUNTERS, PATH_4
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# each check's small shape, in SHAPES' order
SMALL = {
    "build": dict(C=16, L=2),
    "parity": dict(C=8, L=3),
    "mesh": dict(C=12, L=3),
    "nreg3": dict(C=8, L=3),
    "rami5": dict(C=4, L=5, S=3),
    "rami5_f64": dict(C=4, L=5, S=3),
    "cli": dict(ncol=1012, L=3, S=2),
    "grad": dict(C=8, L=3),
    "capacity": dict(C=64, L=3),
    "headline_f64": dict(C=16, L=3),
    "headline": dict(C=16, L=3),
}
SOLVES = ("nreg3", "rami5", "rami5_f64", "capacity", "headline_f64", "headline")


@pytest.mark.parametrize("name", list(SMALL))
def test_shape_check_on_cpu(name):
    """Each check at its small shape passes its gate; its findings."""
    assert list(C.SHAPES) == list(SMALL)
    found = C.SHAPES[name](CPU, 0, **SMALL[name])
    if name in SOLVES:
        assert found["finite"] is True
        assert set(found["budget_max_residual"]) >= set(C.GROUPS)
        # off the card the budget is unbounded: AUTO takes one shot
        assert found["auto_column_chunk"] == {"sw": 0, "lw": 0}
    elif name == "build":
        assert list(found["launches"]) == [f"nreg{r}_ns{s}" for r, s in E.ENTRY_CONFIGS]
    elif name == "parity":
        assert list(found["per_config"]) == [f"nreg{r}_ns{s}" for r, s in E.ENTRY_CONFIGS]
        assert found["max_rel_err"]["float64"] <= C.PARITY_BARS["float64"]["sw"]
    elif name == "mesh":
        assert found["max_rel_err"] < C.MESH_BAR and found["mesh"] == ["cpu", "cpu"]
    elif name == "cli":  # the CLI's own count: none on the CPU
        assert set(found["launches"]) >= set(PATH_4) and not any(found["launches"].values())
        assert list(found["residuals_in_process"]) == ["kernel float32", "scan float32",
                                                      "scan float64"]
        assert all(r < bar for r, bar in zip(found["residuals"], found["residual_bars"]))
    else:
        assert found["finite"] is True and np.isfinite(found["grad_abs_max"])


def test_a_failing_shape_check_names_itself(monkeypatch, capsys):
    """chip_smoke.py's shapes phase prints the error of a check that
    raises under its name, adds one failure naming it, and runs the next."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for w, attr in COUNTERS.values():  # restored after the test
        monkeypatch.setattr(w, attr, getattr(w, attr))

    def boom(device):
        raise RuntimeError("injected failure")

    def launched(device):
        for w, attr in COUNTERS.values():
            setattr(w, attr, 1)
        return {"done": True}

    monkeypatch.setattr(C, "SHAPES", {"boom": boom, "launched": launched})
    smoke.shapes_phase(CPU)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln.get("check") for ln in lines] == ["boom", "launched", None]
    assert "injected failure" in lines[0]["error"]
    assert lines[1]["findings"] == {"done": True}
    assert lines[2]["checks"] == ["boom", "launched"]
    assert len(smoke.FAILURES) == 1
    assert smoke.FAILURES[0].startswith("shapes boom:") and "injected failure" in smoke.FAILURES[0]


@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_budget_bars(dname):
    """lw_scale is max(1, the largest emission); float32's LW bars scale
    with it, float64's and the SW bars are fixed."""
    _, lw = E.canopy_inputs(4, 3, 2, C.DTYPES[dname], CPU, 0)
    lw.veg_planck[1, 2, 0] = 512.0
    assert C.lw_scale(lw) == 512.0
    lw.veg_planck[1, 2, 0] = 0.0
    assert C.lw_scale(lw) >= 1.0
    one, big = C.budget_bars(dname, 1.0), C.budget_bars(dname, 512.0)
    assert list(one) == list(C.GROUPS)
    for g in C.GROUPS:
        scaled = dname == "float32" and g.startswith("lw")
        assert big[g] == (512.0 * one[g] if scaled else one[g]), g


@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_sub_threshold_roofs_are_held_to_the_scan_route(dname):
    """A column whose building fraction steps by less than
    min_building_fraction is found, its residual witnessed by the scan
    route within the bar; a residual moved past the bar on it, or on
    another column, fails the gate."""
    opt, lg = SolverOptions(nreg=2, nstream=4, do_urban=True), LegendreGauss(4)
    sw, lw = E.canopy_inputs(6, 4, 2, C.DTYPES[dname], CPU, 0)
    for inp in (sw, lw):
        inp.building_fraction[2, 1] = inp.building_fraction[2, 0] + 0.5 * opt.min_building_fraction
    out = C.sw_lw(sw, lw, opt, lg)
    found = C.budget_worst(out, sw, lw, opt, lg, dname)["budget_max_residual"]
    assert found["sub_threshold_roof_columns"] == 1
    assert "lw_internal sub-threshold roof, scan route" in found
    leaky = C.sub_threshold_roofs(sw.building_fraction, opt.min_building_fraction)
    assert leaky.tolist() == [False, False, True, False, False, False]
    bars = C.budget_bars(dname, C.lw_scale(lw))
    resid = C.budget_residuals(out, 6)
    witness = {g: r[leaky] for g, r in resid.items()}
    assert C.budget_gate(resid, leaky, bars, witness)[1] == []
    for col in (2, 4):
        moved = {g: r.copy() for g, r in resid.items()}
        moved["sw_norm_dir"][col] += 2 * bars["sw_norm_dir"]
        failed = C.budget_gate(moved, leaky, bars, witness)[1]
        assert len(failed) == 1 and failed[0].startswith("sw_norm_dir")


def test_fields_of_names_nested_leaves():
    x, y, z = torch.ones(1), torch.zeros(2), torch.full((3,), 2.0)
    got = C.fields_of(({"a": x, "b": [y, {"c": z}]}, z))
    assert list(got) == ["/0/a", "/0/b/0", "/0/b/1/c", "/1"]
    assert got["/0/b/1/c"] is z and got["/1"] is z
    assert C.fields_of(x) == {"": x}


def test_max_rel_err_matches_fields_by_name():
    a = ({"x": torch.ones(3), "y": torch.zeros(2)},)
    b = ({"y": torch.zeros(2), "x": torch.full((3,), 1.5)},)
    assert C.max_rel_err(a, b) == pytest.approx(0.5 / 1.5)
    assert C.max_rel_err(a, ({"y": torch.zeros(2), "x": torch.full((3,), np.nan)},)) == np.inf
    with pytest.raises(ValueError):
        C.max_rel_err(a, ({"x": torch.ones(3)},))


_IMPORT_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["spartacus_surface_tpu"] = None
import spartacus_surface_tpu_torch.checks as C
import spartacus_surface_tpu_torch.entry as E
import torch
E.dryrun_multidevice(1, devices=["cpu"], verbose=False)
C.mesh(torch.device("cpu"), C=6, L=2)
bad = [m for m in sys.modules if (m == "jax" or m.startswith("jax.")
       or m.startswith("spartacus_surface_tpu.")) and sys.modules[m] is not None]
assert not bad, bad
print("clean")
"""


def test_checks_and_entry_import_without_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_BLOCKED], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr
