"""The port against the jitted JAX package at the degenerate corners of
tests/test_property_fuzz.py, float64 on the CPU: the kernel route (its
plain versions here) and the scan route against JAX spartacus_sw /
spartacus_lw at 1e-9 field-normalized, and both energy budgets.

The first test is the input on which the canopy-top roof at a building
fraction equal to min_building_fraction lost its reflection in the port
(the roof was the difference of two region-fraction sums, so rounding
decided the threshold test; models/geometry.py overlap_matrices_urban now
takes it from the building fractions).  The second runs the fuzz test's
corner values as a deterministic grid (utils/inputs.corner_grid), one call
per configuration.

Budgets: a column's residual (absorbed + net out - net in, per unit
top-of-canopy flux; the LW internal one per unit of the largest emission)
must equal the JAX package's to 1e-9 and must close, to 1e-10 (SW) and
1e-9 (LW), wherever the JAX package's closes.  Both packages leak where a
region lies at or below its minimum fraction (the reference's thresholds):
ROADMAP.md Queue C.  Horizon-sun columns through thick, bright layers are
held to their budgets only: there the doubling steps amplify rounding
(~1e-8) in both packages alike.
"""

import dataclasses
import functools

import numpy as np
import pytest

from spartacus_surface_tpu.models import solver as JS
from spartacus_surface_tpu.models.dispatch import run_radsurf as jax_run
from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss as JLG
from spartacus_surface_tpu.utils.config import Config as JConfig
from spartacus_surface_tpu_torch.models import solver as TS
from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss as TLG
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.convert import to_canopy_inputs
from spartacus_surface_tpu_torch.utils.inputs import corner_columns, corner_grid, example_arrays
from tests.test_solver_conservation import residual_sw
from tests.test_torch_lw import rr_err

TOL = 1e-9
SW_BAR, LW_BAR = 1e-10, 1e-9  # budget residuals, float64 (PERF.md section 2)
# (nreg, nstream, urban) of the grid; C1 showed at (3, 4, urban)
GRID_CONFIGS = ((3, 4, True), (2, 4, True), (2, 4, False), (1, 4, True))


def for_lw(inp):
    return dataclasses.replace(inp, air_ssa=np.zeros_like(inp.air_ssa))


@functools.lru_cache(maxsize=None)
def grid():
    """(JAX CanopyInputs, horizon mask) of utils/inputs.corner_grid."""
    fields, horizon = corner_grid()
    return JS.CanopyInputs(**fields), horizon


def c1_column():
    """C1's column: vf 1e-9, bf 1e-6 (= min_building_fraction), cos_sza
    0.5; fsd 0.5, ext 0.1, contact 0.5, ssa 0.5."""
    return JS.CanopyInputs(**corner_columns(
        [1e-9], [1e-6], [0.5], [0.5], [0.1], [0.5], [0.5])), None


CASES = {"c1": c1_column, "grid": grid}


def per_column_err(ref, got):
    """Per column, the worst field-normalized error over the three output
    dicts (each field's scale: max(1, max|ref|) over all columns)."""
    worst = 0.0
    for rd, gd in zip(ref, got):
        assert set(rd) == set(gd), set(rd) ^ set(gd)
        for k in rd:
            r, g = np.asarray(rd[k], np.float64), gd[k].numpy()
            assert r.shape == g.shape and np.isfinite(g).all(), k
            err = np.abs(r - g).reshape(len(r), -1).max(1) / max(1.0, np.abs(r).max())
            worst = np.maximum(worst, err)
    return worst


@functools.lru_cache(maxsize=None)
def jax_solve(case, nreg, ns, urban, lw):
    """JAX spartacus_sw / spartacus_lw (jitted) on CASES[case]()."""
    x = CASES[case]()[0]
    jf = JS.spartacus_lw if lw else JS.spartacus_sw
    return jf(for_lw(x) if lw else x,
              JS.SolverOptions(nreg=nreg, nstream=ns, do_urban=urban), JLG(ns))


def solve_both(case, nreg, ns, urban, lw, route):
    """(inputs, JAX outputs, port outputs) of one solve of CASES[case]()."""
    x = CASES[case]()[0]
    tf = TS.spartacus_lw if lw else TS.spartacus_sw
    got = tf(to_canopy_inputs(for_lw(x) if lw else x, "cpu"), TS.SolverOptions(
        nreg=nreg, nstream=ns, do_urban=urban), TLG(ns), route=route)
    return x, jax_solve(case, nreg, ns, urban, lw), got


def check_budgets(inp, ref, got, lw):
    """Each flux dict's residual equals the JAX package's to TOL and closes
    wherever the JAX package's closes (module docstring)."""
    scale = max(1.0, float(np.abs(inp.ground_emission).max()),
                float(np.abs(inp.wall_emission).max())) if lw else 1.0
    for k, (rd, gd) in enumerate(zip(ref[:2], got[:2])):
        s = scale if lw and k == 0 else 1.0  # LW internal: W m-2
        bar = (LW_BAR if lw else SW_BAR) * s
        rj = residual_sw({n: np.asarray(v) for n, v in rd.items()})
        rp = residual_sw({n: v.numpy() for n, v in gd.items()})
        np.testing.assert_allclose(rp, rj, rtol=0, atol=TOL * s)
        closed = np.abs(rj) <= bar
        assert (np.abs(rp[closed]) <= bar).all(), np.abs(rp[closed]).max()


@pytest.mark.parametrize("route", ["kernel", "scan"])
@pytest.mark.parametrize("lw", [False, True], ids=["sw", "lw"])
def test_roof_at_min_building_fraction(lw, route):
    """C1's column (c1_column), 2 layers of 5 m, 1 band, nreg 3, 4 streams,
    urban: the roof reflects as under jitted JAX, and both budgets close as
    there."""
    inp, ref, got = solve_both("c1", 3, 4, True, lw, route)
    assert per_column_err(ref, got).max() < TOL
    check_budgets(inp, ref, got, lw)


def test_roof_at_min_building_fraction_run_radsurf():
    """The same column through run_radsurf, a VegetatedUrban tile with
    n_vegetation_region_urban = 2, SW and LW."""
    a = example_arrays(C=1, L=2, S=1, dtype=np.float64, i_representation=[3])
    a.update(dz=np.full((1, 2), 5.0), cos_sza=np.full(1, 0.5),
             veg_fraction=np.full((1, 2), 1e-9),
             building_fraction=np.full((1, 2), 1e-6))
    kw = dict(do_lw=True, nsw=1, nlw=1, n_vegetation_region_urban=2,
              n_stream_sw_urban=4, n_stream_lw_urban=4)
    ref = jax_run(JConfig(**kw).consolidate(), a)
    got = run_radsurf(Config(**kw).consolidate(), a, "cpu")
    assert rr_err(ref, got) < TOL


@pytest.mark.parametrize("route", ["kernel", "scan"])
@pytest.mark.parametrize("lw", [False, True], ids=["sw", "lw"])
@pytest.mark.parametrize("nreg,ns,urban", GRID_CONFIGS)
def test_corner_grid(nreg, ns, urban, lw, route):
    """The 500-column corner grid: every column within 1e-9 of jitted JAX
    but the horizon-sun thick bright ones, and the budgets (docstring)."""
    horizon = grid()[1]
    inp, ref, got = solve_both("grid", nreg, ns, urban, lw, route)
    err = per_column_err(ref, got)
    assert err[~horizon].max() < TOL, np.argmax(np.where(horizon, 0.0, err))
    check_budgets(inp, ref, got, lw)


F32_BAR = 3e-4  # phase 3's float32 SW bar (chip_smoke.py)


def f32_departure(ref64, got32):
    """Per column, the worst field-normalized distance of a float32 solve
    from the float64 one on the same inputs (per_column_err's scale)."""
    worst = 0.0
    for rd, gd in zip(ref64, got32):
        for k in rd:
            r = np.asarray(rd[k], np.float64)
            g = np.asarray(gd[k].numpy() if hasattr(gd[k], "numpy") else gd[k], np.float64)
            err = np.abs(r - g).reshape(len(r), -1).max(1) / max(1.0, np.abs(r).max())
            worst = np.maximum(worst, err)
    return worst


@pytest.mark.parametrize("nreg,ns,urban", GRID_CONFIGS)
def test_corner_grid_float32_departs_as_jax_does(nreg, ns, urban):
    """In float32 the SW solve misses its own float64 answer by more than
    F32_BAR on many corner columns: the float32 formulation's rounding, in
    both packages alike.  Per configuration: the port's kernel and scan
    routes depart on no more columns than jitted JAX does, with a column
    or so of slack, and by no more at their worst; the counts are printed
    (pytest -s)."""
    x = grid()[0]
    x32 = dataclasses.replace(x, **{f.name: np.asarray(getattr(x, f.name), np.float32)
                                    for f in dataclasses.fields(x)
                                    if getattr(x, f.name) is not None})
    opt = dict(nreg=nreg, nstream=ns, do_urban=urban)
    jax64 = jax_solve("grid", nreg, ns, urban, False)
    counts, worst = {}, {}
    err = f32_departure(jax64, JS.spartacus_sw(x32, JS.SolverOptions(**opt), JLG(ns)))
    counts["jax"], worst["jax"] = int((err > F32_BAR).sum()), float(err.max())
    port64 = TS.spartacus_sw(to_canopy_inputs(x, "cpu"), TS.SolverOptions(**opt), TLG(ns),
                             route="scan")
    for route in ("kernel", "scan"):
        got = TS.spartacus_sw(to_canopy_inputs(x32, "cpu"), TS.SolverOptions(**opt), TLG(ns),
                              route=route)
        err = f32_departure(port64, got)
        counts[route], worst[route] = int((err > F32_BAR).sum()), float(err.max())
    print(f"corner grid SW float32 vs float64, nreg {nreg} ns {ns} urban {urban}:"
          f" columns > {F32_BAR:g} {counts}, worst {worst}")
    for route in ("kernel", "scan"):
        assert counts[route] <= counts["jax"] + 5, counts
        assert worst[route] <= 1.01 * worst["jax"], worst
