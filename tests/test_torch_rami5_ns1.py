"""The configuration rami5_ns1 (benchmark/configs/rami5_ns1.json): upstream
test/rami5's RAMI-V forests at 1 stream per hemisphere, SW and LW.  At
nreg 3 the SW solve has nd = ndir = 3, so the layer factory takes its
dense kernel K1d (N = 2 nd + ndir = 9, ops/layer_kernel.is_structured),
and the LW solve K1 at nd = 3, ndir = 1.

On the CPU: the plain reference (benchmark/reference) against the port's
scan route at 1 stream on every layered tile, all six tile types, SW and
LW, in float64; the work count (benchmark/work.py) of the SW factory at
N = 9; the cell rami5_ns1.f32 cut to a few columns, layers and bands, in
float64, through benchmark.run.run (run_radsurf's normal path against the
reference) under tight limits; the reader of kernels.k1d_roofline on
traces with and without a K1d event.  Marked cuda (skipped without a
GPU): replays of run_radsurf at a small rami5_ns1 shape bit-equal to the
eager calls under graphs.disabled(), each adding one SW K1d and one LW K1
launch, and an order pass before each, to the counters that the CLI's
``Kernel launches:`` line prints.
Imports nothing of JAX, so that the cuda test runs where JAX is missing
(pytest --noconftest).
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import generate as GEN
from benchmark import reference as R
from benchmark import run as BR
from benchmark import trace as TR
from benchmark import work as W
from benchmark.check import fields

from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
from spartacus_surface_tpu_torch.ops import launches
from spartacus_surface_tpu_torch.utils import graphs
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.inputs import example_arrays

CELL = "rami5_ns1.f32"
TIGHT = {"max_err": 1e-12, "rms_err": 1e-13, "sunlit_max_err": 1e-12, "sunlit_rms_err": 1e-13}


def small_cell(columns=12, nlay=6, bands=3, dtype="float64"):
    """The cell rami5_ns1.f32 at `columns` columns, `nlay` layers and
    `bands` SW and LW bands in `dtype`, checking every column under TIGHT."""
    cell = BR.load_cell(CELL)
    cfg = dict(cell.config, tiles={"VegetatedUrban": columns}, nlay=nlay,
               radsurf=dict(cell.config["radsurf"], nsw=bands, nlw=bands))
    return dataclasses.replace(
        cell, config=cfg, traffic=dict(cell.traffic, dtype=dtype),
        check={"columns_per_call": columns, "block_columns": columns, "limits": TIGHT})


def test_configuration_is_rami5_at_one_stream():
    ns1, base = BR.load_cell(CELL), BR.load_cell("rami5.f32")
    assert ns1.config["radsurf"] == dict(base.config["radsurf"], n_stream_sw_urban=1,
                                         n_stream_lw_urban=1)
    for key in ("tiles", "nlay", "fields", "reduced"):
        assert ns1.config[key] == base.config[key], key
    assert ns1.traffic == base.traffic
    assert [m["name"] for m in ns1.per_layer] == ["kernels.k1d_roofline"]
    assert {m["name"] for m in ns1.end_to_end} == {"columns_per_s", "setup_s"}


def test_reference_matches_the_scan_route_at_one_stream():
    """nreg 3 and 1 stream on every layered tile (Forest and
    VegetatedUrban nreg 3, Urban nreg 1), SW and LW, all six tile types."""
    radsurf = dict(n_vegetation_region_urban=2, n_vegetation_region_forest=2, nsw=2, nlw=2,
                   n_stream_sw_urban=1, n_stream_lw_urban=1, n_stream_sw_forest=1,
                   n_stream_lw_forest=1)
    arrays = example_arrays(C=24, L=3, S=2, dtype=np.float64, seed=11)
    arrays["cos_sza"][[2, 9]] = (-0.3, 0.01)  # a night column, a low sun
    program = fields(run_radsurf(Config(**radsurf).consolidate(), arrays, "cpu", route="scan"))
    ref = fields(R.run_radsurf(radsurf, arrays, "cpu", torch.float64))
    assert program.keys() == ref.keys()
    assert set(np.unique(arrays["i_representation"])) == set(range(6))
    for k, x in ref.items():
        torch.testing.assert_close(program[k], x, rtol=1e-12, atol=1e-12, msg=k)


def test_work_counts_the_sw_factory_at_nine():
    """At nd = ndir = 3 the SW factory's exponential is of the 9 x 9
    Gamma dz; the LW factory's of the 7 x 7 (nd 3, ndir 1)."""
    lu = lambda n: 2 * n**3 / 3
    solve = lambda n, m: lu(n) + 2 * n * n * m
    mm = lambda n, k, m: 2 * n * k * m
    expm9 = 4 * mm(9, 9, 9) + solve(9, 9)
    extract = solve(3, 6) + mm(3, 3, 3) + mm(3, 3, 3)
    schur = 3 * solve(3, 3) + 3 * mm(3, 3, 3) + solve(3, 3) + mm(3, 3, 3) + mm(3, 3, 3)
    assert W.factory_element_ops(3, 3, True) == pytest.approx(expm9 + extract + schur)

    cell = small_cell()
    radsurf = cell.config["radsurf"]
    a = GEN.input_set(cell.config, cell.traffic, 3_000_000_019, 0)
    w = W.call_work(radsurf, a, torch.float64, "cpu")
    C, L, S = a["dz"].shape[0], cell.config["nlay"], radsurf["nsw"]
    E = C * L * S
    ops, nbytes = w["factory_sw"]
    steps = (ops - E * W.factory_element_ops(3, 3, True)) / W.doubling_step_ops(3, 3)
    assert steps == pytest.approx(round(steps)) and round(steps) > 0
    # in: g0 (3 x 3), g1, g2 (3 x 3), g3 (3 x 3), dz; out: R, T, int_diff (3 x 3),
    # E, int_dir (3 x 3), Sup, Sdn, int_dir_diff (3 x 3)
    assert nbytes == E * (9 + 18 + 9 + 1 + 27 + 18 + 27) * 8
    lw_steps = ((w["factory_lw"][0] - E * (W.factory_element_ops(3, 1, False) + mm(3, 3, 1)))
                / W.doubling_step_ops(3, 1))
    assert lw_steps == pytest.approx(round(lw_steps)) and round(lw_steps) > 0


def test_cell_is_correct_through_the_normal_path_on_the_cpu():
    res = BR.run(small_cell(), 3_000_000_019, 0.5, False, "cpu")
    assert res["correct"] and res["failed"] == 0
    assert res["calls_checked"] == min(res["attempted"], 4)  # one call of each set run
    assert {n: c["value"] <= TIGHT[n] for n, c in res["checks"].items()} == dict.fromkeys(
        TIGHT, True)
    assert set(res["metrics"]) == {"columns_per_s", "setup_s"}


def test_traced_cell_on_the_cpu_reads_no_k1d():
    """A trace with no device events (the CPU's) leaves the metric out."""
    res = BR.run(small_cell(columns=4, nlay=3, bands=1), 7, 0.1, True, "cpu")
    assert res["correct"] and res["metrics"] == {}


def _trace(ops):
    work = [{"factory_sw": (2.0e9, 1.0e8), "factory_lw": (3.0e9, 2.0e8),
             "sweeps_sw": (1.0e9, 1.0e8), "sweeps_lw": (1.0e9, 1.0e8)}]
    return TR.Trace([TR.CallTrace(0.0, 10_000.0, 4, ops)], work, "float32",
                    TR.peaks("NVIDIA H100 80GB HBM3"))


def test_k1d_reader():
    read = BR.reader("metrics", "kernels.k1d_roofline")
    k1 = ("void layer_factory_kernel<float, 4, false>(spx::FactoryArgs<float>, spx::Slab, int)",
          0.0, 3000.0)
    k1d = ("void layer_factory_dense_kernel<float, 4>(spx::FactoryArgs<float>, spx::DenseSlab, int)",
           3000.0, 5000.0)
    assert read(_trace([k1])) is None
    assert read(_trace([])) is None
    # the SW factory's bound alone (2e9 operations at 67 TFLOP/s) over K1d's 2 ms
    assert read(_trace([k1, k1d])) == pytest.approx(100.0 * (2.0e9 / 67e12 * 1e3) / 2.0)
    assert read(TR.Trace(_trace([k1d]).calls, [], "float32", None)) is None


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_replays_are_eager_and_count_k1d():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    cell = small_cell(columns=96, nlay=8, bands=3, dtype="float32")
    config = Config(**cell.config["radsurf"]).consolidate()
    sets = GEN.input_sets(cell.config, cell.traffic, 2_718_281_829)
    graphs.clear()
    try:
        with graphs.disabled():
            ref = [fields(run_radsurf(config, a, "cuda")) for a in sets[:2]]
        run_radsurf(config, sets[0], "cuda")  # eager
        run_radsurf(config, sets[0], "cuda")  # captured
        assert graphs.stats()["graphs"] == 1
        per_replay = {"K1": 1, "K2": 1, "K3": 1, "K4": 1, "K5": 1, "K1d": 1, "K1 LW mode": 1,
                      "K1 order": 2}
        for i in (1, 0):
            before = launches.counts()
            out = fields(run_radsurf(config, sets[i], "cuda"))
            after = launches.counts()
            assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == per_replay
            for k, x in ref[i].items():
                assert torch.equal(out[k], x), k
        assert graphs.stats()["graphs"] == 1
    finally:
        graphs.clear()
