"""The port's bench and entry points (spartacus_surface_tpu_torch.bench,
.entry) on the CPU, at small sizes.

* entry() and every entry_matrix step against __graft_entry__'s JAX
  functions (jax.jit, the XLA path on the CPU) on the same
  __graft_entry__._example_inputs draw in float64, converted with
  utils/convert: field-normalized error <= 1e-9;
* dryrun_multidevice over two CPU entries against unsharded run_radsurf
  (1e-12, test_torch_parallel.py's bar);
* every bench block on --device cpu with small shapes through its
  arguments: its line, its keys, the parity and mesh gates passed; the
  --trace line; main's order (the float32 headline last), its exit code 1
  when a block raises and its refusal of a missing card;
* bench and entry import with JAX and the JAX package blocked.
"""

import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from spartacus_surface_tpu_torch import bench as B
from spartacus_surface_tpu_torch import entry as E
from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
from spartacus_surface_tpu_torch.models.solver import SolverOptions
from spartacus_surface_tpu_torch.ops.launches import PATH_4
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.convert import to_canopy_inputs
from spartacus_surface_tpu_torch.utils.inputs import example_arrays

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-9
CPU = torch.device("cpu")
# small shapes of every bench block, by metric
SMALL = {
    "build_check_matrix_ok": lambda b: B.build_block(b, C=16, L=2),
    "kernel_scan_parity_max_rel_err": lambda b: B.parity_block(b, C=8, L=3),
    "mesh_sharded_parity_max_rel_err": lambda b: B.mesh_block(b, C=12, L=3),
    "columns_per_sec_per_chip_sw_lw_urban8lay_nreg3": lambda b: B.nreg3_block(b, C=8, L=3),
    "columns_per_sec_per_chip_rami5_62lay_14band_nreg3":
        lambda b: B.rami5_block(b, "float32", C=4, L=5, S=3),
    "columns_per_sec_per_chip_rami5_62lay_14band_nreg3_f64":
        lambda b: B.rami5_block(b, "float64", C=4, L=5, S=3),
    "cli_end_to_end_columns_per_sec": lambda b: B.cli_block(b, ncol=1012, L=3, S=2),
    "grad_step_columns_per_sec_per_chip": lambda b: B.grad_block(b, C=8, L=3),
    "capacity_1M_columns_per_sec_per_chip": lambda b: B.capacity_block(b, C=64, L=3),
    "columns_per_sec_per_chip_sw_lw_urban8lay_f64":
        lambda b: B.headline_block(b, "float64", C=16, L=3),
    "columns_per_sec_per_chip_sw_lw_urban8lay":
        lambda b: B.headline_block(b, "float32", C=16, L=3),
}
THROUGHPUT_KEYS = {"value", "unit", "columns", "n_cards", "median_ms", "percentile",
                   "percentile_ms", "min_ms", "max_ms", "n", "peak_gib", "first_call_s",
                   "capture_s", "captures", "finite", "dtype", "shape", "card"}
BLOCK_KEYS = {
    "build_check_matrix_ok": {"value", "unit", "ok", "build_seconds", "launches"},
    "kernel_scan_parity_max_rel_err": {"value", "value_f64", "ok", "per_config"},
    "mesh_sharded_parity_max_rel_err": {"value", "ok", "n_mesh_devices"},
    "cli_end_to_end_columns_per_sec": {"value", "unit", "ncol", "read_s", "solve_s",
                                       "save_s", "conservation_max_residual", "residual_bars",
                                       "residuals_in_process", "launches"},
    "grad_step_columns_per_sec_per_chip": THROUGHPUT_KEYS - {"budget_max_residual"},
    "capacity_1M_columns_per_sec_per_chip": THROUGHPUT_KEYS | {"auto_column_chunk",
                                                               "budget_max_residual"},
}


def field_err(ref, got) -> float:
    """Worst per-field max|got - ref| / max(1, max|ref|) over matched
    numpy / tensor outputs."""
    worst = 0.0
    assert len(ref) == len(got)
    for r, x in zip(ref, got):
        r, x = np.asarray(r, np.float64), x.numpy().astype(np.float64)
        assert r.shape == x.shape and np.isfinite(x).all() and np.isfinite(r).all()
        worst = max(worst, np.abs(x - r).max() / max(1.0, np.abs(r).max()))
    return worst


def lines(text) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("idx", range(len(E.ENTRY_CONFIGS)),
                         ids=[f"nreg{r}_ns{s}" for r, s in E.ENTRY_CONFIGS])
def test_entry_matrix_matches_jax(idx):
    """Each config's SW + LW step against __graft_entry__'s, float64."""
    jname, jfn, _ = g.entry_matrix()[idx]
    name, fn, _ = E.entry_matrix(CPU, np.float64, C=8, L=4)[idx]
    assert name == jname
    sw, lw = g._example_inputs(C=16, L=4, S=1, dtype=np.float64)
    ref = jax.jit(jfn)(sw, lw)
    got = fn(to_canopy_inputs(sw, CPU), to_canopy_inputs(lw, CPU))
    assert field_err(ref, got) <= TOL


def test_entry_matches_jax():
    jfn, _ = g.entry()
    fn, (inp,) = E.entry(CPU, np.float64)
    assert inp.dz.shape == (8, 4) and inp.air_ext.shape == (8, 4, 2)
    sw, _ = g._example_inputs(dtype=np.float64)
    np.testing.assert_array_equal(inp.veg_ext.numpy(), sw.veg_ext)
    assert field_err(jax.jit(jfn)(sw), fn(to_canopy_inputs(sw, CPU))) <= TOL


def test_entry_configs_match_the_jax_matrix_and_the_parity_block():
    """Twin of tests/test_entry_matrix.py: the parity block's configs are
    ENTRY_CONFIGS, the JAX package's."""
    assert E.ENTRY_CONFIGS == g.ENTRY_CONFIGS
    assert inspect.signature(B.parity_block).parameters["configs"].default == g.ENTRY_CONFIGS
    assert [n for n, _, _ in E.entry_matrix(CPU, C=2, L=1)] == [
        f"nreg{r}_ns{s}" for r, s in g.ENTRY_CONFIGS]


def test_dryrun_multidevice_matches_unsharded():
    got = E.dryrun_multidevice(2, devices=["cpu", "cpu"], dtype=np.float64)
    config = Config(nsw=1, nlw=1, n_vegetation_region_forest=1, n_vegetation_region_urban=1,
                    do_save_flux_profile=True).consolidate()
    ref = run_radsurf(config, example_arrays(C=6, L=3, S=1, dtype=np.float64), "cpu")
    assert ref.keys() == got.keys()
    for grp, fields in ref.items():
        for k, v in fields.items():
            np.testing.assert_allclose(got[grp][k].numpy(), v.numpy(), rtol=1e-12,
                                       atol=1e-12, err_msg=f"{grp}/{k}")


def test_dryrun_multidevice_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.dryrun_multidevice(2)
    with pytest.raises(ValueError, match="2 entries, but 3"):
        E.dryrun_multidevice(2, devices=["cpu"] * 3)


def test_build_check_matrix_on_the_cpu_needs_no_build():
    res = E.build_check_matrix(CPU, verbose=False, C=4, L=2)
    assert res["build_seconds"] is None
    assert list(res["launches"]) == [f"nreg{r}_ns{s}" for r, s in E.ENTRY_CONFIGS]


@pytest.mark.parametrize("metric", list(SMALL))
def test_bench_block_on_cpu(metric, capsys):
    """Each block's line at a small shape: its metric, its keys, the
    card; the gates of the parity and mesh blocks pass."""
    b = B.Bench(device=CPU, reps=3)
    SMALL[metric](b)
    out = lines(capsys.readouterr().out)
    assert [ln["metric"] for ln in out] == [metric]
    line = out[0]
    assert "error" not in line
    assert BLOCK_KEYS.get(metric, THROUGHPUT_KEYS | {"budget_max_residual"}) <= line.keys()
    assert line["card"] == "cpu"
    if "ok" in line:
        assert line["ok"] is True
    if "auto_column_chunk" in line:  # off the card AUTO takes one shot
        assert line["auto_column_chunk"] == {"sw": 0, "lw": 0}
    if "launches" in line and metric.startswith("cli"):  # the CLI's own count: none on the CPU
        assert set(line["launches"]) >= set(PATH_4) and not any(line["launches"].values())
        assert list(line["residuals_in_process"]) == ["kernel float32", "scan float32",
                                                      "scan float64"]
    if "median_ms" in line:
        assert line["n"] == 3 and line["percentile"] is None and line["peak_gib"] is None
        assert line["value"] == pytest.approx(line["columns"] / line["median_ms"] * 1e3)
        assert line["min_ms"] <= line["median_ms"] <= line["max_ms"]


def test_trace_line_precedes_the_block_line(capsys):
    b = B.Bench(device=CPU, reps=1, trace=True)
    B.headline_block(b, "float32", C=8, L=2)
    out = lines(capsys.readouterr().out)
    assert [ln["metric"] for ln in out] == ["per_layer_device_ms",
                                           "columns_per_sec_per_chip_sw_lw_urban8lay"]
    assert out[0]["block"] == out[1]["metric"]
    # no device on the CPU: device numbers are not measured
    assert out[0]["kernel_device_ms"] is None and out[0]["device_idle_share"] is None
    assert out[0]["traced_call_ms"] > 0


@pytest.mark.parametrize("dname", ["float32", "float64"])
def test_sub_threshold_roofs_are_held_to_the_scan_route(dname):
    """A column whose building fraction steps by less than
    min_building_fraction is found, its residual witnessed by the scan
    route within the bar; a residual moved past the bar on it, or on
    another column, fails the gate."""
    opt, lg = SolverOptions(nreg=2, nstream=4, do_urban=True), LegendreGauss(4)
    sw, lw = E.canopy_inputs(6, 4, 2, B.DTYPES[dname], CPU, 0)
    for inp in (sw, lw):
        inp.building_fraction[2, 1] = inp.building_fraction[2, 0] + 0.5 * opt.min_building_fraction
    out = B.sw_lw(sw, lw, opt, lg)
    found = B.budget_worst(out, sw, lw, opt, lg, dname)["budget_max_residual"]
    assert found["sub_threshold_roof_columns"] == 1
    assert "lw_internal sub-threshold roof, scan route" in found
    leaky = B.sub_threshold_roofs(sw.building_fraction, opt.min_building_fraction)
    assert leaky.tolist() == [False, False, True, False, False, False]
    bars = B.budget_bars(dname, B.lw_scale(lw))
    resid = B.budget_residuals(out, 6)
    witness = {g: r[leaky] for g, r in resid.items()}
    assert B.budget_gate(resid, leaky, bars, witness)[1] == []
    for col in (2, 4):
        moved = {g: r.copy() for g, r in resid.items()}
        moved["sw_norm_dir"][col] += 2 * bars["sw_norm_dir"]
        failed = B.budget_gate(moved, leaky, bars, witness)[1]
        assert len(failed) == 1 and failed[0].startswith("sw_norm_dir")


def test_percentile_keeps_ten_samples_beyond():
    assert B.percentile(list(range(40)))[0] == "p75"
    assert B.percentile(list(range(100)))[0] == "p90"
    assert B.percentile(list(range(20)))[0] == "p50"
    assert B.percentile(list(range(11))) == (None, None)


def test_max_rel_err_matches_fields_by_name():
    a = ({"x": torch.ones(3), "y": torch.zeros(2)},)
    b = ({"y": torch.zeros(2), "x": torch.full((3,), 1.5)},)
    assert B.max_rel_err(a, b) == pytest.approx(0.5 / 1.5)
    assert B.max_rel_err(a, ({"y": torch.zeros(2), "x": torch.full((3,), np.nan)},)) == np.inf
    with pytest.raises(ValueError):
        B.max_rel_err(a, ({"x": torch.ones(3)},))


def small_blocks():
    """bench.BLOCKS with each block at its SMALL shape."""
    return tuple((name, metric, SMALL[metric]) for name, metric, _ in B.BLOCKS
                 if metric != "cli_end_to_end_columns_per_sec")


def test_main_runs_the_blocks_in_order_headline_last(monkeypatch, capsys):
    monkeypatch.setattr(B, "BLOCKS", small_blocks())
    assert B.main(["--device", "cpu", "--reps", "2"]) == 0
    out = lines(capsys.readouterr().out)
    assert [ln["metric"] for ln in out] == [m for _, m, _ in small_blocks()]
    assert out[-1]["metric"] == "columns_per_sec_per_chip_sw_lw_urban8lay"


def test_main_selects_blocks(monkeypatch, capsys):
    monkeypatch.setattr(B, "BLOCKS", small_blocks())
    assert B.main(["--device", "cpu", "--reps", "1", "--block", "headline"]) == 0
    assert [ln["metric"] for ln in lines(capsys.readouterr().out)] == [
        "columns_per_sec_per_chip_sw_lw_urban8lay_f64",
        "columns_per_sec_per_chip_sw_lw_urban8lay"]


def test_a_failed_block_prints_its_error_and_fails_main(monkeypatch, capsys):
    def boom(b):
        raise RuntimeError("injected failure")

    blocks = [(n, m, boom if n == "mesh" else f) for n, m, f in small_blocks()
              if n in ("mesh", "headline")]
    monkeypatch.setattr(B, "BLOCKS", tuple(blocks))
    assert B.main(["--device", "cpu", "--reps", "1"]) == 1
    out = lines(capsys.readouterr().out)
    assert out[0]["metric"] == "mesh_sharded_parity_max_rel_err"
    assert "injected failure" in out[0]["error"]
    # the other blocks still ran
    assert out[-1]["metric"] == "columns_per_sec_per_chip_sw_lw_urban8lay"
    assert "error" not in out[-1]


def test_bench_refuses_a_missing_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert B.main(["--block", "headline"]) == 1
    assert lines(capsys.readouterr().out) == []


_IMPORT_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["spartacus_surface_tpu"] = None
import spartacus_surface_tpu_torch.bench as B
import spartacus_surface_tpu_torch.entry as E
import torch
E.dryrun_multidevice(1, devices=["cpu"], verbose=False)
B.mesh_block(B.Bench(device=torch.device("cpu")), C=6, L=2)
bad = [m for m in sys.modules if (m == "jax" or m.startswith("jax.")
       or m.startswith("spartacus_surface_tpu.")) and sys.modules[m] is not None]
assert not bad, bad
print("clean")
"""


def test_bench_and_entry_import_without_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_BLOCKED], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_duplicate_profiles_writes_64_bit_offsets(tmp_path):
    """The CLI block's input (50,048 copies of a 62 x 14 profile) exceeds a
    classic NetCDF file's 2 GiB offsets: the copies are written with 64-bit
    offsets, and read back as they were."""
    from scipy.io import netcdf_file

    from spartacus_surface_tpu_torch.driver.duplicate_profiles import duplicate_profiles
    from spartacus_surface_tpu_torch.utils.inputs import write_example_input

    write_example_input(tmp_path / "one.nc", [1], L=3, S=2)
    duplicate_profiles(str(tmp_path / "one.nc"), str(tmp_path / "dup.nc"), n_copies=5)
    with netcdf_file(tmp_path / "dup.nc", "r", mmap=False) as f:
        assert f.version_byte == 2 and f.dimensions["column"] == 5
        veg = np.array(f.variables["veg_extinction"][:])
    with netcdf_file(tmp_path / "one.nc", "r", mmap=False) as f:
        np.testing.assert_array_equal(veg, np.tile(f.variables["veg_extinction"][:], (5, 1)))
