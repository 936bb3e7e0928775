"""The port's entry points (spartacus_surface_tpu_torch.entry) on the CPU,
at small sizes.

* entry() and every entry_matrix step against __graft_entry__'s JAX
  functions (jax.jit, the XLA path on the CPU) on the same
  __graft_entry__._example_inputs draw in float64, converted with
  utils/convert: field-normalized error <= 1e-9;
* dryrun_multidevice over two CPU entries against unsharded run_radsurf
  (1e-12, test_torch_parallel.py's bar);
* duplicate_profiles, which writes the cli check's input (checks.py).
"""

import inspect

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from spartacus_surface_tpu_torch import checks
from spartacus_surface_tpu_torch import entry as E
from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.convert import to_canopy_inputs
from spartacus_surface_tpu_torch.utils.inputs import example_arrays

TOL = 1e-9
CPU = torch.device("cpu")


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
    """Twin of tests/test_entry_matrix.py: the parity check's configs are
    ENTRY_CONFIGS, the JAX package's."""
    assert E.ENTRY_CONFIGS == g.ENTRY_CONFIGS
    assert inspect.signature(checks.parity).parameters["configs"].default == g.ENTRY_CONFIGS
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


def test_duplicate_profiles_writes_64_bit_offsets(tmp_path):
    """The cli check's input (50,048 copies of a 62 x 14 profile) exceeds a
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
