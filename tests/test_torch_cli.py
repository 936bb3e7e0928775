"""The port's offline CLI and its modules against the JAX package, on the CPU.

Every input is written by utils/inputs.write_example_input into tmp_path: a
few columns of every tile type (Flat, Forest, Urban, VegetatedUrban,
SimpleUrban, InfiniteStreet) by 3 layers.  Held to the JAX package:

* Config / DriverConfig.from_namelist fields and the print_config text
  (equal);
* read_input arrays and top-of-canopy fluxes (equal), simple_spectrum
  (1e-12 relative);
* save_canopy_fluxes: variables, dimensions, attributes (the global
  ``source`` names the build) and values (equal, on the same fluxes);
* the whole CLI (``--device cpu``) against the JAX CLI run as a subprocess
  (``--platform=cpu --mesh=off``), variable by variable at 1e-9
  field-normalized (max|port - jax| / max(1, max|jax|)) in float64, for a
  4-stream and a 1-stream namelist;
* ``--netcdf4``: the port's NetCDF4 file, read by the JAX package's
  libnetcdf reader, against the JAX CLI's NetCDF3 file (1e-9), and a
  NetCDF4 round trip and NetCDF4 input through the port's own binding
  (both skipped where libnetcdf is missing);
* the kernel demo: the same printed matrices, operators at 1e-12, the
  Schur self-check passed.

Also: the refusals (``--device cuda`` without CUDA, a CUDA mesh wider than
the visible cards), column range and nrepeat, single precision, --profile.
The streamed, meshed and multi-process runs are held in
tests/test_torch_streaming.py, test_torch_parallel.py and
test_torch_multiprocess.py.
"""

import contextlib
import dataclasses
import importlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from spartacus_surface_tpu.driver import read_input as JRI
from spartacus_surface_tpu.driver import save as JSV
from spartacus_surface_tpu.models.simple_spectrum import (
    calc_simple_spectrum_lw as j_simple_spectrum)
from spartacus_surface_tpu.utils import config as JC
from spartacus_surface_tpu.utils import netcdf_c as JNC
from spartacus_surface_tpu_torch.driver import main as TMAIN
from spartacus_surface_tpu_torch.driver import read_input as TRI
from spartacus_surface_tpu_torch.driver import save as TSV
from spartacus_surface_tpu_torch.driver import test_kernels as TTK
from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
from spartacus_surface_tpu_torch.models.simple_spectrum import (
    calc_simple_spectrum_lw as t_simple_spectrum)
from spartacus_surface_tpu_torch.utils import config as TC
from spartacus_surface_tpu_torch.utils import netcdf_c, profiling
from spartacus_surface_tpu_torch.utils import netcdf_io as TIO
from spartacus_surface_tpu_torch.utils.inputs import write_example_input

REPO = Path(__file__).resolve().parents[1]
TILES = np.repeat([0, 1, 2, 3, 4, 5], 3)  # every tile type, 3 columns each
TOL = 1e-9

RADSURF = {
    "ns4": """
  n_stream_sw_forest = 4, n_stream_sw_urban = 4,
  n_stream_lw_forest = 4, n_stream_lw_urban = 4,
  do_save_flux_profile = .true., do_save_spectral_flux = .true.,""",
    "ns1": """
  n_stream_sw_forest = 1, n_stream_sw_urban = 1,
  n_stream_lw_forest = 1, n_stream_lw_urban = 1,""",
}


def namelist(path, streams="ns4", radsurf_extra="", driver_extra=""):
    """A CLI namelist: 2 forest and 1 urban vegetation regions, one band,
    the conservation check on."""
    path.write_text(f"""! written by tests/test_torch_cli.py
&radsurf
  n_vegetation_region_forest = 2, n_vegetation_region_urban = 1,
  nsw = 1, nlw = 1,{RADSURF[streams]}{radsurf_extra}
/
&radsurf_driver
  do_conservation_check = .true.,
  iverbose = 3,{driver_extra}
/
""")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: path}: the input file and one namelist per stream count."""
    d = tmp_path_factory.mktemp("cli")
    write_example_input(d / "in.nc", TILES, L=3, S=1, seed=7)
    return {"dir": d, "input": str(d / "in.nc"),
            **{s: namelist(d / f"{s}.nam", s) for s in RADSURF}}


def read_nc(path):
    """(dimensions, global attributes, {name: (dims, attributes, values)})."""
    with netcdf_file(path, "r", mmap=False) as f:
        return (dict(f.dimensions), dict(f._attributes),
                {k: (v.dimensions, dict(v._attributes), np.array(v[:]))
                 for k, v in f.variables.items()})


def nc_field_err(ref, got):
    """Worst field-normalized error over the variables; the two files must
    hold the same variables with the same dimensions and types."""
    assert ref[0] == got[0]
    assert set(ref[2]) == set(got[2]), set(ref[2]) ^ set(got[2])
    worst = 0.0
    for k, (dims, _, r) in ref[2].items():
        g = got[2][k][2]
        assert got[2][k][0] == dims and g.dtype == r.dtype, k
        r, g = r.astype(np.float64), g.astype(np.float64)
        worst = max(worst, np.abs(r - g).max() / max(1.0, np.abs(r).max()))
    return worst


def run_port(*argv):
    """(exit code, stdout, stderr) of the port's CLI in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = TMAIN.main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


# ----------------------------------------------------------------------
# the modules
# ----------------------------------------------------------------------

def test_config_from_namelist_and_print_config_match_jax(tmp_path):
    nam = namelist(
        tmp_path / "c.nam", "ns1",
        radsurf_extra="\n  do_urban = .false., min_vegetation_fraction = 2.5d-5,"
                      " ! comment\n  vegetation_isolation_factor_forest = 0.3,",
        driver_extra="\n  solar_zenith_angle = 30.0, nrepeat = 2,"
                     " istartcol = 2, iendcol = 5,\n  vegetation_fsd = 0.6,"
                     " top_flux_dn_sw = 500,")
    for tcls, jcls in ((TC.Config, JC.Config), (TC.DriverConfig, JC.DriverConfig)):
        assert ([f.name for f in dataclasses.fields(tcls)]
                == [f.name for f in dataclasses.fields(jcls)])
        t, j = (dataclasses.asdict(c.from_namelist(nam)) for c in (tcls, jcls))
        # both column_chunk defaults are -1 (AUTO)
        assert t.get("column_chunk", -1) == j.get("column_chunk", -1) == -1
        assert t == j
    assert TC.DriverConfig.from_namelist(nam).cos_sza_override == pytest.approx(
        np.cos(np.pi / 6))
    texts = []
    for cls in (TC.Config, JC.Config):
        buf = io.StringIO()
        cls.from_namelist(nam).consolidate().print_config(iverbose=3, out=buf)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1] and "streams per hemisphere = 1" in texts[0]


@pytest.mark.parametrize("case", ["plain", "overrides", "two_bands"])
def test_read_input_matches_jax(tmp_path, case):
    bands = 2 if case == "two_bands" else 1
    path = tmp_path / "in.nc"
    write_example_input(path, TILES, L=3, S=bands, seed=3)
    extra = {"plain": ("", ""),
             "overrides": ("", "\n  vegetation_fsd = 0.6, ground_sw_albedo = 0.2,"
                               " top_flux_dn_lw = 350.0, cos_solar_zenith_angle = 0.4,"),
             "two_bands": ("\n  nsw = 2, nlw = 2, lw_band_fraction = 0.3, 0.7,", "")}
    nam = namelist(tmp_path / "c.nam", "ns4", *extra[case])
    got = TRI.read_input(str(path), TC.Config.from_namelist(nam).consolidate(),
                         TC.DriverConfig.from_namelist(nam))
    ref = JRI.read_input(str(path), JC.Config.from_namelist(nam).consolidate(),
                         JC.DriverConfig.from_namelist(nam))
    assert set(got) == set(ref) and set(got["arrays"]) == set(ref["arrays"])
    for k, v in ref["arrays"].items():
        assert got["arrays"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got["arrays"][k], v, err_msg=k)
    for k in ("ncol", "nlay_max", "top_flux_dn_sw", "top_flux_dn_direct_sw",
              "top_flux_dn_lw"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["arrays"]["ground_albedo"].shape == (TILES.size, bands)

    tcfg = TC.Config.from_namelist(nam).consolidate()
    jcfg = JC.Config.from_namelist(nam).consolidate()
    t_simple_spectrum(tcfg, got["arrays"])
    j_simple_spectrum(jcfg, ref["arrays"])
    for k in ("ground_emission", "roof_emission", "wall_emission",
              "clear_air_planck", "veg_planck", "veg_air_planck"):
        np.testing.assert_allclose(got["arrays"][k], ref["arrays"][k],
                                   rtol=1e-12, atol=0, err_msg=k)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("extras", [False, True], ids=["broadband", "profiles_spectral"])
def test_save_matches_jax(files, tmp_path, extras, dtype):
    """The same fluxes (the port's scaled and summed solve) written by both
    packages' save_canopy_fluxes."""
    extra = ("\n  do_save_flux_profile = .true., do_save_spectral_flux = .true.,"
             if extras else "")
    nam = namelist(tmp_path / "c.nam", "ns1", extra)
    cfg = TC.Config.from_namelist(nam).consolidate()
    data = TRI.read_input(files["input"], cfg, TC.DriverConfig.from_namelist(nam))
    arrays = data["arrays"]
    t_simple_spectrum(cfg, arrays)
    solve_arrays, top = TMAIN.prepare(cfg, data, dtype, "cpu")
    sw, lw = TMAIN.scale_and_sum(cfg, run_radsurf(cfg, solve_arrays, "cpu"), top)
    TSV.save_canopy_fluxes(str(tmp_path / "t.nc"), cfg, arrays, sw, lw)
    host = lambda f: {k: v.numpy() for k, v in f.items()}
    JSV.save_canopy_fluxes(str(tmp_path / "j.nc"), JC.Config.from_namelist(nam),
                           arrays, host(sw), host(lw))
    ref, got = read_nc(tmp_path / "j.nc"), read_nc(tmp_path / "t.nc")
    assert ref[0] == got[0]
    assert {k: v for k, v in ref[1].items() if k != "source"} == {
        k: v for k, v in got[1].items() if k != "source"}
    assert b"PyTorch" in got[1]["source"]
    assert set(ref[2]) == set(got[2])
    for k, (dims, attrs, val) in ref[2].items():
        assert got[2][k][0] == dims and got[2][k][1] == attrs, k
        assert got[2][k][2].dtype == val.dtype, k
        np.testing.assert_array_equal(got[2][k][2], val, err_msg=k)
    flux_type = np.float32 if dtype == np.float32 else np.float64
    assert got[2]["ground_flux_dn_sw"][2].dtype == np.dtype(flux_type).newbyteorder(">")


# ----------------------------------------------------------------------
# the CLI end to end
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_cli(files):
    """{streams: path of the JAX CLI's output}; both JAX CLI subprocesses
    run at the same time."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", SPARTACUS_COMPILE_CACHE="0",
               PYTHONPATH=str(REPO))
    procs = {}
    for s in RADSURF:
        out = files["dir"] / f"jax_{s}.nc"
        procs[s] = (out, subprocess.Popen(
            [sys.executable, "-m", "spartacus_surface_tpu.driver.main",
             files[s], files["input"], str(out), "--platform=cpu", "--mesh=off"],
            cwd=files["dir"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = {}
    for s, (out, p) in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-2000:]
        outs[s] = (out, stdout)
    return outs


@pytest.mark.parametrize("streams", list(RADSURF))
def test_cli_matches_jax_cli(files, jax_cli, streams):
    out = files["dir"] / f"port_{streams}.nc"
    rc, stdout, err = run_port(files[streams], files["input"], out, "--device", "cpu")
    assert rc == 0, err
    assert nc_field_err(read_nc(jax_cli[streams][0]), read_nc(out)) <= TOL
    for line in ("Time elapsed in radiative transfer",
                 "Direct shortwave budget", "Incoming longwave budget"):
        assert line in stdout and line in jax_cli[streams][1]


@pytest.mark.skipif(not netcdf_c.available(), reason="libnetcdf missing")
def test_netcdf4_output_matches_jax_cli(files, jax_cli):
    """--netcdf4 writes NetCDF4/HDF5 through the port's libnetcdf binding:
    read back by the JAX package's reader, it holds the variables,
    dimensions, text attributes and values of the JAX CLI's NetCDF3 file."""
    out = files["dir"] / "port_ns4_hdf5.nc"
    rc, _, err = run_port(files["ns4"], files["input"], out, "--device", "cpu",
                          "--netcdf4")
    assert rc == 0, err
    assert out.read_bytes()[:4] == b"\x89HDF"
    dims, _, ref = read_nc(jax_cli["ns4"][0])
    f = JNC.NativeFile(str(out))
    try:
        assert f.dimensions() == dims and set(f.variables()) == set(ref)
        for k, (rdims, rattrs, r) in ref.items():
            assert f.var_dimensions(k) == rdims, k
            attrs = f.attributes(k)
            for a, v in rattrs.items():
                if isinstance(v, bytes):
                    assert attrs[a] == v.decode(), (k, a)
            g = f.get(k)
            assert g.shape == r.shape, k
            assert np.abs(g - r).max() / max(1.0, np.abs(r).max()) <= TOL, k
    finally:
        f.close()


@pytest.mark.skipif(not netcdf_c.available(), reason="libnetcdf missing")
def test_netcdf4_roundtrip_and_input(files, tmp_path):
    """The port's OutputFile / InputFile on NetCDF4 (as the JAX package's
    test_native_netcdf4_roundtrip), and read_input of a NetCDF4 copy of the
    input file equal to that of the classic file."""
    path = str(tmp_path / "out4.nc")
    with TIO.OutputFile(path, is_hdf5_file=True) as out:
        out.define_dimension("column", 3)
        out.define_dimension("layer", 2)
        out.put_global_attributes(title_str="t", source_str="s")
        out.define_variable("flux", ("column", "layer"), units="W m-2",
                            fill_value=-9999.0)
        out.define_variable("flux_f4", ("column", "layer"), dtype="f",
                            fill_value=-9999.0)
        out.define_variable("surface_type", ("column",), dtype="h")
        out.put("flux", np.arange(6.0).reshape(3, 2))
        out.put("flux_f4", np.arange(6.0, dtype=np.float32).reshape(3, 2))
        out.put("surface_type", np.array([0, 1, 2], np.int16))
    assert open(path, "rb").read(4) == b"\x89HDF"
    with TIO.InputFile(path) as f:
        assert f.exists("flux") and not f.exists("no_such_variable")
        np.testing.assert_array_equal(f.get("flux"), np.arange(6.0).reshape(3, 2))
        assert f.get("flux_f4", np.float32).dtype == np.float32
        np.testing.assert_array_equal(f.get("surface_type", np.int64), [0, 1, 2])

    dims, _, variables = read_nc(files["input"])
    copy = str(tmp_path / "in4.nc")
    with TIO.OutputFile(copy, is_hdf5_file=True) as out:
        for name, size in dims.items():
            out.define_dimension(name, size)
        for name, (vdims, _, v) in variables.items():
            out.define_variable(name, vdims, dtype=v.dtype.char)
        for name, (_, _, v) in variables.items():
            out.put(name, v.astype(v.dtype.newbyteorder("=")))
    nam = files["ns1"]
    cfg = TC.Config.from_namelist(nam).consolidate()
    ref, got = (TRI.read_input(p, cfg, TC.DriverConfig.from_namelist(nam))
                for p in (files["input"], copy))
    assert set(got["arrays"]) == set(ref["arrays"])
    for k, v in ref["arrays"].items():
        np.testing.assert_array_equal(got["arrays"][k], v, err_msg=k)


def test_column_range_and_nrepeat(files, tmp_path):
    """istartcol / iendcol select columns 4-15 of the full run; nrepeat
    repeats the solve with the same result."""
    full = tmp_path / "full.nc"
    assert run_port(files["ns1"], files["input"], full, "--device", "cpu")[0] == 0
    nam = namelist(tmp_path / "r.nam", "ns1",
                   driver_extra="\n  istartcol = 4, iendcol = 15, nrepeat = 2,")
    part = tmp_path / "part.nc"
    rc, _, err = run_port(nam, files["input"], part, "--device", "cpu",
                          "--timings")
    assert rc == 0, err
    ref, got = read_nc(full), read_nc(part)
    assert got[0]["column"] == 12
    for k, (dims, _, val) in got[2].items():
        r = ref[2][k][2][3:15]
        if "layer" in dims:  # the file's layer count follows its columns
            r = r[:, :val.shape[1]]
        np.testing.assert_array_equal(val, r, err_msg=k)


def test_single_precision(files, tmp_path):
    """--precision single solves in float32 and stores the fluxes as f4,
    within the f32 bars of the double run (3e-4 SW, 2.5e-3 LW)."""
    outs = {}
    for prec in ("double", "single"):
        outs[prec] = tmp_path / f"{prec}.nc"
        rc, _, err = run_port(files["ns1"], files["input"], outs[prec],
                              "--device", "cpu", "--precision", prec)
        assert rc == 0, err
    ref, got = read_nc(outs["double"]), read_nc(outs["single"])
    assert got[2]["top_flux_net_sw"][2].dtype.kind == "f"
    assert got[2]["top_flux_net_sw"][2].dtype.itemsize == 4
    for band, tol in (("sw", 3e-4), ("lw", 2.5e-3)):
        keys = [k for k in ref[2] if k.endswith(band)]
        sub = lambda f: (f[0], f[1], {k: (f[2][k][0], None,
                                          f[2][k][2].astype(np.float64))
                                      for k in keys})
        assert nc_field_err(sub(ref), sub(got)) <= tol


def test_profile_writes_trace(files, tmp_path):
    rc, stdout, err = run_port(files["ns4"], files["input"], tmp_path / "o.nc",
                               "--device", "cpu", "--profile", tmp_path / "prof")
    assert rc == 0, err
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert "Profiling summary" in stdout and "radsurf" in stdout
    assert not profiling.enabled  # the region timers are on for that run only


def test_cuda_device_is_refused_without_cuda(files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: --device cuda would run")
    for extra in ((), ("--device", "cuda")):  # cuda is the default
        rc, _, err = run_port(files["ns4"], files["input"], tmp_path / "o.nc",
                              *extra)
        assert rc != 0 and "torch.cuda.is_available() is false" in err
    assert not (tmp_path / "o.nc").exists()


def test_one_device_mesh_values_are_accepted(files, tmp_path):
    for mesh in ("off", "1"):
        rc, _, err = run_port(files["ns1"], files["input"], tmp_path / "o.nc",
                              "--device", "cpu", "--mesh", mesh, "--stream-chunk", "0")
        assert rc == 0, err


def test_cuda_mesh_wider_than_the_cards_is_refused(files, tmp_path):
    """--mesh 2 --device cuda exits nonzero where fewer than 2 cards are
    visible (without CUDA: the device refusal; with one card: make_mesh's)."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible: the mesh would run")
    rc, _, err = run_port(files["ns1"], files["input"], tmp_path / "o.nc",
                          "--device", "cuda", "--mesh", "2")
    assert rc != 0 and ("is_available() is false" in err
                        or "2-device mesh but only" in err), err
    assert not (tmp_path / "o.nc").exists()


# ----------------------------------------------------------------------
# the kernel demo and the input tool
# ----------------------------------------------------------------------

def test_kernel_demo_matches_jax():
    jtk = importlib.import_module("spartacus_surface_tpu.driver.test_kernels")
    jlm = importlib.import_module("spartacus_surface_tpu.ops.layer_matrices")
    texts = []
    for fn, argv in ((TTK.main, ["all", "--device", "cpu"]), (jtk.main, ["all"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert fn(argv) == 0
        texts.append([line for line in buf.getvalue().splitlines()
                      if not line.startswith("Schur vs brute-force")])
    assert texts[0] == texts[1] and "SELF-CHECK PASSED" in texts[0]
    g0, g1, g2, g3 = TTK._hardcoded_gammas()
    ref = jlm.layer_matrices(g0[None], g1[None], g2[None], g3[None],
                             np.array([TTK.DZ]))
    for k, v in TTK.sw_operators("cpu").items():
        np.testing.assert_allclose(v, np.asarray(ref[k])[0], rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    ref = jlm.lw_layer_matrices(g1[None], g2[None], TTK.LW_EMISSION_RATE[None],
                                np.array([TTK.DZ]))
    for k, v in TTK.lw_operators("cpu").items():
        np.testing.assert_allclose(v, np.asarray(ref[k])[0], rtol=1e-12,
                                   atol=1e-12, err_msg=k)


def test_duplicate_profiles_matches_jax(files, tmp_path):
    jdp = importlib.import_module("spartacus_surface_tpu.driver.duplicate_profiles")
    tdp = importlib.import_module("spartacus_surface_tpu_torch.driver.duplicate_profiles")
    assert tdp.main([files["input"], str(tmp_path / "t.nc")]) == 0
    jdp.duplicate_profiles(files["input"], str(tmp_path / "j.nc"))
    ref, got = read_nc(tmp_path / "j.nc"), read_nc(tmp_path / "t.nc")
    assert ref[0] == got[0] and got[0]["column"] == 46 * TILES.size
    for k, (dims, _, val) in ref[2].items():
        assert got[2][k][0] == dims
        np.testing.assert_array_equal(got[2][k][2], val, err_msg=k)
