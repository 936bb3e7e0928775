"""The port's streamed solve (parallel/streaming.py) against one shot and
against the JAX package, on the CPU.

* stream_columns(run_radsurf) on 13 columns in chunks of 4 (mixed tile
  types per chunk, a short tail, more chunks than the in-flight depth)
  against one shot at 1e-12 (as tests/test_streaming.py), and against the
  JAX package's run_radsurf at 1e-9;
* the leading-column-axis ValueError;
* flux_utils.budget_with_masks against the JAX package's at 1e-12;
* the CLI with --stream-chunk 2 against its one-shot file at 1e-12, and with
  --stream-chunk 6 (3 chunks of the 18-column input) against the JAX CLI's
  --stream-chunk 6 file at 1e-9 (field-normalized), with the same budget
  tables.

Inputs are seeded (utils/inputs.example_arrays, write_example_input).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spartacus_surface_tpu.models import flux_utils as JFU
from spartacus_surface_tpu.models.dispatch import run_radsurf as j_run_radsurf
from spartacus_surface_tpu.utils.config import Config as JConfig
from spartacus_surface_tpu_torch.models import flux_utils as TFU
from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
from spartacus_surface_tpu_torch.parallel.streaming import stream_columns
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.inputs import example_arrays, write_example_input
from test_torch_cli import REPO, TILES, namelist, nc_field_err, read_nc, run_port

GROUPS = ("sw_norm_dir", "sw_norm_diff", "lw_internal", "lw_norm", "bc_out")


def config(cls):
    return cls(nsw=1, nlw=1, do_save_flux_profile=True).consolidate()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The 18-column input and a 4-stream namelist; the JAX CLI's
    --stream-chunk 6 run starts here, in the background."""
    d = tmp_path_factory.mktemp("stream")
    write_example_input(d / "in.nc", TILES, L=3, S=1, seed=7)
    nam = namelist(d / "ns4.nam", "ns4")
    env = dict(os.environ, JAX_PLATFORMS="cpu", SPARTACUS_COMPILE_CACHE="0",
               PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "spartacus_surface_tpu.driver.main", nam,
         str(d / "in.nc"), str(d / "jax.nc"), "--platform=cpu", "--mesh=off",
         "--stream-chunk=6"],
        cwd=d, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield {"dir": d, "input": str(d / "in.nc"), "ns4": nam, "jax": proc}
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_stream_columns_matches_one_shot_and_jax(files):
    cfg = config(Config)
    arrays = example_arrays(C=13, L=3, S=1, dtype=np.float64)
    ref = run_radsurf(cfg, arrays, "cpu")
    got = stream_columns(lambda a: run_radsurf(cfg, a, "cpu"), arrays, chunk=4,
                         device="cpu")
    jref = j_run_radsurf(config(JConfig), arrays)
    for g in GROUPS:
        assert set(got[g]) == set(ref[g])
        for k, v in ref[g].items():
            assert isinstance(got[g][k], np.ndarray) and got[g][k].dtype == np.float64
            np.testing.assert_allclose(got[g][k], v.numpy(), rtol=1e-12, atol=1e-12,
                                       err_msg=f"{g}/{k}")
            np.testing.assert_allclose(got[g][k], np.asarray(jref[g][k]), rtol=1e-9,
                                       atol=1e-9, err_msg=f"{g}/{k} vs JAX")


def test_stream_columns_one_chunk_and_depth_one():
    """chunk <= 0 or >= ncol runs one shot; depth 1 finishes each chunk
    before the next: both give the chunked result."""
    cfg = config(Config)
    arrays = example_arrays(C=7, L=2, S=1, dtype=np.float64)
    solve = lambda a: run_radsurf(cfg, a, "cpu")
    ref = run_radsurf(cfg, arrays, "cpu")
    for chunk, depth in ((0, 2), (7, 2), (3, 1)):
        got = stream_columns(solve, arrays, chunk=chunk, depth=depth, device="cpu")
        for g in GROUPS:
            for k, v in ref[g].items():
                np.testing.assert_allclose(got[g][k], v.numpy(), rtol=1e-12,
                                           atol=1e-12, err_msg=f"{chunk} {g}/{k}")


@pytest.mark.parametrize("bad", ["scalar", "short"])
def test_stream_columns_needs_a_leading_column_axis(bad):
    arrays = example_arrays(C=5, L=2, S=1, dtype=np.float64)
    arrays["extra"] = np.float64(1.0) if bad == "scalar" else np.zeros(4)
    with pytest.raises(ValueError, match="leading column axis of length 5"):
        stream_columns(lambda a: a, arrays, chunk=2, device="cpu")


def test_stream_columns_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stream_columns(lambda a: a, example_arrays(C=3, L=2), chunk=2)


def test_budget_with_masks_matches_jax():
    cfg = config(Config)
    arrays = example_arrays(C=12, L=3, S=1, dtype=np.float64)
    out = run_radsurf(cfg, arrays, "cpu")
    masks = TFU.representation_masks(arrays["i_representation"], "cpu")
    jmasks = JFU.representation_masks(arrays["i_representation"])
    for g in GROUPS[:4]:
        got = TFU.budget_with_masks(out[g], masks)
        ref = JFU.budget_with_masks({k: v.numpy() for k, v in out[g].items()}, jmasks)
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-12,
                                       atol=1e-12, err_msg=f"{g}/{k}")


def test_cli_stream_chunk_matches_one_shot(files):
    outs = {}
    for name, extra in (("one", ()), ("streamed", ("--stream-chunk", "2"))):
        outs[name] = files["dir"] / f"{name}.nc"
        rc, stdout, err = run_port(files["ns4"], files["input"], outs[name],
                                   "--device", "cpu", *extra)
        assert rc == 0, err
    assert "Streaming the solve in 2-column chunks" in stdout
    ref, got = read_nc(outs["one"]), read_nc(outs["streamed"])
    assert ref[0] == got[0] and set(ref[2]) == set(got[2])
    for k, (_, _, v) in ref[2].items():
        np.testing.assert_allclose(got[2][k][2], v, rtol=1e-12, atol=1e-12, err_msg=k)


def budget_tables(stdout):
    """The budget tables' lines, each row's residual column as a float."""
    lines = [ln for ln in stdout.splitlines()
             if "budget:" in ln or ln.startswith("Column")
             or (ln[:5].strip().isdigit() and len(ln.split()) == 9)]
    return [(ln.split()[:-1], float(ln.split()[-1])) if ln[:5].strip().isdigit()
            else (ln, None) for ln in lines]


def test_cli_stream_chunk_matches_jax_cli(files):
    out = files["dir"] / "port_stream6.nc"
    rc, stdout, err = run_port(files["ns4"], files["input"], out, "--device", "cpu",
                               "--stream-chunk", "6")
    assert rc == 0, err
    jstdout, jstderr = files["jax"].communicate(timeout=300)
    assert files["jax"].returncode == 0, jstderr[-2000:]
    assert nc_field_err(read_nc(files["dir"] / "jax.nc"), read_nc(out)) <= 1e-9
    port, ref = budget_tables(stdout), budget_tables(jstdout)
    assert len(port) == len(ref) == 4 * (2 + TILES.size)
    for (p_line, p_res), (j_line, j_res) in zip(port, ref):
        assert p_line == j_line
        if j_res is not None:
            assert abs(p_res - j_res) <= 1e-9
