"""The port's CLI as several processes (gloo on 127.0.0.1), on the CPU.

Each process solves its own contiguous column slice, writes OUTPUT.pNN, and
process 0 merges the shards into the single OUTPUT after a barrier
(driver/merge.py), as tests/test_multiprocess.py holds the JAX CLI:

* 2 processes against the single-process file, variable for variable
  (rtol / atol 1e-12), with each process's slice line and the merge line;
* 4 processes on 5 columns (the 2/1/1/1 split) with --stream-chunk 1;
* --keep-shards, then the standalone merge of the kept shards;
* the port's merge_shards against the JAX package's on the same shards:
  dimensions, attributes and every variable bit-equal;
* more processes than columns: every process exits nonzero, none hangs.

Every process and barrier has a time limit (300 s, barriers 60 s).
"""

import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

from spartacus_surface_tpu.driver.merge import merge_shards as j_merge_shards
from spartacus_surface_tpu_torch.driver.merge import merge_shards
from spartacus_surface_tpu_torch.utils.inputs import write_example_input
from test_torch_cli import REPO, TILES, namelist, read_nc, run_port

BASE = [sys.executable, "-m", "spartacus_surface_tpu_torch.driver.main",
        "--device", "cpu", "--barrier-timeout", "60"]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_procs(nproc, nam, infile, out, extra=()):
    """[(exit code, stdout, stderr)] of the CLI as nproc processes."""
    port = free_port()
    procs = [subprocess.Popen(
        BASE + list(extra) + [f"--coordinator=127.0.0.1:{port}",
                              f"--num-processes={nproc}", f"--process-id={pid}",
                              str(nam), str(infile), str(out)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(nproc)]
    logs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=300)
            logs.append((p.returncode, so, se))
    finally:  # none outlives the test, on a time-out either
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return logs


def assert_outputs_equal(ref_path, got_path):
    ref, got = read_nc(ref_path), read_nc(got_path)
    assert ref[0] == got[0] and set(ref[2]) == set(got[2])
    for name, (dims, _, val) in ref[2].items():
        g = got[2][name][2]
        assert got[2][name][0] == dims and g.shape == val.shape, name
        if val.dtype.kind == "f":
            np.testing.assert_allclose(g, val, rtol=1e-12, atol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(g, val, err_msg=name)
    assert len(ref[2]) >= 10


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The 18-column input, a 4-stream namelist, the single-process file."""
    d = tmp_path_factory.mktemp("mp")
    write_example_input(d / "in.nc", TILES, L=3, S=1, seed=7)
    nam = namelist(d / "ns4.nam", "ns4")
    rc, _, err = run_port(nam, d / "in.nc", d / "single.nc", "--device", "cpu")
    assert rc == 0, err
    return {"dir": d, "nam": nam, "input": d / "in.nc", "single": d / "single.nc"}


@pytest.fixture(scope="module")
def kept(case):
    """A 2-process run with --keep-shards: (its merged file, its shards)."""
    out = case["dir"] / "kept.nc"
    for rc, so, se in run_procs(2, case["nam"], case["input"], out, ["--keep-shards"]):
        assert rc == 0, (so[-2000:], se[-3000:])
    return out, [case["dir"] / f"kept.nc.p{pid:02d}" for pid in range(2)]


def test_two_process_run_matches_single(case):
    out = case["dir"] / "multi.nc"
    logs = run_procs(2, case["nam"], case["input"], out)
    for rc, so, se in logs:
        assert rc == 0, (so[-2000:], se[-3000:])
    assert "Process 0/2: columns 1 to 9" in logs[0][1]
    assert "Process 1/2: columns 10 to 18" in logs[1][1]
    assert "Merged 2 output shards" in logs[0][1]
    assert "Merged" not in logs[1][1]
    assert out.exists()
    assert not any(os.path.exists(f"{out}.p{pid:02d}") for pid in range(2))
    assert_outputs_equal(case["single"], out)


def test_four_process_uneven_with_stream_chunk(case):
    """4 processes x 5 columns (2/1/1/1) with the streamed solve in every
    process."""
    infile = case["dir"] / "in5.nc"
    write_example_input(infile, np.array([3, 0, 1, 4, 2]), L=3, S=1, seed=11)
    single = case["dir"] / "single5.nc"
    rc, _, err = run_port(case["nam"], infile, single, "--device", "cpu")
    assert rc == 0, err
    out = case["dir"] / "multi4.nc"
    logs = run_procs(4, case["nam"], infile, out, ["--stream-chunk", "1"])
    for rc, so, se in logs:
        assert rc == 0, (so[-2000:], se[-3000:])
    for pid, (a, b) in enumerate([(1, 2), (3, 3), (4, 4), (5, 5)]):
        assert f"Process {pid}/4: columns {a} to {b}" in logs[pid][1]
        assert "Streaming the solve in 1-column chunks" in logs[pid][1]
    assert not any(os.path.exists(f"{out}.p{pid:02d}") for pid in range(4))
    assert_outputs_equal(single, out)


def test_keep_shards_and_standalone_merge(case, kept):
    out, shards = kept
    assert out.exists() and all(p.exists() for p in shards)
    assert_outputs_equal(case["single"], out)
    remerged = case["dir"] / "remerged.nc"
    for pid, p in enumerate(shards):
        os.link(p, f"{remerged}.p{pid:02d}")
    res = subprocess.run([sys.executable, "-m", "spartacus_surface_tpu_torch.driver.merge",
                          str(remerged)], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert not any(os.path.exists(f"{remerged}.p{pid:02d}") for pid in range(2))
    assert_outputs_equal(case["single"], remerged)


def test_merge_matches_jax_merge(case, kept):
    _, shards = kept
    paths = {}
    for name in ("port", "jax"):
        paths[name] = case["dir"] / f"merged_{name}.nc"
        for pid, p in enumerate(shards):
            shutil.copy(p, f"{paths[name]}.p{pid:02d}")
    merge_shards(str(paths["port"]), n_processes=2)
    j_merge_shards(str(paths["jax"]), n_processes=2)
    ref, got = read_nc(paths["jax"]), read_nc(paths["port"])
    assert got[0] == ref[0] and got[1] == ref[1]
    assert list(got[2]) == list(ref[2])
    for name, (dims, attrs, val) in ref[2].items():
        assert got[2][name][0] == dims and got[2][name][1] == attrs, name
        assert got[2][name][2].dtype == val.dtype, name
        np.testing.assert_array_equal(got[2][name][2], val, err_msg=name)


def test_more_processes_than_columns_fail_everywhere(case):
    infile = case["dir"] / "in2.nc"
    write_example_input(infile, np.array([3, 1]), L=3, S=1, seed=5)
    logs = run_procs(3, case["nam"], infile, case["dir"] / "too_many.nc")
    for rc, _, se in logs:
        assert rc != 0 and "3 processes for only 2 input columns" in se, se[-2000:]
    assert not (case["dir"] / "too_many.nc").exists()
