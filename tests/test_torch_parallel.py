"""The port's device meshes and process groups (parallel/mesh.py,
parallel/distributed.py, run_radsurf(mesh=)) on the CPU.

A mesh of 8 ``cpu`` entries stands for the JAX tests' 8 virtual CPU devices
(tests/conftest.py).  Held:

* make_mesh's errors and lists; shard_inputs_by_column's contiguous,
  balanced shards;
* spartacus_sw per shard, concatenated, against one shot at 1e-12 (as
  tests/test_sharding.py);
* run_radsurf(mesh=8 x cpu) on 13 mixed columns against no mesh at 1e-12,
  and against the JAX package's run_radsurf(mesh=make_mesh(8)) at 1e-9;
* the CLI with --mesh 2 --device cpu against --mesh off at 1e-12;
* host_column_slice's balanced split and pad_columns (bit-equal to JAX's);
* a 2-process gloo group: global_column_array, a solve and the global_sum
  of the energy budget below 1e-9 (as tests/test_distributed.py).
"""

import json
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from spartacus_surface_tpu.models.dispatch import run_radsurf as j_run_radsurf
from spartacus_surface_tpu.parallel import distributed as JD
from spartacus_surface_tpu.parallel.mesh import make_mesh as j_make_mesh
from spartacus_surface_tpu.utils.config import Config as JConfig
from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
from spartacus_surface_tpu_torch.models.solver import SolverOptions, spartacus_sw
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss
from spartacus_surface_tpu_torch.parallel import distributed as D
from spartacus_surface_tpu_torch.parallel.mesh import (column_sharding, make_mesh,
                                                       shard_inputs_by_column)
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.convert import to_canopy_inputs
from spartacus_surface_tpu_torch.utils.inputs import (example_arrays, example_inputs,
                                                       write_example_input)
from test_solver_conservation import make_inputs
from test_torch_cli import REPO, TILES, namelist, read_nc, run_port

CPU8 = ["cpu"] * 8
GROUPS = ("sw_norm_dir", "sw_norm_diff", "lw_internal", "lw_norm", "bc_out")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_make_mesh_refuses_more_cards_than_visible():
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"requested a {n}-device mesh but only"
                       f" {n - 1} devices are visible; run on a machine with more cards"):
        make_mesh(n)


def test_make_mesh_takes_any_device_list():
    assert make_mesh(devices=CPU8) == [torch.device("cpu")] * 8
    assert make_mesh(devices=["cpu", torch.device("cpu")]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="at least one device"):
        make_mesh(devices=[])
    if not torch.cuda.is_available():  # no card: the default mesh is empty
        with pytest.raises(ValueError, match="at least one device"):
            make_mesh()


@pytest.mark.parametrize("ncol, sizes", [(13, [2, 2, 2, 2, 2, 1, 1, 1]),
                                         (16, [2] * 8), (3, [1, 1, 1, 0, 0, 0, 0, 0])])
def test_shard_inputs_by_column(ncol, sizes):
    mesh = make_mesh(devices=CPU8)
    assert [sl.stop - sl.start for _, sl in column_sharding(ncol, mesh)] == sizes
    arrays = example_arrays(C=ncol, L=2, S=1, dtype=np.float64)
    inp = to_canopy_inputs(make_inputs(np.random.default_rng(1), C=ncol, L=2, S=1), "cpu")
    for tree in (arrays, inp):
        shards = shard_inputs_by_column(tree, mesh)
        assert len(shards) == 8
        for name in ("dz", "veg_ext"):
            get = (lambda t: t[name]) if isinstance(tree, dict) else (lambda t: getattr(t, name))
            parts = [get(s) for s in shards]
            assert [len(p) for p in parts] == sizes
            assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu" for p in parts)
            np.testing.assert_array_equal(torch.cat(parts).numpy(), np.asarray(get(tree)))


def test_sharded_solve_equals_one_shot():
    inp = to_canopy_inputs(make_inputs(np.random.default_rng(77), C=16, L=3, S=2,
                                       urban=True), "cpu")
    opt, lg = SolverOptions(nreg=2, nstream=4, do_urban=True), LegendreGauss(4)
    ref = spartacus_sw(inp, opt, lg)
    shards = [spartacus_sw(s, opt, lg)
              for s in shard_inputs_by_column(inp, make_mesh(devices=CPU8))]
    for i, part in enumerate(ref):
        for key, val in part.items():
            got = torch.cat([s[i][key] for s in shards])
            np.testing.assert_allclose(got.numpy(), val.numpy(), rtol=1e-12, atol=1e-12,
                                       err_msg=key)


def test_run_radsurf_mesh_matches_no_mesh_and_jax():
    cfg = Config(nsw=1, nlw=1, do_save_flux_profile=True).consolidate()
    arrays = example_arrays(C=13, L=3, S=1, dtype=np.float64)
    ref = run_radsurf(cfg, arrays, "cpu")
    got = run_radsurf(cfg, arrays, "cpu", mesh=make_mesh(devices=CPU8))
    jcfg = JConfig(nsw=1, nlw=1, do_save_flux_profile=True).consolidate()
    jref = j_run_radsurf(jcfg, arrays, mesh=j_make_mesh(8))
    for g in GROUPS:
        assert set(got[g]) == set(ref[g])
        for k, v in ref[g].items():
            np.testing.assert_allclose(got[g][k].numpy(), v.numpy(), rtol=1e-12,
                                       atol=1e-12, err_msg=f"{g}/{k}")
            np.testing.assert_allclose(got[g][k].numpy(), np.asarray(jref[g][k]),
                                       rtol=1e-9, atol=1e-9, err_msg=f"{g}/{k} vs JAX")


def test_cli_mesh_matches_single_device(tmp_path):
    write_example_input(tmp_path / "in.nc", TILES, L=3, S=1, seed=7)
    nam = namelist(tmp_path / "ns4.nam", "ns4")
    outs = {}
    for mesh in ("off", "2"):
        outs[mesh] = tmp_path / f"mesh_{mesh}.nc"
        rc, stdout, err = run_port(nam, tmp_path / "in.nc", outs[mesh], "--device", "cpu",
                                   "--mesh", mesh)
        assert rc == 0, err
    assert "sharding columns over 2 devices" in stdout
    ref, got = read_nc(outs["off"]), read_nc(outs["2"])
    assert ref[0] == got[0] and set(ref[2]) == set(got[2])
    for k, (_, _, v) in ref[2].items():
        np.testing.assert_allclose(got[2][k][2], v, rtol=1e-12, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("nproc, starts", [(1, [0, 5]), (2, [0, 3, 5]),
                                           (3, [0, 2, 4, 5]), (4, [0, 2, 3, 4, 5])])
def test_host_column_slice(monkeypatch, nproc, starts):
    """The balanced split of 5 columns: the first 5 % n processes take one
    more (4 processes: 2/1/1/1)."""
    monkeypatch.setattr(D, "process_count", lambda: nproc)
    for pid in range(nproc):
        monkeypatch.setattr(D, "process_index", lambda pid=pid: pid)
        assert D.host_column_slice(5) == slice(starts[pid], starts[pid + 1])


def test_single_process_defaults():
    assert (D.process_count(), D.process_index()) == (1, 0)
    assert D.host_column_slice(100) == slice(0, 100)
    assert D.local_device("cpu") == torch.device("cpu")
    assert D.make_global_mesh("cpu") == [torch.device("cpu")]
    D.initialize(None, 1, None)  # a no-op for one process
    D.barrier("nothing to wait for", timeout_s=60)
    D.shutdown()
    assert D.global_sum(torch.arange(4.0)) == 6.0


def test_pad_columns_matches_jax():
    arrays = {"a": np.arange(10.0).reshape(5, 2), "nlay": np.arange(5),
              "scalar": np.float64(3.0)}
    for multiple in (8, 5, 3):
        got, n = D.pad_columns(arrays, multiple)
        ref, jn = JD.pad_columns(arrays, multiple)
        assert n == jn == 5 and set(got) == set(ref)
        for k, v in ref.items():
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_global_column_array_checks_the_column_count():
    local = example_inputs(C=4, L=2, S=1, dtype=np.float64)
    shards = D.global_column_array(local, make_mesh(devices=["cpu", "cpu"]), 4)
    assert [len(s["dz"]) for s in shards] == [2, 2]
    with pytest.raises(ValueError, match="4 columns in all, not 5"):
        D.global_column_array(local, make_mesh(devices=["cpu"]), 5)


_GLOO_RANK = """
import json, sys
import numpy as np, torch
from spartacus_surface_tpu_torch.models.solver import CanopyInputs, SolverOptions, spartacus_sw
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss
from spartacus_surface_tpu_torch.parallel import distributed as D
from spartacus_surface_tpu_torch.utils.inputs import example_inputs
port, rank, C = sys.argv[1], int(sys.argv[2]), 8
D.initialize(f"127.0.0.1:{port}", 2, rank, timeout_s=60)
full = example_inputs(C=C, L=2, S=1, dtype=np.float64)
sl = D.host_column_slice(C)
(shard,) = D.global_column_array({k: v[sl] for k, v in full.items()},
                                 D.make_global_mesh("cpu"), C)
opt, lg = SolverOptions(nreg=2, nstream=2, do_urban=True, n_double=6), LegendreGauss(2)
nd, _, _ = spartacus_sw(CanopyInputs(**shard), opt, lg)
total = sum(D.global_sum(nd[k]) for k in ("ground_net", "clear_air_abs", "veg_abs",
                                          "veg_air_abs", "wall_net", "roof_net"))
total -= D.global_sum(nd["top_net"])
ref, _, _ = spartacus_sw(CanopyInputs(**{k: torch.as_tensor(v) for k, v in full.items()}),
                         opt, lg)
rel = ((nd["ground_dn"] - ref["ground_dn"][sl]).abs() / ref["ground_dn"][sl].abs()).max()
D.barrier("solved", timeout_s=60)
print(json.dumps({"rank": D.process_index(), "nproc": D.process_count(),
                  "slice": [sl.start, sl.stop], "residual": total, "rel": rel.item()}))
D.shutdown()
"""


def test_two_process_gloo_solve_and_global_sum():
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_RANK, str(port), str(r)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
    res = [json.loads(so.strip().splitlines()[-1]) for so, _ in outs]
    assert [r["slice"] for r in res] == [[0, 4], [4, 8]]
    for r in res:
        assert r["nproc"] == 2 and abs(r["residual"]) < 1e-9 and r["rel"] < 1e-12
    assert res[0]["residual"] == res[1]["residual"]  # one all-reduced value
