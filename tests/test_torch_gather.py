"""run_radsurf's rows gathered on the device, inside its core
(models/dispatch.py _core), from whole fields that the host plan moves once.

On the CPU, float64, on a permuted layout of all six tile types (the rows
of every group scattered over the columns):

* the result against the JAX package at 1e-9, and bit-equal to a plain
  host-gather result built here (each group's rows taken with numpy fancy
  indexing on the host, solved alone, scattered back at its columns), on the
  kernel route, under graphs.disabled() and on the scan route, whose plan
  moves the whole fields to the device itself;
* the host payload: every field read once, whole, the caller's own memory
  where its dtype is dz's, and one int64 index a column;
* a tensor input that needs a gradient: the gradient flows through the
  gather, bit-equal to the host-gather result's, and only to the rows of
  the layered tiles.

Marked cuda (skipped without a GPU): a call captured on one input set and
replayed on a second of the same layout equals an eager call bit for bit.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from spartacus_surface_tpu_torch.models import dispatch
from spartacus_surface_tpu_torch.models import flat as FLAT
from spartacus_surface_tpu_torch.models import simple_urban as SU
from spartacus_surface_tpu_torch.models import solver as TS
from spartacus_surface_tpu_torch.parallel.mesh import tree_leaves
from spartacus_surface_tpu_torch.utils import graphs
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.inputs import example_arrays

GROUPS = ("sw_norm_dir", "sw_norm_diff", "lw_internal", "lw_norm", "bc_out")
KW = dict(do_lw=True, nsw=2, nlw=2, do_save_flux_profile=True, use_sw_direct_albedo=True)


def permuted(C=30, L=3, S=2, dtype=np.float64, seed=4):
    """example_arrays on C columns of the six tile types in equal shares,
    in one permuted order whatever the seed, a fifth of the columns at
    night."""
    rep = np.random.default_rng(0).permutation(np.repeat(np.arange(6), C // 6))
    a = example_arrays(C=C, L=L, S=S, dtype=dtype, seed=seed, i_representation=rep)
    a["cos_sza"][np.random.default_rng(seed).choice(C, C // 5, replace=False)] = -0.3
    return a


def flat_outputs(out) -> dict:
    return {(g, k): v for g in GROUPS if g in out for k, v in out[g].items()}


def host_gathered(cfg, arrays, route="kernel", take=None):
    """run_radsurf's outputs with each group's rows gathered on the host:
    the fields of a group's columns sliced with numpy fancy indexing
    (`take`: another slicer), each group solved as _core solves it, its
    outputs scattered back into dense tensors at its columns."""
    take = take or (lambda v, idx: torch.as_tensor(v[idx]))
    rows = lambda key, idx: take(arrays[key], idx)
    rep = arrays["i_representation"]
    C, L = arrays["dz"].shape
    gdir = "ground_albedo_dir" if cfg.use_sw_direct_albedo else "ground_albedo"
    f64 = dict(dtype=torch.float64)
    out = {"sw_norm_dir": dispatch._empty_flux(C, L, cfg.nswinternal, **f64),
           "sw_norm_diff": dispatch._empty_flux(C, L, cfg.nswinternal, **f64),
           "lw_internal": dispatch._empty_flux(C, L, cfg.nlwinternal, **f64),
           "lw_norm": dispatch._empty_flux(C, L, cfg.nlwinternal, **f64)}
    bc = out["bc_out"] = {k: torch.zeros((C, S), **f64) for k, S in (
        ("sw_albedo", cfg.nswinternal), ("sw_albedo_dir", cfg.nswinternal),
        ("lw_emissivity", cfg.nlwinternal), ("lw_emission", cfg.nlwinternal))}

    def scatter(idx, sw, lw, sun_up=None, layer0=False, top=""):
        t = torch.as_tensor(idx)
        for name, res, mask in (("sw", sw, sun_up), ("lw", lw, None)):
            g0, g1 = ("sw_norm_dir", "sw_norm_diff") if name == "sw" else ("lw_internal", "lw_norm")
            dispatch._scatter(out[g0], res[0], t, mask, layer0)
            dispatch._scatter(out[g1], res[1], t, mask, layer0)
            pairs = ((("sw_albedo", "albedo_diff"), ("sw_albedo_dir", "albedo_dir"))
                     if name == "sw" else (("lw_emissivity", "emissivity"),
                                           ("lw_emission", "emission")))
            for key, top_key in pairs:
                bc[key][t] = res[2][f"top_{top_key}" if top else key]

    idx = np.nonzero(rep == 0)[0]
    scatter(idx, FLAT.flat_sw(rows("ground_albedo", idx), rows(gdir, idx)),
            FLAT.flat_lw(rows("ground_emissivity", idx), rows("ground_emission", idx)))
    for code, (opt_kw, lg_sw, lg_lw) in dispatch._solver_groups(cfg).items():
        idx = np.nonzero(rep == code)[0]
        inputs = lambda keys: TS.CanopyInputs(**{f: rows(k, idx) for f, k in keys.items()})
        sw_in = inputs({**dispatch._SW_KEYS, "ground_albedo_dir": gdir})
        sw = TS.spartacus_sw(sw_in, TS.SolverOptions(nstream=lg_sw.nstream, **opt_kw),
                             dispatch._lg(lg_sw.nstream), with_profiles=True, route=route)
        lw = TS.spartacus_lw(inputs(dispatch._LW_KEYS),
                             TS.SolverOptions(nstream=lg_lw.nstream, **opt_kw),
                             dispatch._lg(lg_lw.nstream), with_profiles=True, route=route)
        scatter(idx, sw, lw, sun_up=sw_in.cos_sza > 0.0, top="top")
    idx = np.nonzero(rep >= 4)[0]
    lay0 = lambda key: rows(key, idx)[:, 0]
    geom = (lay0("dz"), lay0("building_fraction"), lay0("building_scale"))
    is_inf = torch.as_tensor(rep[idx] == 5)
    opts = dict(min_building_fraction=cfg.min_building_fraction, with_profiles=True)
    sw = SU.simple_urban_sw(*geom, rows("cos_sza", idx), is_inf, rows("ground_albedo", idx),
                            rows(gdir, idx), lay0("roof_albedo"), lay0("wall_albedo"), **opts)
    lw = SU.simple_urban_lw(*geom, is_inf, rows("ground_emissivity", idx),
                            rows("ground_emission", idx), lay0("roof_emissivity"),
                            lay0("roof_emission"), lay0("wall_emissivity"),
                            lay0("wall_emission"), **opts)
    scatter(idx, sw, lw, sun_up=rows("cos_sza", idx) > 0.0, layer0=True)
    return flat_outputs(out)


@functools.lru_cache(maxsize=None)
def jax_out():
    jdispatch = pytest.importorskip("spartacus_surface_tpu.models.dispatch")
    jconfig = pytest.importorskip("spartacus_surface_tpu.utils.config")
    return jdispatch.run_radsurf(jconfig.Config(**KW).consolidate(), permuted())


def test_permuted_layout_matches_jax():
    got = dispatch.run_radsurf(Config(**KW).consolidate(), permuted(), "cpu")
    ref = jax_out()
    worst = 0.0
    for g in GROUPS:
        assert set(ref[g]) == set(got[g]), set(ref[g]) ^ set(got[g])
        for k in ref[g]:
            r, x = np.asarray(ref[g][k]), got[g][k].numpy()
            assert r.shape == x.shape and np.isfinite(x).all(), (g, k)
            worst = max(worst, np.abs(r - x).max() / max(1.0, np.abs(r).max()))
    assert worst < 1e-9


@pytest.mark.parametrize("path", ["kernel", "graphs_disabled", "scan"])
@pytest.mark.parametrize("direct_albedo", [True, False], ids=["direct_albedo", "one_albedo"])
def test_permuted_layout_bit_equal_to_a_host_gather(path, direct_albedo):
    cfg = Config(**{**KW, "use_sw_direct_albedo": direct_albedo}).consolidate()
    arrays, route = permuted(), "scan" if path == "scan" else "kernel"
    before = graphs.stats()["gather_bytes"]
    with graphs.disabled() if path == "graphs_disabled" else contextlib.nullcontext():
        got = flat_outputs(dispatch.run_radsurf(cfg, arrays, "cpu", route=route))
    assert graphs.stats()["gather_bytes"] > before
    ref = host_gathered(cfg, arrays, route)
    assert set(got) == set(ref)
    for key, v in ref.items():
        assert torch.equal(got[key], v), key


def test_host_payload_holds_each_field_once_whole():
    """A SW + LW call's payload for the graph cache: each field read, once
    and whole, over the caller's own array where its dtype is dz's (cast
    where it is not), each group's int64 index and the simple tiles'
    is_inf flags; the group's rows are no part of it."""
    cfg = Config(**KW).consolidate()
    arrays = permuted()
    arrays["veg_fsd"] = arrays["veg_fsd"].astype(np.float32)  # cast to dz's dtype
    _, payload = dispatch._plan(cfg, arrays, torch.device("cpu"), "kernel", None, host=True)
    fields = payload["fields"]
    assert set(fields) == {k for k, v in arrays.items() if v.dtype.kind == "f"}
    for k, t in fields.items():
        assert t.dtype == torch.float64 and t.shape == arrays[k].shape, k
        assert (t.data_ptr() == arrays[k].ctypes.data) == (k != "veg_fsd"), k
        np.testing.assert_array_equal(t.numpy(), arrays[k].astype(np.float64), err_msg=k)
    rep = arrays["i_representation"]
    idx = [payload["flat"]["idx"], *(pl["idx"] for g in payload["layered"] for pl in g),
           payload["simple"]["idx"]]
    assert all(i.dtype == torch.int64 for i in idx)
    assert sorted(torch.cat(idx).tolist()) == list(range(rep.size))
    np.testing.assert_array_equal(payload["simple"]["is_inf"].numpy(),
                                  rep[payload["simple"]["idx"].numpy()] == 5)
    extra = sum(t.numel() * t.element_size() for t in tree_leaves(payload)) - sum(
        t.numel() * t.element_size() for t in fields.values())
    assert extra == 8 * rep.size + payload["simple"]["is_inf"].numel()


def test_gradient_flows_through_the_gather():
    """veg_ext a leaf tensor that needs a gradient: the call runs eagerly,
    gathers the leaf's rows in its core, and the gradient of a loss over
    the SW and LW outputs reaches the leaf, bit-equal to the host-gather
    result's (each section's rows indexed from the same leaf), nonzero on
    the layered tiles' rows and zero on the flat and simple tiles'."""
    cfg = Config(**KW).consolidate()
    arrays = permuted()
    rep = arrays["i_representation"]

    def grad(fn):
        leaf = torch.tensor(arrays["veg_ext"], requires_grad=True)
        out = fn({**arrays, "veg_ext": leaf})
        loss = sum(v.sum() for (g, k), v in out.items()
                   if k in ("veg_abs", "top_net", "ground_net"))
        loss.backward()
        return leaf.grad

    got = grad(lambda a: flat_outputs(dispatch.run_radsurf(cfg, a, "cpu")))
    take = lambda v, idx: v[torch.as_tensor(idx)] if isinstance(v, torch.Tensor) else \
        torch.as_tensor(v[idx])
    ref = grad(lambda a: host_gathered(cfg, a, take=take))
    assert torch.equal(got, ref)
    layered = np.isin(rep, [1, 2, 3])
    assert (got[torch.as_tensor(layered)] != 0).any()
    assert (got[torch.as_tensor(~layered)] == 0).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    graphs.clear()
    yield torch.device("cuda")
    graphs.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_cuda_replay_on_new_inputs_equals_eager(cuda_device, dtype):
    """A permuted layout of the six tile types: the first call eager, the
    second captured on input set 1, the third replayed on set 2 (the same
    layout, so the same graph), equal bit for bit to set 2 run eagerly."""
    cfg = Config(do_lw=True, nsw=1, nlw=1).consolidate()
    first, second = (permuted(C=6 * 2048, L=8, S=1, dtype=dtype, seed=s) for s in (1, 2))
    run = lambda a: flat_outputs(dispatch.run_radsurf(cfg, a, cuda_device))
    start = graphs.stats()
    run(first)
    run(first)
    before = graphs.stats()
    got = run(second)
    after = graphs.stats()
    assert (after["captures"] - start["captures"], after["replays"] - before["replays"]) == (1, 1)
    assert after["gather_bytes"] > before["gather_bytes"]
    with graphs.disabled():
        ref = run(second)
    for key, v in ref.items():
        assert torch.equal(got[key], v), key
