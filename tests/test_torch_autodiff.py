"""Gradients of the port against the JAX package's.

The twins of tests/test_autodiff.py: the same losses of spartacus_sw,
spartacus_lw and run_radsurf, differentiated with respect to veg_ext by
torch autograd through the port (float64, CPU) and by jax.grad through the
JAX package on its XLA route (computed once for the module), held together
at 1e-9 relative (max|port - jax| / max|jax|).  The port's kernel route
(its kernels' plain versions on CPU tensors) takes its gradient through
solver._KernelRouteGrad, whose backward recomputes the scan route; the scan
route is differentiated directly.  Also: torch.autograd.gradcheck on the
kernel route, the graph the kernel route's forward records, the NaN
pattern under padding layers, and the twin of
tests/test_retrieval_example.py.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from spartacus_surface_tpu.models import solver as JS
from spartacus_surface_tpu.models.dispatch import run_radsurf as jax_run
from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss as JLG
from spartacus_surface_tpu.utils.config import Config as JConfig
from spartacus_surface_tpu_torch.models import solver as TS
from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss as TLG
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.convert import to_canopy_inputs
from spartacus_surface_tpu_torch.utils.inputs import example_arrays, example_inputs
from tests.test_solver_conservation import make_inputs

TOL = 1e-9
ROUTES = ("kernel", "scan")


def sw_albedo(ndir, ndiff, bc):
    return bc["top_albedo_dir"].sum()


def sw_albedo_ground(ndir, ndiff, bc):
    return bc["top_albedo_dir"].sum() + ndir["ground_net"].sum()


def lw_loss(internal, norm, bc):
    return internal["top_net"].sum() + norm["ground_net"].sum()


def lw_inputs():
    """__graft_entry__._example_inputs' LW inputs (C=2, L=2, S=1, float64)
    as the port's example_inputs draws them."""
    return example_inputs(C=2, L=2, S=1, dtype=np.float64, lw=True)


# case: (inputs, solver, (nreg, nstream, do_urban, n_double[, column_chunk]), loss)
CASES = {
    "sw_albedo": (lambda: make_inputs(np.random.default_rng(123), C=2, L=2,
                                      S=1, urban=False),
                  "sw", (2, 2, False, 6), sw_albedo),
    "lw": (lw_inputs, "lw", (2, 2, True, 6), lw_loss),
    "nreg3_sw": (lambda: make_inputs(np.random.default_rng(42), C=2, L=2, S=1,
                                     urban=True),
                 "sw", (3, 4, True, 6), sw_albedo_ground),
    "chunked": (lambda: make_inputs(np.random.default_rng(3), C=4, L=2, S=1,
                                    urban=True),
                "sw", (2, 2, True, 6, 2), sw_albedo),
    "kernel_route": (lambda: make_inputs(np.random.default_rng(7), C=2, L=2,
                                         S=1, urban=False),
                     "sw", (2, 2, False, 4), sw_albedo),
    "padding": (lambda: make_inputs(np.random.default_rng(9), C=3, L=2, S=1,
                                    urban=True, pad_layers=2),
                "sw", (2, 2, True, 6), sw_albedo_ground),
}


def fields(src):
    return src if isinstance(src, dict) else {
        k: v for k, v in vars(src).items() if v is not None}


def jax_case(name):
    make, which, (nreg, ns, urban, nd, *_), loss = CASES[name]
    src = make()
    inp = JS.CanopyInputs(**fields(src))
    opt = JS.SolverOptions(nreg=nreg, nstream=ns, do_urban=urban, n_double=nd)
    solve = JS.spartacus_sw if which == "sw" else JS.spartacus_lw
    fn = lambda x: loss(*solve(dataclasses.replace(inp, veg_ext=x), opt, JLG(ns)))
    return np.asarray(jax.grad(fn)(jnp.asarray(inp.veg_ext)))


def jax_radsurf():
    cfg = JConfig(nsw=1, nlw=1).consolidate()
    arrays = graft._example_arrays(C=4, L=2, S=1, dtype=np.float64)

    def loss(veg_ext):
        out = jax_run(cfg, {**arrays, "veg_ext": veg_ext})
        return (jnp.sum(out["sw_norm_dir"]["ground_net"])
                + jnp.sum(out["lw_internal"]["top_net"]))

    return np.asarray(jax.grad(loss)(jnp.asarray(arrays["veg_ext"])))


@pytest.fixture(scope="module")
def jax_grads():
    out = {name: jax_case(name) for name in CASES}
    out["run_radsurf"] = jax_radsurf()
    return out


def port_case(name, route, chunk=None):
    make, which, (nreg, ns, urban, nd, *ck), loss = CASES[name]
    inp = to_canopy_inputs(SimpleNamespace(**fields(make())), "cpu")
    inp.veg_ext.requires_grad_(True)
    opt = TS.SolverOptions(nreg=nreg, nstream=ns, do_urban=urban, n_double=nd,
                           column_chunk=(ck or [0])[0] if chunk is None else chunk)
    solve = TS.spartacus_sw if which == "sw" else TS.spartacus_lw
    loss(*solve(inp, opt, TLG(ns), route=route)).backward()
    return inp.veg_ext.grad.numpy()


def rel_err(ref, got):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", ["sw_albedo", "lw", "nreg3_sw", "chunked",
                                  "kernel_route"])
def test_grad_matches_jax(jax_grads, name, route):
    got = port_case(name, route)
    assert np.isfinite(got).all()
    err = rel_err(jax_grads[name], got)
    assert err < TOL, err


@pytest.mark.parametrize("route", ROUTES)
def test_grad_chunked_matches_unchunked(route):
    """column_chunk splits the batch: each chunk's Function recomputes its
    own scan graph, and the gradient equals the whole batch's."""
    np.testing.assert_allclose(port_case("chunked", route),
                               port_case("chunked", route, chunk=0),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("route", ROUTES)
def test_grad_through_run_radsurf(jax_grads, route):
    """Through the dispatcher (every tile type, SW and LW), with veg_ext a
    tensor in the arrays dict: indexed on the device, scattered into the
    dense outputs with its graph kept."""
    arrays = example_arrays(C=4, L=2, S=1, dtype=np.float64)
    veg_ext = torch.as_tensor(arrays["veg_ext"]).requires_grad_(True)
    out = run_radsurf(Config(nsw=1, nlw=1).consolidate(),
                      {**arrays, "veg_ext": veg_ext}, "cpu", route=route)
    (out["sw_norm_dir"]["ground_net"].sum()
     + out["lw_internal"]["top_net"].sum()).backward()
    got = veg_ext.grad.numpy()
    assert np.isfinite(got).all()
    err = rel_err(jax_grads["run_radsurf"], got)
    assert err < TOL, err


@pytest.mark.parametrize("route", ROUTES)
def test_grad_padding_layers(jax_grads, route):
    """Under dz = 0 padding layers the gradient is non-finite exactly where
    JAX's is, and equal elsewhere (no masking JAX lacks)."""
    ref, got = jax_grads["padding"], port_case("padding", route)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert rel_err(ref[fin], got[fin]) < TOL


def test_gradcheck_kernel_route():
    """torch.autograd.gradcheck on the kernel route: 2 columns, 2 layers,
    2 streams, five outputs of the SW solve against central differences."""
    inp = to_canopy_inputs(make_inputs(np.random.default_rng(5), C=2, L=2, S=1,
                                       urban=True), "cpu")
    opt = TS.SolverOptions(nreg=2, nstream=2, do_urban=True, n_double=6)

    def fn(veg_ext):
        ndir, ndiff, bc = TS.spartacus_sw(
            dataclasses.replace(inp, veg_ext=veg_ext), opt, TLG(2))
        return (bc["top_albedo_dir"], bc["top_albedo_diff"],
                ndir["ground_net"], ndir["veg_abs"], ndiff["wall_net"])

    assert torch.autograd.gradcheck(
        fn, (inp.veg_ext.clone().requires_grad_(True),))


def graph_nodes(t):
    """The names of every autograd node reachable from t.grad_fn."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return {n.name() for n in seen}


def test_kernel_route_records_only_its_function():
    """On the kernel route the outputs' grad_fn is _KernelRouteGrad's: its
    forward recorded no plain graph (no solve, no matmul), which the scan
    route records."""
    def outputs(route):
        opt = TS.SolverOptions(nreg=2, nstream=2, do_urban=True)
        res = []
        for lw, solve, pick in ((False, TS.spartacus_sw, lambda o: o[2]["top_albedo_dir"]),
                                (True, TS.spartacus_lw, lambda o: o[0]["veg_abs"])):
            inp = to_canopy_inputs(SimpleNamespace(**example_inputs(
                C=2, L=2, S=1, dtype=np.float64, lw=lw)), "cpu")
            inp.veg_ext.requires_grad_(True)
            res.append(pick(solve(inp, opt, TLG(2), route=route)))
        return res

    plain = {"LinalgSolveExBackward0", "BmmBackward0", "MmBackward0",
             "UnsafeViewBackward0", "CopySlices"}
    for out in outputs("kernel"):
        assert out.grad_fn.name() == "_KernelRouteGradBackward"
        nodes = graph_nodes(out)
        assert nodes <= {"_KernelRouteGradBackward",
                         "torch::autograd::AccumulateGrad"}, nodes
    for out in outputs("scan"):
        assert graph_nodes(out) & plain


def test_retrieval_converges():
    """The twin of tests/test_retrieval_example.py on the CPU: Adam on the
    port's gradient (the kernel route, its plain versions) cuts the
    observation misfit below 1e-2 of its start in 60 steps."""
    from spartacus_surface_tpu_torch.examples.retrieval import (
        make_truth, retrieve)

    inp, true_ext = make_truth(4, 2, 1, np.random.default_rng(1), "cpu")
    opt = TS.SolverOptions(nreg=2, nstream=2, do_urban=True, n_double=6)
    lg = TLG(2)

    def observe(veg_ext):
        out_dir, _, bc = TS.spartacus_sw(
            dataclasses.replace(inp, veg_ext=veg_ext), opt, lg)
        return torch.stack([bc["top_albedo_dir"][:, 0],
                            out_dir["ground_dn"][:, 0],
                            out_dir["veg_abs"].sum(1)[:, 0]])

    with torch.no_grad():
        obs = observe(torch.as_tensor(true_ext))
    _, losses = retrieve(lambda x: ((observe(torch.exp(x)) - obs) ** 2).mean(),
                         torch.log(torch.full((4, 2), 0.3)), 60, 0.05)
    assert losses[-1] < 1e-2 * losses[0], (losses[0], losses[-1])
