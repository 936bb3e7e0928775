"""Parity of the port's associative route with the JAX package's.

SolverOptions.associative_sweeps replaces the sequential adding and flux
recurrences with the Redheffer-star prefix and affine suffix compositions
of ops/assoc_adding.py, in both packages.  The twins of
tests/test_associative.py: the port's associative route (float64, CPU)
against JAX's on its XLA route, every output field at 1e-9
field-normalized error with the NaN pattern of the padding layers equal;
the deep canopy against the port's own sequential route; the star combine
against two sequential steps at 1e-12; the kernel route, where K1's plain
version feeds the associative sweeps; and debug_dump_sw against the JAX
package's, line for line.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from spartacus_surface_tpu.models import solver as JS
from spartacus_surface_tpu.ops import assoc_adding as JA
from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss as JLG
from spartacus_surface_tpu_torch.models import solver as TS
from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
from spartacus_surface_tpu_torch.ops import assoc_adding as TA
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss as TLG
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.convert import to_canopy_inputs
from spartacus_surface_tpu_torch.utils.inputs import example_arrays
from tests.test_solver_conservation import add_lw, make_inputs

TOL = 1e-9


def field_err(ref, got):
    """Worst per-field max|got - ref| / max(1, max|ref|) over the result
    dicts, on the entries finite in both; a field whose NaN / inf pattern
    differs between the two is an error of inf."""
    worst = 0.0
    for rd, gd in zip(ref, got):
        assert set(rd) == set(gd), set(rd) ^ set(gd)
        for k in rd:
            r = np.asarray(rd[k], np.float64)
            g = gd[k].detach().numpy()
            assert r.shape == g.shape, (k, r.shape, g.shape)
            fin = np.isfinite(r)
            if not np.array_equal(fin, np.isfinite(g)):
                return np.inf
            if fin.any():
                scale = max(1.0, np.abs(r[fin]).max())
                worst = max(worst, np.abs(r[fin] - g[fin]).max() / scale)
    return worst


def jax_opts(urban, nreg=2, ns=2, assoc=True):
    return JS.SolverOptions(nreg=nreg, nstream=ns, do_urban=urban, n_double=8,
                            associative_sweeps=assoc, use_pallas_factory=False,
                            use_pallas_sweeps=False)


def port_opts(urban, nreg=2, ns=2, assoc=True):
    return TS.SolverOptions(nreg=nreg, nstream=ns, do_urban=urban, n_double=8,
                            associative_sweeps=assoc)


def sw_inputs(L, urban):
    return make_inputs(np.random.default_rng(100 + L), C=3, L=L, S=2,
                       urban=urban)


def lw_inputs(urban):
    rng = np.random.default_rng(42)
    return add_lw(make_inputs(rng, C=3, L=5, S=2, urban=urban), rng)


@pytest.mark.parametrize("urban", [False, True], ids=["forest", "urban"])
@pytest.mark.parametrize("L", [1, 3, 11])
def test_sw_parity(urban, L):
    inp = sw_inputs(L, urban)
    ref = JS.spartacus_sw(inp, jax_opts(urban), JLG(2), with_profiles=True)
    got = TS.spartacus_sw(to_canopy_inputs(inp, "cpu"), port_opts(urban),
                          TLG(2), with_profiles=True, route="scan")
    err = field_err(ref, got)
    assert err < TOL, err


def test_sw_parity_nreg3():
    """nreg = 3, 4 streams, under 2 dz = 0 padding layers: the padding
    layers' non-finite absorption rows fall where JAX's do."""
    inp = make_inputs(np.random.default_rng(7), C=2, L=4, S=1, urban=True,
                      pad_layers=2)
    ref = JS.spartacus_sw(inp, jax_opts(True, 3, 4), JLG(4))
    got = TS.spartacus_sw(to_canopy_inputs(inp, "cpu"), port_opts(True, 3, 4),
                          TLG(4), route="scan")
    assert not all(np.isfinite(np.asarray(v)).all() for v in ref[0].values())
    err = field_err(ref, got)
    assert err < TOL, err


@pytest.mark.parametrize("urban", [False, True], ids=["forest", "urban"])
def test_lw_parity(urban):
    inp = lw_inputs(urban)
    ref = JS.spartacus_lw(inp, jax_opts(urban), JLG(2), with_profiles=True)
    got = TS.spartacus_lw(to_canopy_inputs(inp, "cpu"), port_opts(urban),
                          TLG(2), with_profiles=True, route="scan")
    err = field_err(ref, got)
    assert err < TOL, err


def test_kernel_route_feeds_the_associative_sweeps():
    """The kernel route with associative_sweeps: K1's plain version (the
    CPU stand-in of K1 / K1d) feeds the associative sweeps, and the sweep
    kernels K2-K5 do not run."""
    from spartacus_surface_tpu_torch.ops import layer_kernel as LK

    calls = []
    factory = TS.layer_factory

    def counting(*a, **k):
        calls.append(k["nd"])
        return factory(*a, **k)

    inp = sw_inputs(3, True)
    ref = JS.spartacus_sw(inp, jax_opts(True), JLG(2), with_profiles=True)
    lw = lw_inputs(True)
    ref_lw = JS.spartacus_lw(lw, jax_opts(True), JLG(2), with_profiles=True)
    sweeps = ("sw_up_sweep", "sw_down_sweep_both", "lw_up_sweep",
              "lw_down_sweep_both")

    def refuse(*a, **k):
        raise AssertionError("a sweep kernel ran on the associative route")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TS, "layer_factory", counting)
        mp.setattr(LK, "layer_factory", counting)
        for name in sweeps:
            mp.setattr(TS, name, refuse)
        got = TS.spartacus_sw(to_canopy_inputs(inp, "cpu"), port_opts(True),
                              TLG(2), with_profiles=True)
        got_lw = TS.spartacus_lw(to_canopy_inputs(lw, "cpu"), port_opts(True),
                                 TLG(2), with_profiles=True)
    assert len(calls) == 2, calls
    err = max(field_err(ref, got), field_err(ref_lw, got_lw))
    assert err < TOL, err


def test_deep_canopy_parity():
    """64 layers, the regime the log-depth route exists for: the port's
    associative route against its own sequential scan route (no JAX call,
    so it stays fast)."""
    rng = np.random.default_rng(11)
    inp = make_inputs(rng, C=2, L=64, S=1, urban=True)
    # Thin layers so the 64-layer canopy stays optically sane
    inp = dataclasses.replace(inp, dz=np.asarray(inp.dz) * 0.12)
    lg = TLG(2)
    run = lambda fn, x, assoc: fn(to_canopy_inputs(x, "cpu"),
                                  port_opts(True, assoc=assoc), lg, route="scan")
    ref, got = run(TS.spartacus_sw, inp, False), run(TS.spartacus_sw, inp, True)
    err = field_err([{k: v.numpy() for k, v in d.items()} for d in ref[:2]],
                    got[:2])
    assert err < 1e-8, err
    lwi = add_lw(make_inputs(rng, C=2, L=64, S=1, urban=True), rng)
    ref, got = run(TS.spartacus_lw, lwi, False), run(TS.spartacus_lw, lwi, True)
    err = field_err([{k: v.numpy() for k, v in d.items()} for d in ref[:2]],
                    got[:2])
    assert err < 1e-8, err


def test_star_combine_matches_two_step():
    """One star combine == two sequential adding steps, and the port's
    prefix equals the JAX package's."""
    rng = np.random.default_rng(3)
    n, p = 4, 2
    rand = lambda *s: rng.uniform(0.05, 0.3, s)
    elems = {"Rd": rand(2, n, n), "Td": rand(2, n, n), "Ru": rand(2, n, n),
             "Tu": rand(2, n, n), "E": rand(2, p, p), "Su": rand(2, n, p),
             "Sd": rand(2, n, p)}
    a_ground, d_ground = rand(n, n), rand(n, p)
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    ground = TA.ground_star_element(torch.as_tensor(a_ground),
                                    torch.as_tensor(d_ground), p)
    prefix = TA.star_prefix(t(elems), ground)
    one = {k: torch.as_tensor(elems[k][0]) for k in elems}
    two = {k: torch.as_tensor(elems[k][1]) for k in elems}
    seq = TA.star_combine(TA.star_combine(ground, one), two)
    jprefix = JA.star_prefix(elems, JA.ground_star_element(a_ground, d_ground, p))
    for k in seq:
        np.testing.assert_allclose(prefix[k][2].numpy(), seq[k].numpy(),
                                   rtol=1e-12, atol=1e-14, err_msg=k)
        np.testing.assert_allclose(prefix[k].numpy(), np.asarray(jprefix[k]),
                                   rtol=1e-12, atol=1e-14, err_msg=k)


@pytest.mark.parametrize("L", [1, 2, 5, 8, 13])
def test_associative_scan_matches_a_sequential_fold(L):
    """associative_scan's odd-even recursion gives every inclusive prefix
    of a sequential left fold, at lengths odd, even and powers of two."""
    rng = np.random.default_rng(L)
    mats = torch.as_tensor(rng.uniform(-1.0, 1.0, (L, 3, 3)))
    scan = TA.associative_scan(lambda a, b: {"M": b["M"] @ a["M"]},
                               {"M": mats})["M"]
    acc = mats[0]
    for i in range(L):
        if i:
            acc = mats[i] @ acc
        torch.testing.assert_close(scan[i], acc, rtol=1e-12, atol=1e-12)


@functools.lru_cache(maxsize=None)
def _dump_inputs():
    return make_inputs(np.random.default_rng(5), C=2, L=3, S=2, urban=True)


def test_debug_dump_sw_matches_jax(capsys, monkeypatch):
    """Under SPARTACUS_DEBUG_ARRAYS=1 debug_dump_sw prints the JAX
    package's lines, number for number; run_radsurf prints the same dump
    for its SW group (the JAX dispatcher's hook); unset, nothing."""
    inp = _dump_inputs()
    jopt = JS.SolverOptions(nreg=2, nstream=4, do_urban=True)
    topt = TS.SolverOptions(nreg=2, nstream=4, do_urban=True)
    TS.debug_dump_sw(to_canopy_inputs(inp, "cpu"), topt, TLG(4))
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("SPARTACUS_DEBUG_ARRAYS", "1")
    JS.debug_dump_sw(inp, jopt, JLG(4))
    ref = capsys.readouterr().out.splitlines()
    TS.debug_dump_sw(to_canopy_inputs(inp, "cpu"), topt, TLG(4))
    got = capsys.readouterr().out.splitlines()
    assert len(ref) > 20 and got == ref
    arrays = example_arrays(C=6, L=2, dtype=np.float64,
                            i_representation=[3, 3, 0, 4, 3, 5])
    run_radsurf(Config(do_lw=False).consolidate(), arrays, "cpu")
    out = capsys.readouterr().out
    assert out.startswith("--- DEBUG ARRAYS: SW first column") and "gamma3 =" in out
