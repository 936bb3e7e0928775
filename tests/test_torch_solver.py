"""Whole-solve parity of the port's spartacus_sw with the JAX package.

Both routes of the port run on the CPU in float64: the scan route (plain
torch) and the kernel route, which on CPU tensors runs the plain versions of
kernels K1 -> K2 -> K3 composed (ops/layer_kernel.py, ops/sweep_kernels.py)
plus the closed-form epilogue.  Both are held against JAX spartacus_sw on its
XLA route (the JAX package's own reference off a TPU) at 1e-9
field-normalized error: per field max|port - jax| / max(1, max|jax|), the
metric of bench.py:115-133.
"""

import functools

import numpy as np
import pytest
import torch

from spartacus_surface_tpu.models import solver as JS
from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss as JLG
from spartacus_surface_tpu_torch.models import solver as TS
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss as TLG
from spartacus_surface_tpu_torch.utils.convert import to_canopy_inputs
from tests.test_solver_conservation import make_inputs

ENTRY_CONFIGS = ((1, 2), (2, 4), (3, 4), (2, 8))  # __graft_entry__.ENTRY_CONFIGS
# One stream per hemisphere: the SW factory takes the dense branch (K1d) at
# every nreg, the LW one at nreg = 1
ONE_STREAM_CONFIGS = ((1, 1), (2, 1), (3, 1))
TOL = 1e-9


def field_err(ref, got, nlay=None):
    """Worst per-field normalized error over the (norm_dir, norm_diff, bc)
    triples; with nlay, per-layer fields are cut to their first nlay layers
    (the real canopy below dz = 0 padding; the band count must stay below
    nlay so that [C, S] fields are never cut)."""
    worst = 0.0
    for rd, gd in zip(ref, got):
        assert set(rd) == set(gd), set(rd) ^ set(gd)
        for k in rd:
            r = np.asarray(rd[k], np.float64)
            g = gd[k].numpy().astype(np.float64)
            if nlay is not None and r.ndim >= 2:  # [C, L(, S)] vs [C, S]
                cut = lambda x: x[:, :nlay] if x.shape[1] > nlay else x
                r, g = cut(r), cut(g)
            assert r.shape == g.shape, (k, r.shape, g.shape)
            assert np.isfinite(g).all() and np.isfinite(r).all(), k
            scale = max(1.0, np.abs(r).max(), np.abs(g).max())
            worst = max(worst, np.abs(r - g).max() / scale)
    return worst


def inputs(pad_layers=0):
    return make_inputs(np.random.default_rng(3), C=5, L=3, S=2, urban=True,
                       pad_layers=pad_layers)


@functools.lru_cache(maxsize=None)
def jax_ref(nreg, ns, urban, pad_layers=0):
    opt = JS.SolverOptions(nreg=nreg, nstream=ns, do_urban=urban)
    return JS.spartacus_sw(inputs(pad_layers), opt, JLG(ns), with_profiles=True)


def port(nreg, ns, urban, route, pad_layers=0, **opt_kw):
    opt = TS.SolverOptions(nreg=nreg, nstream=ns, do_urban=urban, **opt_kw)
    return TS.spartacus_sw(to_canopy_inputs(inputs(pad_layers), "cpu"), opt,
                           TLG(ns), with_profiles=True, route=route)


@pytest.mark.parametrize("route", ["scan", "kernel"])
@pytest.mark.parametrize("urban", [True, False], ids=["urban", "forest"])
@pytest.mark.parametrize("nreg,ns", ENTRY_CONFIGS + ONE_STREAM_CONFIGS)
def test_spartacus_sw_matches_jax(nreg, ns, urban, route):
    err = field_err(jax_ref(nreg, ns, urban), port(nreg, ns, urban, route))
    assert err < TOL, err


@pytest.mark.parametrize("route", ["scan", "kernel"])
def test_padding_layers(route):
    """dz = 0 padding above the canopy is a no-op (cf. test_solver_conservation
    ::test_padding_is_noop_sw) and the padded solve matches JAX."""
    L = inputs().dz.shape[1]
    padded = port(2, 4, True, route, pad_layers=2)
    assert field_err(port(2, 4, True, route), padded, nlay=L) < 1e-12
    assert field_err(jax_ref(2, 4, True, pad_layers=2), padded, nlay=L) < TOL


def test_column_chunk_is_exact():
    ref = port(2, 4, True, "kernel")
    got = port(2, 4, True, "kernel", column_chunk=2, factory_chunk=7)
    assert field_err(ref, got) < 1e-13


def test_forest_ignores_building_sentinels():
    """Forest solves zero building_fraction (input files may carry -1)."""
    opt = TS.SolverOptions(nreg=2, nstream=4, do_urban=False)
    inp = to_canopy_inputs(inputs(), "cpu")
    ref = TS.spartacus_sw(inp, opt, TLG(4))
    inp.building_fraction = torch.full_like(inp.building_fraction, -1.0)
    assert field_err(ref, TS.spartacus_sw(inp, opt, TLG(4))) == 0.0


def test_mixed_dtypes_are_coerced():
    inp = to_canopy_inputs(inputs(), "cpu", dtype=torch.float32)
    inp.ground_albedo = inp.ground_albedo.double()
    out = TS.spartacus_sw(inp, TS.SolverOptions(nreg=2, nstream=4,
                                                do_urban=True), TLG(4))
    assert all(v.dtype == torch.float32 for d in out for v in d.values())
