"""Parity of the PyTorch port's ops (spartacus_surface_tpu_torch.ops) with the
JAX package, in float64 on the CPU, on the same numpy inputs.

Tolerances: quadrature and matrix algebra 1e-12 (both are the same
arithmetic up to rounding); the layer factory, its adding step and K1's plain
version rtol 1e-9, the bar of tests/test_layer_matrices.py.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spartacus_surface_tpu.ops import matrix as JM
from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss as JLG
from spartacus_surface_tpu.utils.config import Config as JConfig
from spartacus_surface_tpu_torch.ops import layer_kernel as LK
from spartacus_surface_tpu_torch.ops import layer_matrices as TLM
from spartacus_surface_tpu_torch.ops import matrix as TM
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss as TLG
from spartacus_surface_tpu_torch.utils.config import Config as TConfig
from tests.test_layer_matrices import make_gammas

# (the JAX ops package re-exports a function under the submodule's name)
JLM = importlib.import_module("spartacus_surface_tpu.ops.layer_matrices")
T = torch.as_tensor


def close(got, ref, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def dd_batch(rng, batch, n):
    """Random diagonally dominant batch (the SPARTACUS regime)."""
    a = rng.standard_normal((*batch, n, n))
    a[..., np.arange(n), np.arange(n)] = np.abs(a).sum(-1) + 1.0
    return a


@pytest.mark.parametrize("ns", [1, 2, 4, 8])
def test_legendre_gauss(ns):
    j, t = JLG(ns), TLG(ns)
    for name in ("mu", "weight", "sin_ang", "tan_ang", "hweight", "vweight"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    assert t.vadjustment == j.vadjustment
    assert abs(t.vadjustment2 - j.vadjustment2) < 1e-12


def test_config_fields_and_consolidate():
    assert ([f.name for f in dataclasses.fields(TConfig)]
            == [f.name for f in dataclasses.fields(JConfig)])
    t = TConfig(n_stream_sw_urban=8, nsw=3).consolidate()
    j = JConfig(n_stream_sw_urban=8, nsw=3).consolidate()
    assert t.nswinternal == j.nswinternal == 3
    np.testing.assert_allclose(t.lg_sw_urban.mu, j.lg_sw_urban.mu, rtol=1e-12)
    assert isinstance(t.lg_sw_urban, TLG)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 13])
def test_solve_inv_and_nopiv_lu(n):
    rng = np.random.default_rng(n)
    a = dd_batch(rng, (5,), n)
    b = rng.standard_normal((5, n, 3))
    close(TM.solve(T(a), T(b)), JM.solve(a, b))
    close(TM.solve(T(a), T(b[..., 0])), JM.solve(a, b[..., 0]))
    close(TM.inv(T(a)), JM.inv(a))
    lu = TM._lu_factor_nopiv(T(a))
    close(lu, JM._lu_factor_nopiv(jnp.asarray(a)))
    close(TM._lu_solve_nopiv(lu, T(b)),
          JM._lu_solve_nopiv(jnp.asarray(lu.numpy()), jnp.asarray(b)))
    if n == 2:
        close(TM._solve2(T(a), T(b)), JM._solve2(a, b))


def test_matmul_matvec_expm():
    rng = np.random.default_rng(11)
    a = 0.1 * rng.standard_normal((4, 6, 6))
    x = rng.standard_normal((4, 6))
    close(TM.matmul(T(a), T(a)), JM.matmul(a, a))
    close(TM.matvec(T(a), T(x)), JM.matvec(a, x))
    close(TM.expm_pade7(T(a)), JM.expm_pade7(a))


def _gamma_batch(ns, nreg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    g = [np.stack(x) for x in zip(*(make_gammas(rng, ns, nreg) for _ in range(n)))]
    dz = rng.uniform(0.3, 40.0, n)  # thin to many doubling steps
    return g, dz


@pytest.mark.parametrize("ns,nreg", [(2, 1), (4, 2), (4, 3), (8, 2)])
def test_layer_matrices(ns, nreg):
    (g0, g1, g2, g3), dz = _gamma_batch(ns, nreg)
    ref = JLM.layer_matrices(g0, g1, g2, g3, dz, n_double=30)
    got = TLM.layer_matrices(T(g0), T(g1), T(g2), T(g3), T(dz), n_double=30)
    assert set(got) == set(ref)
    for key in ref:
        close(got[key], ref[key], rtol=1e-9, atol=1e-12)
    assert TLM.pade7_theta(torch.float32) == JLM.pade7_theta(np.float32)
    assert TLM.pade7_theta(torch.float64) == JLM.pade7_theta(np.float64)


def test_combine_layers():
    (g0, g1, g2, g3), dz = _gamma_batch(4, 2, n=2, seed=5)
    lay = JLM.layer_matrices(g0, g1, g2, g3, dz, with_int=False)
    top = {k: v[0] for k, v in lay.items()}
    bot = {k: v[1] for k, v in lay.items()}
    ref = JLM.combine_layers(top, bot)
    got = TLM.combine_layers({k: T(np.array(v)) for k, v in top.items()},
                             {k: T(np.array(v)) for k, v in bot.items()})
    for key in ref:
        close(got[key], ref[key], rtol=1e-9)


@pytest.mark.parametrize("ns,nreg", [(2, 1), (4, 2), (4, 3), (8, 2)])
def test_layer_factory_plain_matches_jax(ns, nreg):
    """K1's plain version on the [L, rows, B] layout against the JAX factory
    (the XLA route that the Pallas factory K1 replaces on a TPU)."""
    (g0, g1, g2, g3), dz = _gamma_batch(ns, nreg, n=6, seed=2)
    nd = ns * nreg
    L, B = 2, 3  # elements e = l*B + b
    soa = lambda g: T(g.reshape(L, B, -1).transpose(0, 2, 1).copy())
    got = LK.layer_factory(soa(g0), soa(g1), soa(g2), soa(g3),
                           T(dz.reshape(L, B)), nd=nd, ndir=nreg, chunk=4)
    ref = JLM.layer_matrices(g0, g1, g2, g3, dz, n_double=30)
    for key in LK.OUT_NAMES:
        r = np.asarray(ref[key]).reshape(L, B, -1).transpose(0, 2, 1)
        close(got[key], r, rtol=1e-9, atol=1e-12)
