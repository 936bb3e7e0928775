"""Parity of the port's geometry, Gamma assembly, view factors and the
analytic flat / simple-urban shortwave paths with the JAX package, float64
on the CPU, same numpy inputs.  Tolerance 1e-12: the same elementwise
arithmetic up to rounding."""

import numpy as np
import pytest
import torch

from spartacus_surface_tpu.models import flat as JF
from spartacus_surface_tpu.models import gamma as JG
from spartacus_surface_tpu.models import geometry as JGeo
from spartacus_surface_tpu.models import simple_urban as JSU
from spartacus_surface_tpu.models import view_factor as JVF
from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss as JLG
from spartacus_surface_tpu_torch.models import flat as TF
from spartacus_surface_tpu_torch.models import gamma as TG
from spartacus_surface_tpu_torch.models import geometry as TGeo
from spartacus_surface_tpu_torch.models import simple_urban as TSU
from spartacus_surface_tpu_torch.models import view_factor as TVF
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss as TLG

T = torch.as_tensor
C, L, S = 6, 4, 2


def close(got, ref, tol=1e-12):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def close_dicts(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k])


def canopy(seed):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s)
    vf = u(0.0, 0.5, C, L)
    vf[0, 0] = 0.0  # a vegetation-free layer
    bf = np.sort(u(0.0, 0.4, C, L), axis=1)[:, ::-1].copy()
    bf[1, :] = 0.0  # a forest column
    bf[2, 1] = 1.0 - vf[2, 1]  # no clear region left
    return dict(vf=vf, bf=bf, vs=u(20, 200, C, L), bs=u(10, 80, C, L),
                cf=u(0, 1, C, L), fsd=u(0.3, 1.0, C, L))


@pytest.mark.parametrize("nreg", [1, 2, 3])
@pytest.mark.parametrize("symmetric,iso", [(True, 0.0), (False, 0.3)])
def test_geometry(nreg, symmetric, iso):
    g = canopy(nreg)
    kw = dict(nreg=nreg, use_symmetric_vegetation_scale=symmetric,
              vegetation_isolation_factor=iso, min_vegetation_fraction=1e-6,
              min_building_fraction=1e-6)
    ref = JGeo.norm_perim_urban(g["bf"], g["bs"], g["vf"], g["vs"], g["cf"], **kw)
    got = TGeo.norm_perim_urban(T(g["bf"]), T(g["bs"]), T(g["vf"]), T(g["vs"]),
                                T(g["cf"]), **kw)
    for x, y in zip(got, ref):
        close(x, y)
    frac = np.array(JGeo.region_fracs(g["vf"], g["bf"], nreg))
    tfrac = TGeo.region_fracs(T(g["vf"]), T(g["bf"]), nreg)
    close(tfrac, frac)
    close(TGeo.od_scaling_from_fsd(T(g["fsd"]), nreg),
          JGeo.od_scaling_from_fsd(g["fsd"], nreg))
    for x, y in zip(TGeo.overlap_matrices_urban(tfrac, nreg, 1e-6, T(g["bf"])),
                    JGeo.overlap_matrices_urban(frac, nreg, 1e-6)):
        close(x, y)


@pytest.mark.parametrize("ns,nreg", [(2, 1), (4, 2), (4, 3), (8, 2)])
def test_gamma(ns, nreg):
    g = canopy(ns + nreg)
    rng = np.random.default_rng(ns * nreg)
    frac = JGeo.region_fracs(g["vf"], g["bf"], nreg)
    npm, npw = JGeo.norm_perim_urban(
        g["bf"], g["bs"], g["vf"], g["vs"], g["cf"], nreg=nreg,
        use_symmetric_vegetation_scale=True, vegetation_isolation_factor=0.0,
        min_vegetation_fraction=1e-6, min_building_fraction=1e-6)
    frac, npm, npw = map(np.array, (frac, npm, npw))
    fex = np.array(JG.exchange_rates(npm, frac, nreg, 1e-6))
    close(TG.exchange_rates(T(npm), T(frac), nreg, 1e-6), fex)
    fwall = np.array(JG.wall_rates(npw, frac, nreg, 1e-6, 1.0))
    close(TG.wall_rates(T(npw), T(frac), nreg, 1e-6, 1.0), fwall)
    od = np.array(JGeo.od_scaling_from_fsd(g["fsd"], nreg))
    air_ext, air_ssa = rng.uniform(0, 1e-3, (C, L, S)), rng.uniform(0.9, 1, (C, L, S))
    veg_ext, veg_ssa = rng.uniform(0, 1, (C, L)), rng.uniform(0.2, 0.9, (C, L, S))
    ref_opt = JG.region_optics_sw(air_ext, air_ssa, veg_ext, veg_ssa, od, nreg)
    got_opt = TG.region_optics_sw(T(air_ext), T(air_ssa), T(veg_ext),
                                  T(veg_ssa), T(od), nreg)
    for x, y in zip(got_opt, ref_opt):
        close(x, y)
    wall_ext, wall_fac = rng.uniform(0.5, 1, (C, L, S)), rng.uniform(0, 0.5, (C, L, S))
    mu0 = rng.uniform(0.1, 1.0, C)
    sin0 = np.sqrt(1 - mu0 ** 2)
    ang = dict(cos_sza=mu0, sin_sza=sin0, tan_sza=sin0 / mu0)
    ref = JG.assemble_gammas(*map(np.asarray, ref_opt), fex, fwall, wall_ext,
                             wall_fac, JLG(ns), nreg, **ang)
    got = TG.assemble_gammas(*got_opt, T(fex), T(fwall),
                             T(wall_ext), T(wall_fac), TLG(ns), nreg,
                             **{k: T(v) for k, v in ang.items()})
    for x, y in zip(got, ref):
        close(x.expand(y.shape), y)


def test_view_factors():
    rng = np.random.default_rng(4)
    h, mu0 = rng.uniform(0.05, 5.0, 9), rng.uniform(0.05, 1.0, 9)
    for tf, jf in ((TVF.view_factors_inf, JVF.view_factors_inf),
                   (TVF.view_factors_exp, JVF.view_factors_exp)):
        for x, y in zip(tf(T(h), T(mu0)), jf(h, mu0)):
            close(x, y)


def test_flat_sw():
    rng = np.random.default_rng(8)
    a, ad = rng.uniform(0, 1, (C, S)), rng.uniform(0, 1, (C, S))
    for x, y in zip(TF.flat_sw(T(a), T(ad)), JF.flat_sw(a, ad)):
        close_dicts(x, y)


@pytest.mark.parametrize("with_profiles", [False, True])
def test_simple_urban_sw(with_profiles):
    rng = np.random.default_rng(12)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s)
    args = (u(3, 30, C), u(0.1, 0.6, C), u(10, 60, C), u(0.1, 1.0, C),
            np.arange(C) % 2 == 0, u(0, 0.4, C, S), u(0, 0.4, C, S),
            u(0, 0.4, C, S), u(0, 0.4, C, S))
    ref = JSU.simple_urban_sw(*args, with_profiles=with_profiles)
    got = TSU.simple_urban_sw(*map(T, args), with_profiles=with_profiles)
    for x, y in zip(got, ref):
        close_dicts(x, y)
