"""The longwave slice of the port against the JAX package, float64 on the CPU:
every LW module (region_optics_lw, emission_rates, LW assemble_gammas,
lw_layer_matrices and K1's LW plain version, flat_lw, simple_urban_lw),
spartacus_lw on both routes (the kernel route runs the plain versions of K1
in LW mode, K4 and K5 on CPU tensors) and run_radsurf with do_lw = true on
every tile type, on the same numpy inputs
(tests.test_solver_conservation.make_inputs + add_lw).

Tolerance 1e-9: elementwise for the modules, field-normalized for the
solves (per field max|port - jax| / max(1, max|jax|), bench.py:115-133).
The LW energy budget closes to 1e-9 (internal) and 1e-10 (normalized), the
bars of tests/test_solver_conservation.py:127-128.
"""

import functools

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from spartacus_surface_tpu.models import flat as JF
from spartacus_surface_tpu.models import flux_utils as JFU
from spartacus_surface_tpu.models import gamma as JG
from spartacus_surface_tpu.models import geometry as JGeo
from spartacus_surface_tpu.models import simple_urban as JSU
from spartacus_surface_tpu.models import solver as JS
from spartacus_surface_tpu.models.dispatch import run_radsurf as jax_run
from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss as JLG
from spartacus_surface_tpu.utils.config import Config as JConfig
from spartacus_surface_tpu_torch.models import flat as TF
from spartacus_surface_tpu_torch.models import flux_utils as TFU
from spartacus_surface_tpu_torch.models import gamma as TG
from spartacus_surface_tpu_torch.models import simple_urban as TSU
from spartacus_surface_tpu_torch.models import solver as TS
from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
from spartacus_surface_tpu_torch.ops import layer_kernel as LK
from spartacus_surface_tpu_torch.ops import layer_matrices as TLM
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss as TLG
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.convert import to_canopy_inputs
from spartacus_surface_tpu_torch.utils.inputs import example_arrays
from tests.test_layer_matrices import make_gammas
from tests.test_solver_conservation import add_lw, make_inputs, residual_sw
from tests.test_torch_models import canopy, close, close_dicts
from tests.test_torch_ops import JLM
from tests.test_torch_ops import close as close_rt
from tests.test_torch_solver import ENTRY_CONFIGS, ONE_STREAM_CONFIGS, field_err

T = torch.as_tensor
C, L, S = 6, 4, 2
TOL = 1e-9


# ----------------------------------------------------------------------
# modules
# ----------------------------------------------------------------------

def lw_optics(ns, nreg):
    """Region optics, geometry and Planck fields of a random canopy, both
    packages' (region_optics_lw) and the inputs of the next steps."""
    g = canopy(ns * 10 + nreg)
    rng = np.random.default_rng(ns + nreg)
    frac = np.array(JGeo.region_fracs(g["vf"], g["bf"], nreg))
    npm, npw = map(np.array, JGeo.norm_perim_urban(
        g["bf"], g["bs"], g["vf"], g["vs"], g["cf"], nreg=nreg,
        use_symmetric_vegetation_scale=True, vegetation_isolation_factor=0.0,
        min_vegetation_fraction=1e-6, min_building_fraction=1e-6))
    od = np.array(JGeo.od_scaling_from_fsd(g["fsd"], nreg))
    sb = 5.670374419e-8
    args = (rng.uniform(0, 1e-3, (C, L, S)), rng.uniform(0, 0.2, (C, L, S)),
            sb * rng.uniform(270, 310, (C, L, S)) ** 4, rng.uniform(0, 1, (C, L)),
            rng.uniform(0.0, 0.3, (C, L, S)),
            sb * rng.uniform(270, 310, (C, L, S)) ** 4,
            sb * rng.uniform(270, 310, (C, L, S)) ** 4, od)
    ref = [np.array(x) for x in JG.region_optics_lw(*args, nreg)]
    got = TG.region_optics_lw(*map(T, args), nreg)
    return ref, got, dict(frac=frac, npm=npm, npw=npw, rng=rng)


@pytest.mark.parametrize("ns,nreg", [(2, 1), (4, 2), (4, 3), (8, 2)])
def test_region_optics_lw(ns, nreg):
    ref, got, _ = lw_optics(ns, nreg)
    for x, y in zip(got, ref):
        close(x, y)


@pytest.mark.parametrize("ns,nreg", [(2, 1), (4, 2), (4, 3), (8, 2)])
def test_lw_gammas_and_emission_rates(ns, nreg):
    """assemble_gammas without solar angles builds (None, g1, g2, None)."""
    (ext, ssa, planck), _, geo = lw_optics(ns, nreg)
    rng = geo["rng"]
    fex = np.array(JG.exchange_rates(geo["npm"], geo["frac"], nreg, 1e-6))
    fwall = np.array(JG.wall_rates(geo["npw"], geo["frac"], nreg, 1e-6,
                                   JLG(ns).vadjustment2))
    weps = rng.uniform(0.85, 1.0, (C, L, S))
    args = (ext, ssa, fex, fwall, np.ones((C, L, S)), 1.0 - weps)
    ref = JG.assemble_gammas(*args, JLG(ns), nreg)
    got = TG.assemble_gammas(*map(T, args), TLG(ns), nreg)
    assert ref[0] is None and ref[3] is None and got[0] is None and got[3] is None
    close(got[1], ref[1])
    close(got[2], ref[2])
    wall_emission = 5.670374419e-8 * weps * rng.uniform(270, 310, (C, L, S)) ** 4
    em_args = (ext, ssa, planck, geo["frac"], geo["npw"], wall_emission)
    close_dicts(TG.emission_rates(*map(T, em_args), TLG(ns), nreg),
                JG.emission_rates(*em_args, JLG(ns), nreg))


def _lw_batch(ns, nreg, n=6, seed=0):
    """Random diffuse Gammas with an emission rate b of O(10^2) per unit
    height (many doubling steps), and layer depths."""
    rng = np.random.default_rng(seed)
    g = [np.stack(x) for x in zip(*(make_gammas(rng, ns, nreg) for _ in range(n)))]
    b = rng.uniform(1.0, 300.0, (n, ns * nreg))
    return g[1], g[2], b, rng.uniform(0.3, 40.0, n)


@pytest.mark.parametrize("ns,nreg", [(2, 1), (4, 2), (4, 3), (8, 2)])
def test_lw_layer_matrices(ns, nreg):
    g1, g2, b, dz = _lw_batch(ns, nreg)
    ref = JLM.lw_layer_matrices(g1, g2, b, dz, n_double=30)
    got = TLM.lw_layer_matrices(T(g1), T(g2), T(b), T(dz), n_double=30)
    assert set(got) == set(ref)
    for key in ref:
        close_rt(got[key], ref[key], rtol=1e-9, atol=1e-12)
    chunked = TLM.lw_layer_matrices_chunked(T(g1), T(g2), T(b), T(dz),
                                            n_double=30, chunk=4)
    assert all(torch.equal(chunked[k], got[k]) for k in got)
    # the switch behind it: no direct-beam integrals without int_direct
    lay = TLM.layer_matrices(T(g1[:, :1, :1]) * 0.0, T(g1), T(g2), T(b[..., None]),
                             T(dz), int_direct=False)
    assert set(lay) == {"R", "T", "E", "Sup", "Sdn", "int_diff"}


@pytest.mark.parametrize("ns,nreg", [(2, 1), (4, 2), (4, 3), (8, 2)])
def test_lw_layer_factory_plain_matches_jax(ns, nreg):
    """K1's LW plain version on the [L, rows, B] layout against the JAX LW
    factory (the XLA route that pallas_lw_layer_tiles replaces on a TPU)."""
    g1, g2, b, dz = _lw_batch(ns, nreg, seed=2)
    nd = ns * nreg
    Lb, B = 2, 3  # elements e = l*B + b
    soa = lambda g: T(g.reshape(Lb, B, -1).transpose(0, 2, 1).copy())
    got = LK.lw_layer_factory(soa(g1), soa(g2), soa(b), T(dz.reshape(Lb, B)),
                              nd=nd, chunk=4)
    ref = JLM.lw_layer_matrices(g1, g2, b, dz, n_double=30)
    assert set(got) == set(LK.LW_OUT_NAMES)
    for key in LK.LW_OUT_NAMES:
        r = np.asarray(ref[key]).reshape(Lb, B, -1).transpose(0, 2, 1)
        close_rt(got[key], r, rtol=1e-9, atol=1e-12)


def test_flat_lw():
    rng = np.random.default_rng(9)
    eps, emit = rng.uniform(0.8, 1, (C, S)), rng.uniform(300, 500, (C, S))
    for x, y in zip(TF.flat_lw(T(eps), T(emit)), JF.flat_lw(eps, emit)):
        close_dicts(x, y)


@pytest.mark.parametrize("with_profiles", [False, True])
def test_simple_urban_lw(with_profiles):
    """Including the reference's ground emissivity in the (2,2) element."""
    rng = np.random.default_rng(13)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s)
    args = (u(3, 30, C), u(0.1, 0.6, C), u(10, 60, C), np.arange(C) % 2 == 0,
            u(0.85, 1, C, S), u(300, 500, C, S), u(0.85, 1, C, S),
            u(300, 500, C, S), u(0.85, 1, C, S), u(300, 500, C, S))
    ref = JSU.simple_urban_lw(*args, with_profiles=with_profiles)
    got = TSU.simple_urban_lw(*map(T, args), with_profiles=with_profiles)
    for x, y in zip(got, ref):
        close_dicts(x, y)


# ----------------------------------------------------------------------
# spartacus_lw
# ----------------------------------------------------------------------

LW_FIELDS = ("air_ssa", "ground_emissivity", "ground_emission",
             "roof_emissivity", "roof_emission", "wall_emissivity",
             "wall_emission", "clear_air_planck", "veg_planck", "veg_air_planck")


def inputs(pad_layers=0):
    """make_inputs + add_lw; with pad_layers, the same canopy under dz = 0
    padding layers (the LW layer fields repeat their top layer there)."""
    make = lambda pad: make_inputs(np.random.default_rng(3), C=5, L=3, S=2,
                                   pad_layers=pad)
    base = add_lw(make(0), np.random.default_rng(4))
    if not pad_layers:
        return base
    padded = make(pad_layers)
    for name in LW_FIELDS:
        x = getattr(base, name)
        if x.ndim == 3:  # [C, L, S]
            x = np.pad(x, ((0, 0), (0, pad_layers), (0, 0)), mode="edge")
        setattr(padded, name, x)
    return padded


@functools.lru_cache(maxsize=None)
def jax_ref(nreg, ns, urban, pad_layers=0):
    opt = JS.SolverOptions(nreg=nreg, nstream=ns, do_urban=urban)
    return JS.spartacus_lw(inputs(pad_layers), opt, JLG(ns), with_profiles=True)


def port(nreg, ns, urban, route, pad_layers=0, inp=None, **opt_kw):
    opt = TS.SolverOptions(nreg=nreg, nstream=ns, do_urban=urban, **opt_kw)
    if inp is None:
        inp = to_canopy_inputs(inputs(pad_layers), "cpu")
    return TS.spartacus_lw(inp, opt, TLG(ns), with_profiles=True, route=route)


@pytest.mark.parametrize("route", ["scan", "kernel"])
@pytest.mark.parametrize("urban", [True, False], ids=["urban", "forest"])
@pytest.mark.parametrize("nreg,ns", ENTRY_CONFIGS + ONE_STREAM_CONFIGS)
def test_spartacus_lw_matches_jax(nreg, ns, urban, route):
    err = field_err(jax_ref(nreg, ns, urban), port(nreg, ns, urban, route))
    assert err < TOL, err


@pytest.mark.parametrize("route", ["scan", "kernel"])
def test_lw_padding_layers(route):
    """dz = 0 padding above the canopy is a no-op and the padded solve
    matches JAX."""
    Lc = inputs().dz.shape[1]
    padded = port(2, 4, True, route, pad_layers=2)
    assert field_err(port(2, 4, True, route), padded, nlay=Lc) < 1e-12
    assert field_err(jax_ref(2, 4, True, pad_layers=2), padded, nlay=Lc) < TOL


def test_lw_column_chunk_is_exact():
    ref = port(3, 4, True, "kernel")
    got = port(3, 4, True, "kernel", column_chunk=2, factory_chunk=7)
    assert field_err(ref, got) < 1e-13


def test_lw_forest_ignores_building_sentinels():
    """Forest solves zero building_fraction (input files may carry -1)."""
    inp = to_canopy_inputs(inputs(), "cpu")
    ref = port(2, 4, False, "kernel", inp=inp)
    inp.building_fraction = torch.full_like(inp.building_fraction, -1.0)
    assert field_err(ref, port(2, 4, False, "kernel", inp=inp)) == 0.0


@pytest.mark.parametrize("route", ["scan", "kernel"])
@pytest.mark.parametrize("urban,nreg,ns", [(True, 1, 4), (True, 2, 2),
                                           (False, 2, 4), (True, 3, 4)])
def test_lw_energy_budget(urban, nreg, ns, route):
    """The budget of tests/test_solver_conservation.py::test_lw_conservation
    on the port's solve, and physical top-of-canopy boundary values."""
    rng = np.random.default_rng(321)
    inp = to_canopy_inputs(add_lw(make_inputs(rng, urban=urban), rng), "cpu")
    internal, norm, bc = port(nreg, ns, urban, route, inp=inp)
    np.testing.assert_allclose(residual_sw({k: v.numpy() for k, v in internal.items()}),
                               0.0, atol=1e-9)
    np.testing.assert_allclose(residual_sw({k: v.numpy() for k, v in norm.items()}),
                               0.0, atol=1e-10)
    e = bc["top_emissivity"]
    assert bool(((e > 0.0) & (e <= 1.0)).all()) and bool((bc["top_emission"] > 0).all())


# ----------------------------------------------------------------------
# run_radsurf with do_lw = true, every tile type
# ----------------------------------------------------------------------

LW_GROUPS = ("lw_internal", "lw_norm", "bc_out")
CASES = {  # name: (Config kwargs, columns with the sun below the horizon)
    "default": (dict(), ()),
    "profiles_lw_streams": (dict(do_save_flux_profile=True,
                                 n_stream_lw_urban=2, n_stream_lw_forest=8), ()),
    "sun_down": (dict(use_sw_direct_albedo=True), (1, 3, 4)),
}


def rr_arrays(sun_down=()):
    a = example_arrays(C=12, L=3, S=2, dtype=np.float64)
    a["cos_sza"][list(sun_down)] = -0.2  # LW is not masked by the sun
    return a


@functools.lru_cache(maxsize=None)
def jax_rr(case):
    kw, sun_down = CASES[case]
    return jax_run(JConfig(nsw=2, nlw=2, **kw).consolidate(), rr_arrays(sun_down))


def rr_err(ref, got):
    assert set(ref) == set(got)
    worst = 0.0
    for g in ref:
        assert set(ref[g]) == set(got[g]), (g, set(ref[g]) ^ set(got[g]))
        for k in ref[g]:
            r, x = np.asarray(ref[g][k]), got[g][k].numpy()
            assert r.shape == x.shape and np.isfinite(x).all(), (g, k)
            worst = max(worst, np.abs(r - x).max() / max(1.0, np.abs(r).max()))
    return worst


@pytest.mark.parametrize("route", ["kernel", "scan"])
@pytest.mark.parametrize("case", list(CASES))
def test_run_radsurf_lw_matches_jax(case, route):
    kw, sun_down = CASES[case]
    got = run_radsurf(Config(nsw=2, nlw=2, **kw).consolidate(), rr_arrays(sun_down),
                      "cpu", route=route)
    assert rr_err(jax_rr(case), got) < TOL


def test_run_radsurf_lw_only():
    """do_sw = false: only the LW containers and boundary values."""
    got = run_radsurf(Config(do_sw=False, nlw=2).consolidate(), rr_arrays(), "cpu")
    assert set(got) == {"lw_internal", "lw_norm", "bc_out"}
    assert set(got["bc_out"]) == {"lw_emissivity", "lw_emission"}
    ref = jax_run(JConfig(do_sw=False, nlw=2).consolidate(), rr_arrays())
    assert rr_err(ref, got) < TOL


def test_lw_flux_utils_match_jax():
    """budget_components / check_flux give the JAX package's LW budget: it
    closes on the layered and flat columns; the simple-urban columns keep
    the reference's (2,2) quirk and do not close, in both packages."""
    a = rr_arrays()
    got = run_radsurf(Config(nsw=2, nlw=2).consolidate(), a, "cpu")
    ref = jax_rr("default")
    simple = np.isin(a["i_representation"], [4, 5])
    for g, tol in (("lw_internal", 1e-9), ("lw_norm", 1e-10)):
        res = TFU.check_flux(got[g], a, g, printer=lambda *_: None)
        jres = JFU.check_flux({k: np.asarray(v) for k, v in ref[g].items()}, a, g,
                              printer=lambda *_: None)
        np.testing.assert_allclose(res, jres, atol=1e-9)
        assert np.abs(res[~simple]).max() < tol
        assert np.abs(res[simple]).max() > 1e-6


def test_run_radsurf_lw_on_missing_cuda_raises():
    """With do_lw = true too, a CUDA device that is not there raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_radsurf(Config(do_sw=False).consolidate(), rr_arrays(), "cuda")


def test_lw_kernel_route_refuses_gradients():
    """The kernel route refuses forward-mode gradients (its autograd
    Function has no jvp, as the JAX package's custom_vjp has none); its
    reverse-mode gradient is the scan route's."""
    def grad(route):
        inp = to_canopy_inputs(inputs(), "cpu")
        inp.veg_planck.requires_grad_(True)
        internal, _, bc = port(2, 4, True, route, inp=inp)
        (internal["veg_abs"].sum() + bc["top_emission"].sum()).backward()
        return inp.veg_planck.grad

    torch.testing.assert_close(grad("kernel"), grad("scan"), rtol=1e-12, atol=0.0)
    inp = to_canopy_inputs(inputs(), "cpu")
    with fwAD.dual_level():
        inp.veg_planck = fwAD.make_dual(inp.veg_planck,
                                        torch.ones_like(inp.veg_planck))
        with pytest.raises(NotImplementedError, match="jvp"):
            port(2, 4, True, "kernel", inp=inp)
