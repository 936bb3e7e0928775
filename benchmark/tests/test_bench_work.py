"""The work count (benchmark/work.py): a hand count at a tiny shape, and a
count that follows from the inputs and the configuration alone."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import generate as GEN
from benchmark import reference as R
from benchmark import work as W
from benchmark.reference import solver as RS
from benchmark.reference.legendre_gauss import LegendreGauss

from spartacus_surface_tpu_torch.models import solver as PS
from spartacus_surface_tpu_torch.ops.layer_matrices import pade7_theta

BENCH = Path(__file__).resolve().parents[1]


def test_hand_count_one_region_one_stream():
    # nd = ndir = 1: Gamma dz is 3 x 3
    lu = lambda n: 2 * n**3 / 3
    expm = 4 * 2 * 27 + lu(3) + 2 * 9 * 3            # a2, a4, a6, u; the solve
    extract = (lu(1) + 2 * 1 * 2) + 2 + 2            # x; f21 x1; f21 x2
    schur = 3 * (lu(1) + 2) + 3 * 2 + (lu(1) + 2) + 2 + 2
    assert W.factory_element_ops(1, 1, True) == pytest.approx(expm + extract + schur)
    step = 2 * 2 + 4 * 2 + 4 * 2 + (lu(1) + 2 * 1 * 2) + 2
    assert W.doubling_step_ops(1, 1) == pytest.approx(step)
    d = W.Dims(nreg=1, nstream=1, columns=2, layers=3, bands=1, do_urban=True, itemsize=4)
    ops, nbytes = W.factory(d, lw=False, doublings=5)
    assert ops == pytest.approx(6 * (expm + extract + schur) + 5 * step)
    # in: g0, g1, g2, g3, dz; out: R, T, E, Sup, Sdn, int_diff, int_dir, int_dir_diff
    assert nbytes == 6 * (5 + 8) * 4


@pytest.mark.parametrize("nreg,do_urban", [(3, True), (2, False), (1, True)])
def test_sweep_outputs_are_the_references(nreg, do_urban):
    """The words the sweeps' count writes per layer and band, per column
    and layer, and per column and band, are the reference's outputs."""
    C, L, S = 2, 3, 2
    rng = np.random.default_rng(0)
    u = lambda *s: torch.as_tensor(rng.uniform(0.1, 0.3, s))
    inp = RS.CanopyInputs(
        dz=u(C, L) * 10, cos_sza=u(C) * 3, veg_fraction=u(C, L), veg_scale=u(C, L) * 100,
        veg_ext=u(C, L), veg_fsd=u(C, L), veg_contact_fraction=u(C, L),
        building_fraction=u(C, L), building_scale=u(C, L) * 100, air_ext=u(C, L, S) * 1e-3,
        air_ssa=u(C, L, S), veg_ssa=u(C, L, S), ground_albedo=u(C, S),
        ground_albedo_dir=u(C, S), roof_albedo=u(C, L, S), roof_albedo_dir=u(C, L, S),
        wall_albedo=u(C, L, S), wall_specular_frac=u(C, L, S))
    opt = RS.SolverOptions(nreg=nreg, nstream=4, do_urban=do_urban)
    d = W.Dims(nreg, 4, C, L, S, do_urban, 8)
    nd = 4 * nreg
    count = lambda shape, *outs: sum(tuple(v.shape) == shape for o in outs for v in o.values())
    sw = RS.spartacus_sw(inp, opt, LegendreGauss(4))
    # in: R, T, int_diff; E, int_dir; Sup, Sdn, int_dir_diff; 5 facet words
    words = (C * L * S * (3 * nd * nd + 2 * nreg**2 + 3 * nd * nreg + 5
                          + count((C, L, S), *sw[:2]))
             + C * S * count((C, S), *sw)
             + C * L * (4 * nreg * (nreg + 1) + count((C, L), *sw[:2])))
    assert W.sweeps(d, False)[1] == 8 * words
    lw_inp = {k: v for k, v in vars(inp).items()
              if v is not None and "albedo" not in k and "specular" not in k}
    lw = RS.spartacus_lw(RS.CanopyInputs(**lw_inp, **_lw_fields(C, L, S)), opt,
                         LegendreGauss(4))
    # in: R, T, int_diff; p, int_source; 6 facet and emission words
    words = (C * L * S * (3 * nd * nd + 2 * nd + 6 + count((C, L, S), *lw[:2]))
             + C * S * count((C, S), *lw) + C * L * 4 * nreg * (nreg + 1))
    assert W.sweeps(d, True)[1] == 8 * words


def _lw_fields(C, L, S):
    rng = np.random.default_rng(1)
    u = lambda *s: torch.as_tensor(rng.uniform(0.5, 0.9, s))
    return dict(ground_emissivity=u(C, S), ground_emission=u(C, S) * 400,
                roof_emissivity=u(C, L, S), roof_emission=u(C, L, S) * 400,
                wall_emissivity=u(C, L, S), wall_emission=u(C, L, S) * 400,
                clear_air_planck=u(C, L, S) * 400, veg_planck=u(C, L, S) * 400,
                veg_air_planck=u(C, L, S) * 400)


def _cell(name):
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    wl = next(w for w in spec["workloads"] if w["name"] == name)
    cfg = json.loads((BENCH.parent / next(c["file"] for c in spec["configs"]
                                          if c["name"] == wl["config"])).read_text())
    cfg["tiles"] = {k: max(2, v // 8192) for k, v in cfg["tiles"].items()}
    cfg["nlay"] = min(cfg["nlay"], 5)
    cfg["radsurf"] = dict(cfg["radsurf"], nsw=2, nlw=2)
    traffic = json.loads((BENCH / "traffic" / f"{wl['traffic']}.json").read_text())
    return cfg, traffic


@pytest.mark.parametrize("name", ["urban_mix.f32", "rami5.f64"])
def test_count_follows_from_the_inputs_alone(name):
    cfg, traffic = _cell(name)
    dtype = getattr(torch, traffic["dtype"])
    a = GEN.input_set(cfg, traffic, 123, 0)
    w = W.call_work(cfg["radsurf"], a, dtype, "cpu")
    # the same count in other blocks of columns, and with the columns in
    # another order
    assert W.call_work(cfg["radsurf"], a, dtype, "cpu", block=3) == w
    perm = np.random.default_rng(1).permutation(a["dz"].shape[0])
    assert W.call_work(cfg["radsurf"], {k: v[perm] for k, v in a.items()}, dtype, "cpu") == w
    assert all(w[s][0] > 0 and w[s][1] > 0 for s in W.STAGES)


def test_doubling_steps_are_the_programs_for_either_route():
    """The reference's doubling steps are those of the port's plain
    factory, which its scan route runs and its kernels are held to."""
    cfg, traffic = _cell("urban_mix.f32")
    a = GEN.input_set(cfg, traffic, 5, 1)
    rep = a["i_representation"]
    idx = np.nonzero(rep == GEN.TILE_CODES["VegetatedUrban"])[0]
    keys = {**R.dispatch.SW_KEYS, "ground_albedo_dir": "ground_albedo"}
    get = lambda cls: cls.CanopyInputs(**{f: torch.as_tensor(a[k][idx]) for f, k in keys.items()})
    opt_r = RS.SolverOptions(nreg=2, nstream=4, do_urban=True)
    opt_p = PS.SolverOptions(nreg=2, nstream=4, do_urban=True)
    gr = RS._sw_front(get(RS), opt_r, LegendreGauss(4))[-1]
    from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss as PLG
    gp = PS._sw_front(get(PS), opt_p, PLG(4))[-1]
    dz = torch.as_tensor(a["dz"][idx])[:, :, None].expand(gr[1].shape[:3])
    k_ref = R.layer_matrices.doubling_steps(W._gamma_dz(*gr, dz), 30)
    g_dz = W._gamma_dz(*gp, dz)
    nrm = g_dz.abs().sum(-1).amax(-1)
    k_prog = torch.clamp(torch.ceil(torch.log2(nrm.clamp_min(1e-30) / pade7_theta(g_dz.dtype))),
                         0, 30)
    assert torch.equal(k_ref, k_prog) and k_ref.sum() > 0
