"""run_radsurf (do_lw = False; do_lw = True is in tests/test_torch_lw.py) and
the flux utilities of the port against the JAX package, float64 on the CPU,
on __graft_entry__._example_arrays (every tile type: Flat, Forest, Urban,
VegetatedUrban, SimpleUrban, InfiniteStreet).  Tolerance 1e-9
field-normalized (bench.py:115-133)."""

import functools

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from spartacus_surface_tpu.models import flux_utils as JFU
from spartacus_surface_tpu.models.dispatch import run_radsurf as jax_run
from spartacus_surface_tpu.utils.config import Config as JConfig
from spartacus_surface_tpu_torch.models import flux_utils as TFU
from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.inputs import example_arrays, example_inputs

GROUPS = ("sw_norm_dir", "sw_norm_diff", "bc_out")


def arrays(sun_down=False):
    a = example_arrays(C=12, L=3, S=2, dtype=np.float64)
    if sun_down:
        a["cos_sza"][[1, 3, 4]] = -0.2  # forest, vegetated urban, simple urban
    return a


@functools.lru_cache(maxsize=None)
def jax_out(profiles, direct_albedo, sun_down):
    cfg = JConfig(do_lw=False, nsw=2, do_save_flux_profile=profiles,
                  use_sw_direct_albedo=direct_albedo).consolidate()
    return jax_run(cfg, arrays(sun_down))


def field_err(ref, got):
    worst = 0.0
    for g in GROUPS:
        assert set(ref[g]) == set(got[g]), set(ref[g]) ^ set(got[g])
        for k in ref[g]:
            r, x = np.asarray(ref[g][k]), got[g][k].numpy()
            assert r.shape == x.shape and np.isfinite(x).all(), (g, k)
            worst = max(worst, np.abs(r - x).max() / max(1.0, np.abs(r).max()))
    return worst


def test_example_builders_match_graft_entry():
    ref = graft._example_arrays(C=12, L=3, S=2, dtype=np.float64)
    got = example_arrays(C=12, L=3, S=2, dtype=np.float64)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    sw, lw = graft._example_inputs(C=5, L=3, S=2, dtype=np.float32, lw=True)
    for ref, flag in ((sw, False), (lw, True)):
        got = example_inputs(C=5, L=3, S=2, dtype=np.float32, lw=flag)
        assert set(got) == {k for k, v in vars(ref).items() if v is not None}
        for k, v in got.items():
            np.testing.assert_array_equal(v, getattr(ref, k), err_msg=k)


@pytest.mark.parametrize("route", ["kernel", "scan"])
@pytest.mark.parametrize("profiles,direct_albedo,sun_down", [
    (False, False, False), (True, True, False), (False, False, True)])
def test_run_radsurf_matches_jax(route, profiles, direct_albedo, sun_down):
    cfg = Config(do_lw=False, nsw=2, do_save_flux_profile=profiles,
                 use_sw_direct_albedo=direct_albedo).consolidate()
    got = run_radsurf(cfg, arrays(sun_down), "cpu", route=route)
    assert field_err(jax_out(profiles, direct_albedo, sun_down), got) < 1e-9


def test_flux_utils_match_jax():
    a = arrays()
    cfg = Config(do_lw=False, nsw=2).consolidate()
    out = run_radsurf(cfg, a, "cpu")
    ref = jax_out(False, False, False)
    rng = np.random.default_rng(0)
    factor = rng.uniform(100.0, 900.0, (12, 2))
    scaled = TFU.scale_flux(out["sw_norm_dir"], torch.as_tensor(factor))
    jscaled = JFU.scale_flux({k: np.asarray(v) for k, v in ref["sw_norm_dir"].items()},
                             factor)
    total = TFU.sum_flux(scaled, out["sw_norm_diff"])
    jtotal = JFU.sum_flux(jscaled, {k: np.asarray(v) for k, v
                                    in ref["sw_norm_diff"].items()})
    for k in jtotal:
        np.testing.assert_allclose(total[k].numpy(), jtotal[k], rtol=1e-9,
                                   atol=1e-9, err_msg=k)
    lines = []
    res = TFU.check_flux(total, a, "sw", printer=lines.append)
    jres = JFU.check_flux(jtotal, a, "sw", printer=lambda *_: None)
    np.testing.assert_allclose(res, jres, atol=1e-9)
    assert np.abs(res).max() < 1e-9 and len(lines) == 13
