"""[Frozen copy of the plain route of spartacus_surface_tpu_torch/models/
dispatch.run_radsurf: the tile groups, each group's solve (the scan
route for the layered tiles, the closed forms for flat and simple-urban
tiles) and the scatter into dense containers, without the host plan's
staging, CUDA graphs, meshes or column chunks.]

Parity: the per-column ``select case (i_representation)`` loop of
radsurf/radsurf_interface.F90:105-313.
"""

from __future__ import annotations

import numpy as np
import torch

from . import flat as flat_mod
from . import simple_urban as su_mod
from .legendre_gauss import LegendreGauss
from .solver import CanopyInputs, SolverOptions, spartacus_lw, spartacus_sw

# Tile representation codes (radsurf/radsurf_canopy_properties.F90:26-33)
TILE_FLAT = 0
TILE_FOREST = 1
TILE_URBAN = 2
TILE_VEGETATED_URBAN = 3
TILE_SIMPLE_URBAN = 4
TILE_INFINITE_STREET = 5
TILE_CODES = {"Flat": TILE_FLAT, "Forest": TILE_FOREST, "Urban": TILE_URBAN,
              "VegetatedUrban": TILE_VEGETATED_URBAN,
              "SimpleUrban": TILE_SIMPLE_URBAN,
              "InfiniteStreet": TILE_INFINITE_STREET}

# the &radsurf settings the solve reads, with the defaults of
# radsurf/radsurf_config.F90:32-113
DEFAULTS = dict(
    do_sw=True, do_lw=True, use_sw_direct_albedo=False,
    n_vegetation_region_forest=1, n_vegetation_region_urban=1, nsw=1, nlw=1,
    n_stream_sw_forest=4, n_stream_sw_urban=4, n_stream_lw_forest=4,
    n_stream_lw_urban=4, use_symmetric_vegetation_scale_forest=True,
    use_symmetric_vegetation_scale_urban=True,
    vegetation_isolation_factor_forest=0.0, vegetation_isolation_factor_urban=0.0,
    min_vegetation_fraction=1.0e-6, min_building_fraction=1.0e-6,
    do_save_flux_profile=False, n_double=30)

_COL_FIELDS = ("ground_dn", "ground_dn_dir", "ground_net",
               "ground_vertical_diff", "top_dn", "top_dn_dir", "top_net")
_LAY_FIELDS = ("roof_in", "roof_in_dir", "roof_net", "wall_in", "wall_in_dir",
               "wall_net", "clear_air_abs", "veg_abs", "veg_air_abs",
               "veg_abs_dir", "flux_dn_layer_top", "flux_dn_dir_layer_top",
               "flux_up_layer_top", "flux_dn_layer_base",
               "flux_dn_dir_layer_base", "flux_up_layer_base")
_SCAL_COL_FIELDS = ("ground_sunlit_frac",)
_SCAL_LAY_FIELDS = ("roof_sunlit_frac", "wall_sunlit_frac", "veg_sunlit_frac")

_SAME = ("dz", "cos_sza", "veg_fraction", "veg_scale", "veg_ext", "veg_fsd",
         "veg_contact_fraction", "building_fraction", "building_scale")
# CanopyInputs field -> arrays key, per band
SW_KEYS = {**{k: k for k in _SAME}, "air_ext": "sw_air_ext",
           "air_ssa": "sw_air_ssa", "veg_ssa": "sw_veg_ssa",
           **{k: k for k in ("ground_albedo", "roof_albedo", "roof_albedo_dir",
                             "wall_albedo", "wall_specular_frac")}}
LW_KEYS = {**{k: k for k in _SAME}, "air_ext": "lw_air_ext",
           "air_ssa": "lw_air_ssa", "veg_ssa": "lw_veg_ssa",
           **{k: k for k in ("ground_emissivity", "ground_emission",
                             "roof_emissivity", "roof_emission",
                             "wall_emissivity", "wall_emission",
                             "clear_air_planck", "veg_planck", "veg_air_planck")}}


def settings(radsurf: dict) -> dict:
    """DEFAULTS with a configuration's &radsurf values applied."""
    return {**DEFAULTS, **{k: v for k, v in radsurf.items() if k in DEFAULTS}}


def solver_groups(radsurf: dict) -> dict:
    """{layered tile code: (SolverOptions kwargs without nstream, SW
    streams, LW streams)}."""
    s = settings(radsurf)
    common = dict(min_vegetation_fraction=s["min_vegetation_fraction"],
                  min_building_fraction=s["min_building_fraction"],
                  n_double=s["n_double"])
    forest = dict(use_symmetric_vegetation_scale=s["use_symmetric_vegetation_scale_forest"],
                  vegetation_isolation_factor=s["vegetation_isolation_factor_forest"],
                  **common)
    urban = dict(use_symmetric_vegetation_scale=s["use_symmetric_vegetation_scale_urban"],
                 vegetation_isolation_factor=s["vegetation_isolation_factor_urban"],
                 **common)
    ns_u = (s["n_stream_sw_urban"], s["n_stream_lw_urban"])
    return {
        TILE_FOREST: (dict(nreg=s["n_vegetation_region_forest"] + 1, do_urban=False,
                           **forest), s["n_stream_sw_forest"], s["n_stream_lw_forest"]),
        TILE_URBAN: (dict(nreg=1, do_urban=True, **urban), *ns_u),
        TILE_VEGETATED_URBAN: (dict(nreg=s["n_vegetation_region_urban"] + 1,
                                    do_urban=True, **urban), *ns_u),
    }


def _empty_flux(ncol, nlay, nspec, **kw):
    """Dense canopy-flux container (cf. radsurf_canopy_flux.F90:27-91)."""
    out = {k: torch.zeros((ncol, nspec), **kw) for k in _COL_FIELDS}
    out.update({k: torch.zeros((ncol, nlay, nspec), **kw) for k in _LAY_FIELDS})
    out.update({k: torch.zeros((ncol,), **kw) for k in _SCAL_COL_FIELDS})
    out.update({k: torch.zeros((ncol, nlay), **kw) for k in _SCAL_LAY_FIELDS})
    return out


def _scatter(dst: dict, src: dict, idx, sun_up=None, layer0=False):
    """Write a group's outputs into the dense containers at columns idx;
    rows with the sun below the horizon zeroed (sun_up), per-layer fields
    of the single-layer tiles at layer 0 (layer0)."""
    for key, val in src.items():
        if key not in dst:
            continue
        if sun_up is not None:
            val = torch.where(sun_up.reshape((-1,) + (1,) * (val.ndim - 1)),
                              val, 0.0)
        if layer0 and (key in _LAY_FIELDS or key in _SCAL_LAY_FIELDS):
            dst[key][idx, 0] = val
        else:
            dst[key][idx] = val


def run_radsurf(radsurf: dict, arrays: dict, device, dtype) -> dict:
    """The surface radiation scheme on dense padded numpy arrays (the
    read_input format, with "i_representation" [C] and "nlay" [C]),
    computed in dtype on device.  radsurf: the &radsurf settings.
    Returns {"sw_norm_dir", "sw_norm_diff", "lw_internal", "lw_norm"} flux
    dicts (as do_sw / do_lw) and "bc_out", tensors on device."""
    s = settings(radsurf)
    rep = np.asarray(arrays["i_representation"])
    ncol, nlay = np.asarray(arrays["dz"]).shape
    nsw, nlw = s["nsw"], s["nlw"]
    kw = dict(dtype=dtype, device=device)
    get = lambda key, idx: torch.as_tensor(np.asarray(arrays[key])[idx], **kw)
    gdir = "ground_albedo_dir" if s["use_sw_direct_albedo"] else "ground_albedo"
    profiles = s["do_save_flux_profile"]
    bc = {}
    out = {"bc_out": bc}
    if s["do_sw"]:
        bc.update(sw_albedo=torch.zeros((ncol, nsw), **kw),
                  sw_albedo_dir=torch.zeros((ncol, nsw), **kw))
        out.update(sw_norm_dir=_empty_flux(ncol, nlay, nsw, **kw),
                   sw_norm_diff=_empty_flux(ncol, nlay, nsw, **kw))
    if s["do_lw"]:
        bc.update(lw_emissivity=torch.zeros((ncol, nlw), **kw),
                  lw_emission=torch.zeros((ncol, nlw), **kw))
        out.update(lw_internal=_empty_flux(ncol, nlay, nlw, **kw),
                   lw_norm=_empty_flux(ncol, nlay, nlw, **kw))

    # ---- flat tiles (radsurf_interface.F90:122-173)
    idx = np.nonzero(rep == TILE_FLAT)[0]
    if idx.size:
        tidx = torch.as_tensor(idx, device=device)
        if s["do_sw"]:
            nd, nf, fbc = flat_mod.flat_sw(get("ground_albedo", idx), get(gdir, idx))
            _scatter(out["sw_norm_dir"], nd, tidx)
            _scatter(out["sw_norm_diff"], nf, tidx)
            for key in ("sw_albedo", "sw_albedo_dir"):
                bc[key][tidx] = fbc[key]
        if s["do_lw"]:
            li, ln, fbc = flat_mod.flat_lw(get("ground_emissivity", idx),
                                           get("ground_emission", idx))
            _scatter(out["lw_internal"], li, tidx)
            _scatter(out["lw_norm"], ln, tidx)
            for key in ("lw_emissivity", "lw_emission"):
                bc[key][tidx] = fbc[key]

    # ---- layered SPARTACUS tiles
    for code, (opt_kw, ns_sw, ns_lw) in solver_groups(radsurf).items():
        idx = np.nonzero(rep == code)[0]
        if not idx.size:
            continue
        tidx = torch.as_tensor(idx, device=device)
        if s["do_sw"]:
            keys = {**SW_KEYS, "ground_albedo_dir": gdir}
            inp = CanopyInputs(**{f: get(key, idx) for f, key in keys.items()})
            ndir, ndiff, sbc = spartacus_sw(inp, SolverOptions(nstream=ns_sw, **opt_kw),
                                            LegendreGauss(ns_sw), with_profiles=profiles)
            sun_up = inp.cos_sza > 0.0
            _scatter(out["sw_norm_dir"], ndir, tidx, sun_up)
            _scatter(out["sw_norm_diff"], ndiff, tidx, sun_up)
            bc["sw_albedo"][tidx] = sbc["top_albedo_diff"]
            bc["sw_albedo_dir"][tidx] = sbc["top_albedo_dir"]
        if s["do_lw"]:
            inp = CanopyInputs(**{f: get(key, idx) for f, key in LW_KEYS.items()})
            lint, lnorm, lbc = spartacus_lw(inp, SolverOptions(nstream=ns_lw, **opt_kw),
                                            LegendreGauss(ns_lw), with_profiles=profiles)
            _scatter(out["lw_internal"], lint, tidx)
            _scatter(out["lw_norm"], lnorm, tidx)
            bc["lw_emissivity"][tidx] = lbc["top_emissivity"]
            bc["lw_emission"][tidx] = lbc["top_emission"]

    # ---- simple urban / infinite street (radsurf_interface.F90:272-309)
    idx = np.nonzero(np.isin(rep, [TILE_SIMPLE_URBAN, TILE_INFINITE_STREET]))[0]
    if idx.size:
        if np.any(np.asarray(arrays["nlay"])[idx] != 1):
            raise ValueError("simple urban representations must have only one layer")
        tidx = torch.as_tensor(idx, device=device)
        lay0 = lambda key: get(key, idx)[:, 0]
        geom = (lay0("dz"), lay0("building_fraction"), lay0("building_scale"))
        is_inf = torch.as_tensor(rep[idx] == TILE_INFINITE_STREET, device=device)
        opts = dict(min_building_fraction=s["min_building_fraction"],
                    with_profiles=profiles)
        if s["do_sw"]:
            cos_sza = get("cos_sza", idx)
            ndir, ndiff, sbc = su_mod.simple_urban_sw(
                *geom, cos_sza, is_inf, get("ground_albedo", idx), get(gdir, idx),
                lay0("roof_albedo"), lay0("wall_albedo"), **opts)
            sun_up = cos_sza > 0.0
            _scatter(out["sw_norm_dir"], ndir, tidx, sun_up, layer0=True)
            _scatter(out["sw_norm_diff"], ndiff, tidx, sun_up, layer0=True)
            for key in ("sw_albedo", "sw_albedo_dir"):
                bc[key][tidx] = sbc[key]
        if s["do_lw"]:
            lint, lnorm, lbc = su_mod.simple_urban_lw(
                *geom, is_inf, get("ground_emissivity", idx), get("ground_emission", idx),
                lay0("roof_emissivity"), lay0("roof_emission"),
                lay0("wall_emissivity"), lay0("wall_emission"), **opts)
            _scatter(out["lw_internal"], lint, tidx, layer0=True)
            _scatter(out["lw_norm"], lnorm, tidx, layer0=True)
            for key in ("lw_emissivity", "lw_emission"):
                bc[key][tidx] = lbc[key]
    return out
