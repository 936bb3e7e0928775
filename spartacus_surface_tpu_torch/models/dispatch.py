"""Tile-type dispatch: buckets columns by representation, solves each group
and scatters its outputs into dense [C, ...] tensors on the device.

Port of spartacus_surface_tpu/models/dispatch.py ``run_radsurf`` /
``_radsurf_core`` for the shortwave (``do_lw = False``) on one device.
Parity: the per-column ``select case (i_representation)`` loop of
radsurf/radsurf_interface.F90:105-313.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import Config
from ..utils.convert import torch_dtype
from . import flat as flat_mod
from . import simple_urban as su_mod
from .solver import CanopyInputs, SolverOptions, spartacus_sw

# Tile representation codes (radsurf/radsurf_canopy_properties.F90:26-33)
TILE_FLAT = 0
TILE_FOREST = 1
TILE_URBAN = 2
TILE_VEGETATED_URBAN = 3
TILE_SIMPLE_URBAN = 4
TILE_INFINITE_STREET = 5

_COL_FIELDS = ("ground_dn", "ground_dn_dir", "ground_net",
               "ground_vertical_diff", "top_dn", "top_dn_dir", "top_net")
_LAY_FIELDS = ("roof_in", "roof_in_dir", "roof_net", "wall_in", "wall_in_dir",
               "wall_net", "clear_air_abs", "veg_abs", "veg_air_abs",
               "veg_abs_dir", "flux_dn_layer_top", "flux_dn_dir_layer_top",
               "flux_up_layer_top", "flux_dn_layer_base",
               "flux_dn_dir_layer_base", "flux_up_layer_base")
_SCAL_COL_FIELDS = ("ground_sunlit_frac",)
_SCAL_LAY_FIELDS = ("roof_sunlit_frac", "wall_sunlit_frac", "veg_sunlit_frac")


def _empty_flux(ncol, nlay, nspec, **kw):
    """Dense canopy-flux container (cf. radsurf_canopy_flux.F90:27-91)."""
    out = {k: torch.zeros((ncol, nspec), **kw) for k in _COL_FIELDS}
    out.update({k: torch.zeros((ncol, nlay, nspec), **kw) for k in _LAY_FIELDS})
    out.update({k: torch.zeros((ncol,), **kw) for k in _SCAL_COL_FIELDS})
    out.update({k: torch.zeros((ncol, nlay), **kw) for k in _SCAL_LAY_FIELDS})
    return out


def _scatter(dst: dict, src: dict, idx, sun_up=None, layer0=False):
    """Write a group's outputs into the dense containers at columns idx.

    sun_up: rows with the sun below the horizon are zeroed (the reference
    skips the SW solve then, radsurf_interface.F90:183,217,248).
    layer0: simple-urban outputs have no layer axis; per-layer fields go to
    layer 0.
    """
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


def _solver_groups(config: Config):
    """Layered SPARTACUS tile codes -> (SolverOptions, lg_sw)."""
    common = dict(min_vegetation_fraction=config.min_vegetation_fraction,
                  min_building_fraction=config.min_building_fraction,
                  n_double=config.n_double, column_chunk=config.column_chunk)
    forest = dict(
        use_symmetric_vegetation_scale=config.use_symmetric_vegetation_scale_forest,
        vegetation_isolation_factor=config.vegetation_isolation_factor_forest)
    urban = dict(
        use_symmetric_vegetation_scale=config.use_symmetric_vegetation_scale_urban,
        vegetation_isolation_factor=config.vegetation_isolation_factor_urban)
    lgf, lgu = config.lg_sw_forest, config.lg_sw_urban
    return {
        TILE_FOREST: (SolverOptions(
            nreg=config.n_vegetation_region_forest + 1, nstream=lgf.nstream,
            do_urban=False, **forest, **common), lgf),
        TILE_URBAN: (SolverOptions(
            nreg=1, nstream=lgu.nstream, do_urban=True, **urban, **common), lgu),
        TILE_VEGETATED_URBAN: (SolverOptions(
            nreg=config.n_vegetation_region_urban + 1, nstream=lgu.nstream,
            do_urban=True, **urban, **common), lgu),
    }


_SW_KEYS = dict(
    dz="dz", cos_sza="cos_sza", veg_fraction="veg_fraction",
    veg_scale="veg_scale", veg_ext="veg_ext", veg_fsd="veg_fsd",
    veg_contact_fraction="veg_contact_fraction",
    building_fraction="building_fraction", building_scale="building_scale",
    air_ext="sw_air_ext", air_ssa="sw_air_ssa", veg_ssa="sw_veg_ssa",
    ground_albedo="ground_albedo", roof_albedo="roof_albedo",
    roof_albedo_dir="roof_albedo_dir", wall_albedo="wall_albedo",
    wall_specular_frac="wall_specular_frac",
)


def run_radsurf(config: Config, arrays: dict, device, route: str = "kernel"):
    """Run the surface radiation scheme (shortwave) on dense padded arrays.

    Args:
      config: consolidated Config with do_lw = False (the LW solver is not
        ported yet; do_lw = True raises).
      arrays: dict of dense padded numpy arrays in the JAX package's
        read_input format, plus "i_representation" [C] and "nlay" [C].  The working
        dtype is that of arrays["dz"].
      device: the torch device to solve on; CUDA runs the layered solve on
        the CUDA kernels.
      route: "kernel" or "scan" for the layered solve (see spartacus_sw).

    Returns {"sw_norm_dir", "sw_norm_diff": flux dicts, "bc_out":
    {"sw_albedo", "sw_albedo_dir"}}, tensors on `device`.
    Parity: radsurf() radsurf/radsurf_interface.F90:20-317.
    """
    if config.do_lw:
        raise NotImplementedError(
            "the longwave solver is not ported yet: run with do_lw = False")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    rep = np.asarray(arrays["i_representation"])
    dz = np.asarray(arrays["dz"])
    ncol, nlay = dz.shape
    kw = dict(dtype=torch_dtype(dz.dtype), device=device)

    def get(key, idx):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(arrays[key])[idx]),
                               **kw)

    if not config.do_sw:
        return {"bc_out": {}}
    nsw = config.nswinternal
    bc = {"sw_albedo": torch.zeros((ncol, nsw), **kw),
          "sw_albedo_dir": torch.zeros((ncol, nsw), **kw)}
    out = {"sw_norm_dir": _empty_flux(ncol, nlay, nsw, **kw),
           "sw_norm_diff": _empty_flux(ncol, nlay, nsw, **kw), "bc_out": bc}
    gdir = "ground_albedo_dir" if config.use_sw_direct_albedo else "ground_albedo"

    # ---- flat tiles (radsurf_interface.F90:122-173)
    idx = np.nonzero(rep == TILE_FLAT)[0]
    if idx.size:
        nd, nf, fbc = flat_mod.flat_sw(get("ground_albedo", idx), get(gdir, idx))
        tidx = torch.as_tensor(idx, device=device)
        _scatter(out["sw_norm_dir"], nd, tidx)
        _scatter(out["sw_norm_diff"], nf, tidx)
        for key in bc:
            bc[key][tidx] = fbc[key]

    # ---- layered SPARTACUS tiles
    for code, (opt, lg) in _solver_groups(config).items():
        idx = np.nonzero(rep == code)[0]
        if not idx.size:
            continue
        keys = {**_SW_KEYS, "ground_albedo_dir": gdir}
        inp = CanopyInputs(**{f: get(k, idx) for f, k in keys.items()})
        ndir, ndiff, sbc = spartacus_sw(
            inp, opt, lg, with_profiles=config.do_save_flux_profile, route=route)
        tidx = torch.as_tensor(idx, device=device)
        sun_up = inp.cos_sza > 0.0
        _scatter(out["sw_norm_dir"], ndir, tidx, sun_up)
        _scatter(out["sw_norm_diff"], ndiff, tidx, sun_up)
        bc["sw_albedo"][tidx] = sbc["top_albedo_diff"]
        bc["sw_albedo_dir"][tidx] = sbc["top_albedo_dir"]

    # ---- simple urban / infinite street (radsurf_interface.F90:272-309)
    idx = np.nonzero(np.isin(rep, [TILE_SIMPLE_URBAN, TILE_INFINITE_STREET]))[0]
    if idx.size:
        if np.any(np.asarray(arrays["nlay"])[idx] != 1):
            raise ValueError(
                "simple urban representations must have only one layer")
        lay0 = lambda key: get(key, idx)[:, 0]
        ndir, ndiff, sbc = su_mod.simple_urban_sw(
            lay0("dz"), lay0("building_fraction"), lay0("building_scale"),
            get("cos_sza", idx),
            torch.as_tensor(rep[idx] == TILE_INFINITE_STREET, device=device),
            get("ground_albedo", idx), get(gdir, idx), lay0("roof_albedo"),
            lay0("wall_albedo"),
            min_building_fraction=config.min_building_fraction,
            with_profiles=config.do_save_flux_profile)
        tidx = torch.as_tensor(idx, device=device)
        sun_up = get("cos_sza", idx) > 0.0
        _scatter(out["sw_norm_dir"], ndir, tidx, sun_up, layer0=True)
        _scatter(out["sw_norm_diff"], ndiff, tidx, sun_up, layer0=True)
        for key in bc:
            bc[key][tidx] = sbc[key]
    return out
