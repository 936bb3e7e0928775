"""Tile-type dispatch: buckets columns by representation, solves each group
and scatters its outputs into dense [C, ...] tensors on the device.

Port of spartacus_surface_tpu/models/dispatch.py ``run_radsurf`` /
``_radsurf_core`` (shortwave and longwave).
Parity: the per-column ``select case (i_representation)`` loop of
radsurf/radsurf_interface.F90:105-313.

Device meshes: pass ``mesh=`` (a list of devices, parallel/mesh.py) and each
layered group's columns are split over its entries, each shard solved on its
own device (``column_chunk`` applying per shard, as under JAX's
``shard_map``: AUTO reads the budget of the shard's own device), then
gathered on ``device``.  Every shard's work is issued
before any result is moved, so several cards overlap.  The closed-form flat
and simple-urban tiles run on ``device`` unsharded, as in JAX.  The shards
may be unequal, so no group is padded to a device multiple (JAX
``_pad_group``); the outputs are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import column_sharding, tree_map
from ..utils.config import Config
from ..utils import device_memory as DM
from ..utils.convert import torch_dtype
from ..utils.transfer import to_device
from . import flat as flat_mod
from . import simple_urban as su_mod
from .solver import (CanopyInputs, SolverOptions, debug_dump_sw, spartacus_lw,
                     spartacus_sw)

# Tile representation codes (radsurf/radsurf_canopy_properties.F90:26-33)
TILE_FLAT = 0
TILE_FOREST = 1
TILE_URBAN = 2
TILE_VEGETATED_URBAN = 3
TILE_SIMPLE_URBAN = 4
TILE_INFINITE_STREET = 5
TILE_NAMES = {
    TILE_FLAT: "Flat",
    TILE_FOREST: "Forest",
    TILE_URBAN: "Urban",
    TILE_VEGETATED_URBAN: "VegetatedUrban",
    TILE_SIMPLE_URBAN: "SimpleUrban",
    TILE_INFINITE_STREET: "InfiniteStreet",
}

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
    """Layered SPARTACUS tile codes -> (SolverOptions kwargs without
    nstream, lg_sw, lg_lw): each band's solve takes nstream from its own
    quadrature, and the SW and LW stream counts may differ."""
    common = dict(min_vegetation_fraction=config.min_vegetation_fraction,
                  min_building_fraction=config.min_building_fraction,
                  n_double=config.n_double, column_chunk=config.column_chunk)
    forest = dict(
        use_symmetric_vegetation_scale=config.use_symmetric_vegetation_scale_forest,
        vegetation_isolation_factor=config.vegetation_isolation_factor_forest,
        **common)
    urban = dict(
        use_symmetric_vegetation_scale=config.use_symmetric_vegetation_scale_urban,
        vegetation_isolation_factor=config.vegetation_isolation_factor_urban,
        **common)
    lgu = (config.lg_sw_urban, config.lg_lw_urban)
    return {
        TILE_FOREST: (dict(nreg=config.n_vegetation_region_forest + 1,
                           do_urban=False, **forest),
                      config.lg_sw_forest, config.lg_lw_forest),
        TILE_URBAN: (dict(nreg=1, do_urban=True, **urban), *lgu),
        TILE_VEGETATED_URBAN: (dict(nreg=config.n_vegetation_region_urban + 1,
                                    do_urban=True, **urban), *lgu),
    }


def working_set_bytes(config: Config, i_representation, nlay: int,
                      itemsize: int) -> int:
    """The working-set model (utils/device_memory.py) of one one-shot
    run_radsurf call on the kernel route: columns of the tile codes
    i_representation [ncol] with nlay layers, a consolidated Config, words of
    itemsize bytes.  The layered groups are solved one after another and
    every group's outputs are kept until all are scattered, so the peak is
    the flux containers of every column, the outputs kept so far, and one
    solve's inputs and transient, the largest of them."""
    rep = np.asarray(i_representation)
    ncol = rep.size
    bands = ([(False, config.nswinternal)] if config.do_sw else []) + (
        [(True, config.nlwinternal)] if config.do_lw else [])
    fixed = sum(2 * DM.class_bytes(DM.CONTAINER_WORDS, ncol, nlay, S, itemsize)
                for _, S in bands)
    kept = peak = 0
    for code, (opt_kw, lg_sw, lg_lw) in _solver_groups(config).items():
        C = int((rep == code).sum())
        for lw, S in bands if C else ():
            t, k = DM.solve_bytes(C, nlay, S, opt_kw["nreg"],
                                  (lg_lw if lw else lg_sw).nstream, itemsize,
                                  lw=lw, do_urban=opt_kw["do_urban"],
                                  with_profiles=config.do_save_flux_profile)
            inputs = DM.class_bytes(DM.INPUT_WORDS[lw], C, nlay, S, itemsize)
            peak = max(peak, kept + inputs + t)
            kept += k
    return fixed + peak


def _same(*names):
    return {k: k for k in names}


# CanopyInputs field -> arrays key, per band (JAX _gather_inputs)
_COMMON_KEYS = _same("dz", "cos_sza", "veg_fraction", "veg_scale", "veg_ext",
                     "veg_fsd", "veg_contact_fraction", "building_fraction",
                     "building_scale")
_SW_KEYS = dict(
    _COMMON_KEYS, air_ext="sw_air_ext", air_ssa="sw_air_ssa",
    veg_ssa="sw_veg_ssa",
    **_same("ground_albedo", "roof_albedo", "roof_albedo_dir", "wall_albedo",
            "wall_specular_frac"))
_LW_KEYS = dict(
    _COMMON_KEYS, air_ext="lw_air_ext", air_ssa="lw_air_ssa",
    veg_ssa="lw_veg_ssa",
    **_same("ground_emissivity", "ground_emission", "roof_emissivity",
            "roof_emission", "wall_emissivity", "wall_emission",
            "clear_air_planck", "veg_planck", "veg_air_planck"))


def run_radsurf(config: Config, arrays: dict, device, route: str = "kernel",
                mesh=None):
    """Run the surface radiation scheme on dense padded arrays.

    Args:
      config: consolidated Config.
      arrays: dict of dense padded numpy arrays in the JAX package's
        read_input format, plus "i_representation" [C] and "nlay" [C].  The working
        dtype is that of arrays["dz"].  A field may be a torch tensor
        instead: it is indexed on the device, and the outputs keep its
        autograd graph (gradients through the kernel route are the scan
        route's, solver._KernelRouteGrad).
      device: the torch device to solve on; CUDA runs the layered solves on
        the CUDA kernels.
      route: "kernel" or "scan" for the layered solves (see spartacus_sw,
        spartacus_lw).
      mesh: optional list of devices (parallel/mesh.make_mesh): the layered
        groups' columns are split over it, each shard solved on its entry.

    Returns {"sw_norm_dir", "sw_norm_diff"} (with do_sw) and {"lw_internal",
    "lw_norm"} (with do_lw) flux dicts, and "bc_out": {"sw_albedo",
    "sw_albedo_dir"} / {"lw_emissivity", "lw_emission"}, tensors on
    `device`.  Parity: radsurf() radsurf/radsurf_interface.F90:20-317.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    rep = np.asarray(arrays["i_representation"])
    dz = arrays["dz"]
    ncol, nlay = dz.shape
    kw = dict(dtype=dz.dtype if isinstance(dz, torch.Tensor)
              else torch_dtype(np.asarray(dz).dtype), device=device)

    def get(key, idx, dev=device):
        """The columns idx of arrays[key] on dev: a tensor is indexed there
        (its autograd graph kept), a numpy array sliced on the host."""
        x = arrays[key]
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=kw["dtype"])[to_device(idx, dev)]
        return to_device(np.asarray(x)[idx], dev, kw["dtype"])

    # AUTO column chunks: each solve may plan for the budget its device had
    # when the run began, less what the run has allocated there since (the
    # flux containers, earlier groups' outputs), so that the run as a whole
    # stays within that budget
    start = {d: (DM.device_budget(d), torch.cuda.memory_allocated(d))
             for d in {device, *(mesh or ())}
             if d.type == "cuda" and config.column_chunk == -1}

    def budget_left(dev):
        if dev not in start:
            return None
        budget, allocated = start[dev]
        return budget - (torch.cuda.memory_allocated(dev) - allocated)

    bc = {}
    out = {"bc_out": bc}
    nsw, nlw = config.nswinternal, config.nlwinternal
    if config.do_sw:
        bc.update(sw_albedo=torch.zeros((ncol, nsw), **kw),
                  sw_albedo_dir=torch.zeros((ncol, nsw), **kw))
        out.update(sw_norm_dir=_empty_flux(ncol, nlay, nsw, **kw),
                   sw_norm_diff=_empty_flux(ncol, nlay, nsw, **kw))
    if config.do_lw:
        bc.update(lw_emissivity=torch.zeros((ncol, nlw), **kw),
                  lw_emission=torch.zeros((ncol, nlw), **kw))
        out.update(lw_internal=_empty_flux(ncol, nlay, nlw, **kw),
                   lw_norm=_empty_flux(ncol, nlay, nlw, **kw))
    gdir = "ground_albedo_dir" if config.use_sw_direct_albedo else "ground_albedo"

    # ---- flat tiles (radsurf_interface.F90:122-173)
    idx = np.nonzero(rep == TILE_FLAT)[0]
    if idx.size:
        tidx = to_device(idx, device)
        if config.do_sw:
            nd, nf, fbc = flat_mod.flat_sw(get("ground_albedo", idx), get(gdir, idx))
            _scatter(out["sw_norm_dir"], nd, tidx)
            _scatter(out["sw_norm_diff"], nf, tidx)
            for key in ("sw_albedo", "sw_albedo_dir"):
                bc[key][tidx] = fbc[key]
        if config.do_lw:
            li, ln, fbc = flat_mod.flat_lw(get("ground_emissivity", idx),
                                           get("ground_emission", idx))
            _scatter(out["lw_internal"], li, tidx)
            _scatter(out["lw_norm"], ln, tidx)
            for key in ("lw_emissivity", "lw_emission"):
                bc[key][tidx] = fbc[key]

    # ---- layered SPARTACUS tiles: every shard's solves are issued first,
    # then their results gathered on `device` and scattered
    solved = []
    for code, (opt_kw, lg_sw, lg_lw) in _solver_groups(config).items():
        idx = np.nonzero(rep == code)[0]
        if not idx.size:
            continue
        shards = ([(dev, idx[sl]) for dev, sl in column_sharding(idx.size, mesh)
                   if sl.stop > sl.start] if mesh else [(device, idx)])
        for k, (dev, sidx) in enumerate(shards):
            sw = lw = None
            if config.do_sw:
                keys = {**_SW_KEYS, "ground_albedo_dir": gdir}
                inp = CanopyInputs(**{f: get(key, sidx, dev) for f, key in keys.items()})
                opt = SolverOptions(nstream=lg_sw.nstream, **opt_kw)
                if k == 0:  # prints the group's first column under SPARTACUS_DEBUG_ARRAYS
                    debug_dump_sw(inp, opt, lg_sw)
                sw = (inp.cos_sza > 0.0, spartacus_sw(
                    inp, opt, lg_sw, with_profiles=config.do_save_flux_profile,
                    route=route, budget=budget_left(dev)))
            if config.do_lw:  # not masked by sun_up
                inp = CanopyInputs(**{f: get(key, sidx, dev) for f, key in _LW_KEYS.items()})
                lw = spartacus_lw(
                    inp, SolverOptions(nstream=lg_lw.nstream, **opt_kw), lg_lw,
                    with_profiles=config.do_save_flux_profile, route=route,
                    budget=budget_left(dev))
            solved.append((sidx, sw, lw))
    for sidx, sw, lw in solved:
        tidx = to_device(sidx, device)
        sw, lw = tree_map(lambda t: t.to(device), (sw, lw))
        if sw is not None:
            sun_up, (ndir, ndiff, sbc) = sw
            _scatter(out["sw_norm_dir"], ndir, tidx, sun_up)
            _scatter(out["sw_norm_diff"], ndiff, tidx, sun_up)
            bc["sw_albedo"][tidx] = sbc["top_albedo_diff"]
            bc["sw_albedo_dir"][tidx] = sbc["top_albedo_dir"]
        if lw is not None:
            lint, lnorm, lbc = lw
            _scatter(out["lw_internal"], lint, tidx)
            _scatter(out["lw_norm"], lnorm, tidx)
            bc["lw_emissivity"][tidx] = lbc["top_emissivity"]
            bc["lw_emission"][tidx] = lbc["top_emission"]

    # ---- simple urban / infinite street (radsurf_interface.F90:272-309)
    idx = np.nonzero(np.isin(rep, [TILE_SIMPLE_URBAN, TILE_INFINITE_STREET]))[0]
    if idx.size:
        if np.any(np.asarray(arrays["nlay"])[idx] != 1):
            raise ValueError(
                "simple urban representations must have only one layer")
        lay0 = lambda key: get(key, idx)[:, 0]
        geom = (lay0("dz"), lay0("building_fraction"), lay0("building_scale"))
        is_inf = to_device(rep[idx] == TILE_INFINITE_STREET, device)
        tidx = to_device(idx, device)
        opts = dict(min_building_fraction=config.min_building_fraction,
                    with_profiles=config.do_save_flux_profile)
        if config.do_sw:
            ndir, ndiff, sbc = su_mod.simple_urban_sw(
                *geom, get("cos_sza", idx), is_inf, get("ground_albedo", idx),
                get(gdir, idx), lay0("roof_albedo"), lay0("wall_albedo"), **opts)
            sun_up = get("cos_sza", idx) > 0.0
            _scatter(out["sw_norm_dir"], ndir, tidx, sun_up, layer0=True)
            _scatter(out["sw_norm_diff"], ndiff, tidx, sun_up, layer0=True)
            for key in ("sw_albedo", "sw_albedo_dir"):
                bc[key][tidx] = sbc[key]
        if config.do_lw:
            lint, lnorm, lbc = su_mod.simple_urban_lw(
                *geom, is_inf, get("ground_emissivity", idx),
                get("ground_emission", idx), lay0("roof_emissivity"),
                lay0("roof_emission"), lay0("wall_emissivity"),
                lay0("wall_emission"), **opts)
            _scatter(out["lw_internal"], lint, tidx, layer0=True)
            _scatter(out["lw_norm"], lnorm, tidx, layer0=True)
            for key in ("lw_emissivity", "lw_emission"):
                bc[key][tidx] = lbc[key]
    return out
