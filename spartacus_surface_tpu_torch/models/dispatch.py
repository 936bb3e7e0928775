"""Tile-type dispatch: buckets columns by representation, solves each group
and scatters its outputs into dense [C, ...] tensors on the device.

Port of spartacus_surface_tpu/models/dispatch.py ``run_radsurf`` /
``_radsurf_core`` (shortwave and longwave).
Parity: the per-column ``select case (i_representation)`` loop of
radsurf/radsurf_interface.F90:105-313.

As in JAX, a call is a host plan (_plan: the tile groups, their indices,
each group's fields, the AUTO column chunks) and a device core
(_core: the flux containers, every solve and scatter), which on the kernel
route runs as a compiled program: a CUDA graph per (plan, shapes, dtype,
device), utils/graphs.py.

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

import contextlib
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.legendre_gauss import LegendreGauss
from ..parallel.mesh import column_sharding, tree_leaves, tree_map
from ..utils.config import Config
from ..utils import device_memory as DM
from ..utils import graphs, profiling
from ..utils.convert import torch_dtype
from ..utils.transfer import to_device
from . import flat as flat_mod
from . import simple_urban as su_mod
from . import solver
from .solver import (CanopyInputs, SolverOptions, _needs_grad, debug_dump_sw,
                     spartacus_lw, spartacus_sw)

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
    itemsize bytes.  Every solve's inputs are on the device before the core
    runs (_plan), the layered groups are solved one after another and every
    group's outputs are kept until all are scattered, so the peak is the
    flux containers of every column, the inputs of every solve, the outputs
    kept so far, and one solve's transient, the largest of them."""
    rep = np.asarray(i_representation)
    ncol = rep.size
    bands = ([(False, config.nswinternal)] if config.do_sw else []) + (
        [(True, config.nlwinternal)] if config.do_lw else [])
    fixed = sum(2 * DM.class_bytes(DM.CONTAINER_WORDS, ncol, nlay, S, itemsize)
                for _, S in bands)
    inputs = kept = peak = 0
    for code, (opt_kw, lg_sw, lg_lw) in _solver_groups(config).items():
        C = int((rep == code).sum())
        for lw, S in bands if C else ():
            t, k = DM.solve_bytes(C, nlay, S, opt_kw["nreg"],
                                  (lg_lw if lw else lg_sw).nstream, itemsize,
                                  lw=lw, do_urban=opt_kw["do_urban"],
                                  with_profiles=config.do_save_flux_profile)
            inputs += DM.class_bytes(DM.INPUT_WORDS[lw], C, nlay, S, itemsize)
            peak = max(peak, kept + t)
            kept += k
    return fixed + inputs + peak


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

    The host plan (_plan: tile groups, indices, each group's fields, AUTO
    column chunks) runs at every call; the device core (_core: every solve
    and scatter) is a compiled program (utils/graphs.py; JAX
    _radsurf_core): on CUDA a CUDA graph per (plan, shapes, dtype, device),
    captured at the second call and replayed from then on, on the kernel
    route, its fields moved with one transfer a dtype.  It runs eagerly on
    the CPU, under graphs.disabled(), where an input needs a gradient, with
    a mesh, and on the scan route (the plain reference: its factory reads
    its doubling count on the host).

    Returns {"sw_norm_dir", "sw_norm_diff"} (with do_sw) and {"lw_internal",
    "lw_norm"} (with do_lw) flux dicts, and "bc_out": {"sw_albedo",
    "sw_albedo_dir"} / {"lw_emissivity", "lw_emission"}, tensors on
    `device`.  Parity: radsurf() radsurf/radsurf_interface.F90:20-317.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    compiled = route == "kernel" and not mesh and not any(
        _needs_grad(x) for x in arrays.values() if isinstance(x, torch.Tensor))
    with profiling.hook("dispatch.plan"):
        plan, payload = _plan(config, arrays, device, route, mesh, host=compiled)
    if not compiled:
        with graphs.disabled() if mesh else contextlib.nullcontext():
            return _core(plan, payload)
    skeleton = tree_map(lambda _: 0, payload)

    def core(*xs):
        it = iter(xs)
        return _core(plan, tree_map(lambda _: next(it), skeleton))
    return graphs.call(plan, core, tree_leaves(payload), device=device, need=plan.need)


@functools.lru_cache(maxsize=None)
def _lg(nstream: int) -> LegendreGauss:
    return LegendreGauss(nstream)


@dataclass(frozen=True)
class Plan:
    """The static part of a run_radsurf call (_plan), which keys its core's
    graph.  flat / simple: whether those tile groups exist; layered: per
    layered group (nstream_sw, nstream_lw, ((shard device, opt_sw or None,
    opt_lw or None), ...)), the options with their column chunks resolved;
    need: the bytes the core allocates beyond its inputs (the working-set
    model: the flux containers, the solves' outputs kept, the largest
    solve's transient), which follows from the rest."""
    ncol: int
    nlay: int
    nsw: int
    nlw: int
    do_sw: bool
    do_lw: bool
    profiles: bool
    min_building_fraction: float
    route: str
    device: torch.device
    dtype: torch.dtype
    flat: bool
    layered: tuple
    simple: bool
    need: int = field(default=0, compare=False)


def _plan(config: Config, arrays: dict, device, route: str, mesh, host: bool = False):
    """The host half of run_radsurf (JAX run_radsurf before _radsurf_core):
    the tile groups, their column indices and fields, and each layered
    solve's options with its column chunk resolved.  host: the numpy
    fields stay on the host, as CPU tensors, for the graph cache to move
    (utils/graphs.py: one transfer a dtype, on a replay into the graph's
    own buffers); else each is moved to the device (or a group's shards to
    the mesh's devices) here.  AUTO chunks: each solve may plan for the
    budget its device had when the run began, less what the run moves there
    (its inputs) and what the core will hold there before the solve (the
    working-set model: the flux containers, the earlier solves' outputs),
    so that the run as a whole stays within that budget.

    Its spans (utils/profiling.hook), inside run_radsurf's dispatch.plan:
    dispatch.plan.memory_query (AUTO's budget on each card) and one
    dispatch.plan.gather per section of fields gathered (the flat tiles,
    each layered group's SW and LW inputs, the simple tiles).  With host
    they hold no device work, so a profiler trace can put the card's idle
    time down to them; without it the gathers hold the fields' copies.

    Returns (Plan, payload): payload {"flat", "layered", "simple"}, the
    tensors in the plan's order."""
    rep = np.asarray(arrays["i_representation"])
    dz = arrays["dz"]
    ncol, nlay = dz.shape
    dtype = dz.dtype if isinstance(dz, torch.Tensor) else torch_dtype(np.asarray(dz).dtype)
    itemsize = torch.finfo(dtype).bits // 8
    profiles = config.do_save_flux_profile
    cards = [d for d in {device, *(mesh or ())}
             if d.type == "cuda" and config.column_chunk == -1]
    start = {}
    if cards:
        with profiling.hook("dispatch.plan.memory_query"):
            start = {d: (DM.device_budget(d), torch.cuda.memory_allocated(d)) for d in cards}
    place = (lambda a, dev, dt=None: torch.as_tensor(a, dtype=dt)) if host else to_device

    def get(key, idx, dev=device):
        """The columns idx of arrays[key] for dev: a tensor is indexed on
        dev (its autograd graph kept), a numpy array sliced on the host."""
        x = arrays[key]
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=dtype)[to_device(idx, dev)]
        return place(np.asarray(x)[idx], dev, dtype)

    gdir = "ground_albedo_dir" if config.use_sw_direct_albedo else "ground_albedo"
    payload = {}

    # ---- flat tiles
    idx = np.nonzero(rep == TILE_FLAT)[0]
    if idx.size:
        pl = payload["flat"] = {"idx": place(idx, device)}
        with profiling.hook("dispatch.plan.gather"):
            if config.do_sw:
                pl.update(galb=get("ground_albedo", idx), galb_dir=get(gdir, idx))
            if config.do_lw:
                pl.update(gemis=get("ground_emissivity", idx),
                          gemit=get("ground_emission", idx))

    # ---- layered SPARTACUS tiles, per shard
    groups, payload["layered"] = [], []
    for code, (opt_kw, lg_sw, lg_lw) in _solver_groups(config).items():
        idx = np.nonzero(rep == code)[0]
        if not idx.size:
            continue
        shards = ([(dev, idx[sl]) for dev, sl in column_sharding(idx.size, mesh)
                   if sl.stop > sl.start] if mesh else [(device, idx)])
        pls = []
        for k, (dev, sidx) in enumerate(shards):
            pl = {"idx": place(sidx, device)}
            if config.do_sw:
                keys = {**_SW_KEYS, "ground_albedo_dir": gdir}
                with profiling.hook("dispatch.plan.gather"):
                    pl["sw"] = CanopyInputs(**{f: get(key, sidx, dev) for f, key in keys.items()})
                if k == 0:  # prints the group's first column under SPARTACUS_DEBUG_ARRAYS
                    debug_dump_sw(pl["sw"], SolverOptions(nstream=lg_sw.nstream, **opt_kw),
                                  lg_sw)
            if config.do_lw:
                with profiling.hook("dispatch.plan.gather"):
                    pl["lw"] = CanopyInputs(**{f: get(key, sidx, dev)
                                               for f, key in _LW_KEYS.items()})
            pls.append(pl)
        groups.append((opt_kw, lg_sw, lg_lw, [dev for dev, _ in shards], pls))
        payload["layered"].append(pls)

    # ---- simple urban / infinite street
    idx = np.nonzero(np.isin(rep, [TILE_SIMPLE_URBAN, TILE_INFINITE_STREET]))[0]
    if idx.size:
        if np.any(np.asarray(arrays["nlay"])[idx] != 1):
            raise ValueError(
                "simple urban representations must have only one layer")
        lay0 = lambda key: get(key, idx)[:, 0]
        with profiling.hook("dispatch.plan.gather"):
            pl = payload["simple"] = dict(
                idx=place(idx, device), dz=lay0("dz"),
                bf=lay0("building_fraction"), bs=lay0("building_scale"),
                cos_sza=get("cos_sza", idx),
                is_inf=place(rep[idx] == TILE_INFINITE_STREET, device))
            if config.do_sw:
                pl.update(galb=get("ground_albedo", idx), galb_dir=get(gdir, idx),
                          ralb=lay0("roof_albedo"), walb=lay0("wall_albedo"))
            if config.do_lw:
                pl.update(gemis=get("ground_emissivity", idx),
                          gemit=get("ground_emission", idx),
                          remis=lay0("roof_emissivity"), remit=lay0("roof_emission"),
                          wemis=lay0("wall_emissivity"), wemit=lay0("wall_emission"))

    # ---- the layered solves' options, their AUTO chunks resolved; what
    # the core holds on `device`: the flux containers, the solves' kept
    # outputs and the largest solve's transient (chunked: one chunk's, with
    # the chunks' outputs twice, as they are concatenated)
    bands = ([(False, config.nswinternal)] if config.do_sw else []) + (
        [(True, config.nlwinternal)] if config.do_lw else [])
    containers = sum(2 * DM.class_bytes(DM.CONTAINER_WORDS, ncol, nlay, S, itemsize)
                     for _, S in bands)
    held = {d: torch.cuda.memory_allocated(d) - a for d, (_, a) in start.items()}
    if device in held:  # the inputs the core's call moves, and the containers
        held[device] += containers + sum(
            x.numel() * x.element_size() for x in tree_leaves(payload)
            if x.device.type != device.type)
    layered, kept, peak = [], 0, 0
    for opt_kw, lg_sw, lg_lw, devs, pls in groups:
        shard_opts = []
        for dev, pl in zip(devs, pls):
            opts = []
            for lw, S in bands:
                lg, inp = (lg_lw, pl["lw"]) if lw else (lg_sw, pl["sw"])
                C = inp.dz.shape[0]
                budget = start[dev][0] - held[dev] if dev in start else None
                opt = solver.resolve_chunk(
                    SolverOptions(nstream=lg.nstream, **opt_kw), lg, C, nlay, S,
                    dtype, dev, lw=lw, route=route, with_profiles=profiles,
                    budget=budget)
                size = lambda n: DM.solve_bytes(
                    n, nlay, S, opt.nreg, lg.nstream, itemsize, lw=lw,
                    do_urban=opt.do_urban, with_profiles=profiles)
                transient, k = size(C)
                if 0 < opt.column_chunk < C:
                    transient = size(opt.column_chunk)[0] + 2 * k
                peak, kept = max(peak, kept + transient), kept + k
                if dev in held:  # the solve's outputs, kept to the end
                    held[dev] += k
                opts.append(opt)
            opt_sw = opts[0] if config.do_sw else None
            opt_lw = opts[-1] if config.do_lw else None
            shard_opts.append((dev, opt_sw, opt_lw))
        layered.append((lg_sw.nstream, lg_lw.nstream, tuple(shard_opts)))

    plan = Plan(ncol, nlay, config.nswinternal, config.nlwinternal, config.do_sw,
                config.do_lw, profiles, config.min_building_fraction, route, device,
                dtype, "flat" in payload, tuple(layered), "simple" in payload,
                need=containers + peak)
    return plan, payload


def _core(plan: Plan, payload):
    """The device half of run_radsurf (JAX _radsurf_core): the flux
    containers, the flat, layered and simple-urban solves, and the scatter
    of every group's outputs into the containers.  plan, payload: _plan,
    the payload on its devices."""
    ncol, nlay, nsw, nlw = plan.ncol, plan.nlay, plan.nsw, plan.nlw
    do_sw, do_lw, profiles, route = plan.do_sw, plan.do_lw, plan.profiles, plan.route
    kw = dict(dtype=plan.dtype, device=plan.device)
    bc = {}
    out = {"bc_out": bc}
    if do_sw:
        bc.update(sw_albedo=torch.zeros((ncol, nsw), **kw),
                  sw_albedo_dir=torch.zeros((ncol, nsw), **kw))
        out.update(sw_norm_dir=_empty_flux(ncol, nlay, nsw, **kw),
                   sw_norm_diff=_empty_flux(ncol, nlay, nsw, **kw))
    if do_lw:
        bc.update(lw_emissivity=torch.zeros((ncol, nlw), **kw),
                  lw_emission=torch.zeros((ncol, nlw), **kw))
        out.update(lw_internal=_empty_flux(ncol, nlay, nlw, **kw),
                   lw_norm=_empty_flux(ncol, nlay, nlw, **kw))

    # ---- flat tiles (radsurf_interface.F90:122-173)
    if plan.flat:
        pl = payload["flat"]
        tidx = pl["idx"]
        if do_sw:
            nd, nf, fbc = flat_mod.flat_sw(pl["galb"], pl["galb_dir"])
            _scatter(out["sw_norm_dir"], nd, tidx)
            _scatter(out["sw_norm_diff"], nf, tidx)
            for key in ("sw_albedo", "sw_albedo_dir"):
                bc[key][tidx] = fbc[key]
        if do_lw:
            li, ln, fbc = flat_mod.flat_lw(pl["gemis"], pl["gemit"])
            _scatter(out["lw_internal"], li, tidx)
            _scatter(out["lw_norm"], ln, tidx)
            for key in ("lw_emissivity", "lw_emission"):
                bc[key][tidx] = fbc[key]

    # ---- layered SPARTACUS tiles: every shard's solves are issued first,
    # then their results gathered on `device` and scattered
    solved = []
    for (ns_sw, ns_lw, shards), pls in zip(plan.layered, payload.get("layered", ())):
        for (_, opt_sw, opt_lw), pl in zip(shards, pls):
            sw = lw = None
            if opt_sw is not None:
                inp = pl["sw"]
                sw = (inp.cos_sza > 0.0, spartacus_sw(
                    inp, opt_sw, _lg(ns_sw), with_profiles=profiles, route=route))
            if opt_lw is not None:  # not masked by sun_up
                lw = spartacus_lw(pl["lw"], opt_lw, _lg(ns_lw),
                                  with_profiles=profiles, route=route)
            solved.append((pl["idx"], sw, lw))
    for tidx, sw, lw in solved:
        sw, lw = tree_map(lambda t: t.to(plan.device), (sw, lw))
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
    if plan.simple:
        pl = payload["simple"]
        tidx = pl["idx"]
        geom = (pl["dz"], pl["bf"], pl["bs"])
        opts = dict(min_building_fraction=plan.min_building_fraction,
                    with_profiles=profiles)
        if do_sw:
            ndir, ndiff, sbc = su_mod.simple_urban_sw(
                *geom, pl["cos_sza"], pl["is_inf"], pl["galb"], pl["galb_dir"],
                pl["ralb"], pl["walb"], **opts)
            sun_up = pl["cos_sza"] > 0.0
            _scatter(out["sw_norm_dir"], ndir, tidx, sun_up, layer0=True)
            _scatter(out["sw_norm_diff"], ndiff, tidx, sun_up, layer0=True)
            for key in ("sw_albedo", "sw_albedo_dir"):
                bc[key][tidx] = sbc[key]
        if do_lw:
            lint, lnorm, lbc = su_mod.simple_urban_lw(
                *geom, pl["is_inf"], pl["gemis"], pl["gemit"], pl["remis"],
                pl["remit"], pl["wemis"], pl["wemit"], **opts)
            _scatter(out["lw_internal"], lint, tidx, layer0=True)
            _scatter(out["lw_norm"], lnorm, tidx, layer0=True)
            for key in ("lw_emissivity", "lw_emission"):
                bc[key][tidx] = lbc[key]
    return out
