"""Tile-type dispatch: buckets columns by representation, solves each group
and scatters its outputs into dense [C, ...] tensors on the device.

Port of spartacus_surface_tpu/models/dispatch.py ``run_radsurf`` /
``_radsurf_core`` (shortwave and longwave).
Parity: the per-column ``select case (i_representation)`` loop of
radsurf/radsurf_interface.F90:105-313.

As in JAX, a call is a host plan (_plan: the tile groups, their indices,
the fields they read, whole, the AUTO column chunks) and a device core
(_core: the flux containers, each group's rows gathered from the whole
fields, every solve and scatter), which on the kernel route runs as a
compiled program: a CUDA graph per (plan, shapes, dtype, device),
utils/graphs.py.

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
from ..utils.debug import debug_arrays_enabled
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
    itemsize bytes.  Every field a tile group reads is on the device whole
    before the core runs (_plan), and the core holds _working_set's peak
    beyond them."""
    rep = np.asarray(i_representation)
    n_flat = int((rep == TILE_FLAT).sum())
    n_simple = int(np.isin(rep, [TILE_SIMPLE_URBAN, TILE_INFINITE_STREET]).sum())
    groups = [(opt_kw, lg_sw, lg_lw, [(None, C)])
              for code, (opt_kw, lg_sw, lg_lw) in _solver_groups(config).items()
              if (C := int((rep == code).sum()))]
    need, _, _ = _working_set(config, rep.size, nlay, itemsize, n_flat, groups, n_simple)
    whole = _whole_keys(_gathers(config.do_sw, config.do_lw, _gdir(config)),
                        n_flat, bool(groups), n_simple)
    return need + _row_bytes(config, whole, rep.size, nlay, itemsize)


def _working_set(config: Config, ncol: int, nlay: int, itemsize: int, n_flat: int,
                 groups, n_simple: int, device=None, resolve=None) -> tuple:
    """The working-set model of run_radsurf's core on the kernel route, in
    bytes beyond its inputs.  The core fills the flux containers of every
    column on `device`, then runs its sections in order: the flat tiles,
    the layered groups (groups: [(opt_kw, lg_sw, lg_lw, [(shard device,
    columns), ...])], _solver_groups' order) and the simple tiles.  A
    section gathers its rows (_gathers) and keeps them through its solves,
    and every solve's outputs are kept until all are scattered.  So the
    peak is the containers, the outputs kept so far, and one section's rows
    with one solve's transient (chunked: one chunk's, with the chunks'
    outputs twice, as they are concatenated), the largest of them.

    resolve(opt, lg, C, S, dev, lw, held) -> opt with its column chunk
    resolved, where held is what the core holds on dev before the solve;
    None: one shot, no chunk resolved.  Returns (Plan.need: the containers
    and the peak, Plan.gathered: every section's rows, Plan.layered:
    [(nstream_sw, nstream_lw, ((dev, opt_sw or None, opt_lw or None), ...))
    a group])."""
    bands = ([(False, config.nswinternal)] if config.do_sw else []) + (
        [(True, config.nlwinternal)] if config.do_lw else [])
    keys = _gathers(config.do_sw, config.do_lw, _gdir(config))
    rows = lambda section, C: _row_bytes(config, keys[section], C, nlay, itemsize,
                                         lay0=section == "lay0")
    profiles = config.do_save_flux_profile
    containers = sum(2 * DM.class_bytes(DM.CONTAINER_WORDS, ncol, nlay, S, itemsize)
                     for _, S in bands)
    held = {device: containers}
    peak = gathered = rows("flat", n_flat)
    kept, layered = 0, []
    for opt_kw, lg_sw, lg_lw, shards in groups:
        shard_opts = []
        for dev, C in shards:
            g = rows("layered", C)
            held[dev] = held.get(dev, 0) + g
            opts = []
            for lw, S in bands:
                lg = lg_lw if lw else lg_sw
                opt = SolverOptions(nstream=lg.nstream, **opt_kw)
                if resolve is not None:
                    opt = resolve(opt, lg, C, S, dev, lw, held[dev])
                size = lambda n: DM.solve_bytes(
                    n, nlay, S, opt.nreg, lg.nstream, itemsize, lw=lw,
                    do_urban=opt.do_urban, with_profiles=profiles)
                transient, k = size(C)
                if resolve is not None and 0 < opt.column_chunk < C:
                    transient = size(opt.column_chunk)[0] + 2 * k
                peak, kept = max(peak, kept + g + transient), kept + k
                held[dev] += k
                opts.append(opt)
            held[dev] -= g
            gathered += g
            shard_opts.append((dev, opts[0] if config.do_sw else None,
                               opts[-1] if config.do_lw else None))
        layered.append((lg_sw.nstream, lg_lw.nstream, tuple(shard_opts)))
    simple = rows("simple", n_simple) + rows("lay0", n_simple)
    return containers + max(peak, kept + simple), gathered + simple, layered


def _same(*names):
    return {k: k for k in names}


# CanopyInputs field -> arrays key, per band (JAX _gather_inputs); a
# layered group's SW and LW inputs share the common fields' rows
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
# the arrays keys with a band axis of nlw, not nsw
_LW_ONLY = frozenset(_LW_KEYS.values()) - frozenset(_COMMON_KEYS.values())


def _gdir(config: Config) -> str:
    """The arrays key of the direct ground albedo."""
    return "ground_albedo_dir" if config.use_sw_direct_albedo else "ground_albedo"


def _gathers(do_sw: bool, do_lw: bool, gdir: str) -> dict:
    """The arrays keys whose rows each section of _core gathers, each once:
    {"flat", "layered", "simple": [C, ...] rows, "lay0": the simple tiles'
    layer-0 slices}."""
    ground = (["ground_albedo", gdir] if do_sw else []) + (
        ["ground_emissivity", "ground_emission"] if do_lw else [])
    canopy = [*({**_SW_KEYS, "ground_albedo_dir": gdir}.values() if do_sw else ()),
              *(_LW_KEYS.values() if do_lw else ())]
    lay0 = ["dz", "building_fraction", "building_scale"] + (
        ["roof_albedo", "wall_albedo"] if do_sw else []) + (
        ["roof_emissivity", "roof_emission", "wall_emissivity", "wall_emission"]
        if do_lw else [])
    unique = lambda keys: list(dict.fromkeys(keys))
    return {"flat": unique(ground), "layered": unique(canopy),
            "simple": unique(["cos_sza", *ground]), "lay0": lay0}


def _whole_keys(gathers: dict, flat, layered, simple) -> list:
    """The arrays keys that the sections present (flat, layered, simple:
    whether each has columns) gather from, each once: the whole fields
    that _plan moves."""
    on = {"flat": flat, "layered": layered, "simple": simple, "lay0": simple}
    return list(dict.fromkeys(k for s, keys in gathers.items() if on[s] for k in keys))


def _row_bytes(config: Config, keys, C: int, nlay: int, itemsize: int,
               lay0: bool = False) -> int:
    """Bytes of the rows of arrays[key] (lay0: their layer-0 slices) at C
    columns, over the keys: the model's one count of a field's bytes.  A
    row holds a word (cos_sza), a word a band (ground_*), one a layer (the
    other fields without a band axis) or one a layer and band (the rest)."""
    layers = 1 if lay0 else nlay
    words = 0
    for key in keys:
        S = config.nlwinternal if key in _LW_ONLY else config.nswinternal
        words += (1 if key == "cos_sza" else S if key.startswith("ground_")
                  else layers if key in _COMMON_KEYS else layers * S)
    return C * itemsize * words


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

    The host plan (_plan: tile groups, their indices, AUTO column chunks)
    runs at every call; the device core (_core: the gathers of each group's
    rows from the whole fields, every solve and scatter) is a compiled
    program (utils/graphs.py; JAX _radsurf_core): on CUDA a CUDA graph per
    (plan, shapes, dtype, device), captured at the second call and replayed
    from then on, on the kernel route, its whole fields and indices moved
    with one transfer a dtype; at a replay a field whose numpy array an
    earlier call passed, the same live array, is copied straight from its
    page-locked pages instead (_owners).  Either way the host inputs have
    been read when the call returns.  It runs eagerly on the CPU, under
    graphs.disabled(), where an input needs a gradient, with a mesh, and on
    the scan route (the plain reference: its factory reads its doubling
    count on the host).  graphs.stats()["gather_bytes"] counts the bytes
    the core gathers.

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
    graphs.count("gather_bytes", plan.gathered)
    if not compiled:
        with graphs.disabled() if mesh else contextlib.nullcontext():
            return _core(plan, payload)
    skeleton = tree_map(lambda _: 0, payload)

    def core(*xs):
        it = iter(xs)
        return _core(plan, tree_map(lambda _: next(it), skeleton))
    tensors = tree_leaves(payload)
    return graphs.call(plan, core, tensors, device=device, need=plan.need,
                       owners=_owners(arrays, payload["fields"], tensors))


def _owners(arrays: dict, fields: dict, tensors: list) -> list:
    """Per tensor of a compiled call, the numpy array that holds its memory
    where it is a caller's field itself (torch.as_tensor copied nothing):
    the root of the field's .base chain, which the graph cache may
    page-lock and copy from straight (utils/graphs.py Pinned).  None for a
    cast field and for the indices and is_inf, which are built anew at
    every call."""
    held = {}
    for key, t in fields.items():
        x = arrays[key]
        if isinstance(x, np.ndarray) and t.data_ptr() == x.__array_interface__["data"][0]:
            while isinstance(x.base, np.ndarray):
                x = x.base
            held[id(t)] = x
    return [held.get(id(t)) for t in tensors]


@functools.lru_cache(maxsize=None)
def _lg(nstream: int) -> LegendreGauss:
    return LegendreGauss(nstream)


@dataclass(frozen=True)
class Plan:
    """The static part of a run_radsurf call (_plan), which keys its core's
    graph.  gdir: the arrays key of the direct ground albedo; flat /
    simple: whether those tile groups exist; layered: per layered group
    (nstream_sw, nstream_lw, ((shard device, opt_sw or None, opt_lw or
    None), ...)), the options with their column chunks resolved; need: the
    bytes the core allocates beyond its inputs, and gathered: the bytes of
    the rows it gathers (_working_set), which follow from the rest."""
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
    gdir: str
    flat: bool
    layered: tuple
    simple: bool
    need: int = field(default=0, compare=False)
    gathered: int = field(default=0, compare=False)


def _plan(config: Config, arrays: dict, device, route: str, mesh, host: bool = False):
    """The host half of run_radsurf (JAX run_radsurf before _radsurf_core):
    the tile groups and their column indices, the fields they read, whole,
    and each layered solve's options with its column chunk resolved.  The
    rows of each group are gathered on the device, in _core.  A field that
    is a torch tensor is moved to the device as it is (its autograd graph
    kept); a numpy field is, with host, a CPU tensor over the caller's array
    (cast only where its dtype is not dz's) for the graph cache to move
    (utils/graphs.py: one transfer a dtype, on a replay into the graph's
    own buffers), else moved to the device here.  AUTO chunks: each solve
    may plan for the budget its device had when the run began, less what
    the run moves there (the whole fields and indices) and what the core
    will hold there before the solve (_working_set), so that the run as a
    whole stays within that budget.  Under
    SPARTACUS_DEBUG_ARRAYS each layered group's SW inputs at its first
    column are built here, on the host, for solver.debug_dump_sw.

    Its span (utils/profiling.hook), inside run_radsurf's dispatch.plan:
    dispatch.plan.memory_query (AUTO's budget on each card).

    Returns (Plan, payload): payload {"fields": {arrays key: [ncol, ...]},
    "flat", "layered", "simple": each group's (each shard's) column
    indices, the simple tiles' is_inf}, the tensors in the plan's order."""
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
    place = (lambda a, dev: torch.as_tensor(a)) if host else to_device

    def whole(key):
        x = arrays[key]
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype)
        x = np.asarray(x)
        return torch.as_tensor(x, dtype=dtype) if host else to_device(x, device, dtype)

    gdir = _gdir(config)
    keys = _gathers(config.do_sw, config.do_lw, gdir)
    payload = {}
    flat = np.nonzero(rep == TILE_FLAT)[0]
    simple = np.nonzero(np.isin(rep, [TILE_SIMPLE_URBAN, TILE_INFINITE_STREET]))[0]
    if simple.size and np.any(np.asarray(arrays["nlay"])[simple] != 1):
        raise ValueError("simple urban representations must have only one layer")
    groups = [(np.nonzero(rep == code)[0], *solve)
              for code, solve in _solver_groups(config).items()]
    groups = [g for g in groups if g[0].size]
    payload["fields"] = {k: whole(k) for k in _whole_keys(
        keys, flat.size, bool(groups), simple.size)}

    # ---- flat tiles
    if flat.size:
        payload["flat"] = {"idx": place(flat, device)}

    # ---- layered SPARTACUS tiles, per shard
    payload["layered"], sections = [], []
    for idx, opt_kw, lg_sw, lg_lw in groups:
        shards = ([(dev, idx[sl]) for dev, sl in column_sharding(idx.size, mesh)
                   if sl.stop > sl.start] if mesh else [(device, idx)])
        if config.do_sw and debug_arrays_enabled():  # the group's first column
            first = lambda key: torch.as_tensor(
                (arrays[key].detach().cpu() if isinstance(arrays[key], torch.Tensor)
                 else np.asarray(arrays[key]))[idx[:1]]).to(dtype)
            debug_dump_sw(CanopyInputs(**{f: first(key) for f, key in {
                **_SW_KEYS, "ground_albedo_dir": gdir}.items()}),
                SolverOptions(nstream=lg_sw.nstream, **opt_kw), lg_sw)
        payload["layered"].append([{"idx": place(sidx, device)} for _, sidx in shards])
        sections.append((opt_kw, lg_sw, lg_lw, [(dev, sidx.size) for dev, sidx in shards]))

    # ---- simple urban / infinite street
    if simple.size:
        payload["simple"] = dict(idx=place(simple, device),
                                 is_inf=place(rep[simple] == TILE_INFINITE_STREET, device))

    # ---- the layered solves' options, their AUTO chunks resolved against
    # what each card had less what the run moves there and holds there
    spent = {d: torch.cuda.memory_allocated(d) - a for d, (_, a) in start.items()}
    if device in spent:  # the inputs the core's call moves
        spent[device] += sum(x.numel() * x.element_size() for x in tree_leaves(payload)
                             if x.device.type != device.type)

    def resolve(opt, lg, C, S, dev, lw, held):
        budget = start[dev][0] - (spent[dev] + held) if dev in start else None
        return solver.resolve_chunk(opt, lg, C, nlay, S, dtype, dev, lw=lw, route=route,
                                    with_profiles=profiles, budget=budget)

    need, gathered, layered = _working_set(config, ncol, nlay, itemsize, flat.size,
                                           sections, simple.size, device, resolve)
    plan = Plan(ncol, nlay, config.nswinternal, config.nlwinternal, config.do_sw,
                config.do_lw, profiles, config.min_building_fraction, route, device,
                dtype, gdir, "flat" in payload, tuple(layered), "simple" in payload,
                need=need, gathered=gathered)
    return plan, payload


def _core(plan: Plan, payload):
    """The device half of run_radsurf (JAX _radsurf_core): the flux
    containers; the flat, layered and simple-urban solves, each on the rows
    of its columns gathered from the whole fields (a layered group's SW and
    LW inputs sharing their common fields' rows; a shard's rows moved to its
    device); and the scatter of every group's outputs into the containers.
    plan, payload: _plan, the payload on its devices."""
    ncol, nlay, nsw, nlw = plan.ncol, plan.nlay, plan.nsw, plan.nlw
    do_sw, do_lw, profiles, route = plan.do_sw, plan.do_lw, plan.profiles, plan.route
    F, keys = payload["fields"], _gathers(do_sw, do_lw, plan.gdir)
    kw = dict(dtype=plan.dtype, device=plan.device)

    def gather(section, idx, dev=plan.device, lay0=False):
        """{arrays key: its rows idx} of the section's fields, on dev."""
        return {k: (F[k][:, 0] if lay0 else F[k]).index_select(0, idx).to(dev)
                for k in keys[section]}

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
        tidx = payload["flat"]["idx"]
        g = gather("flat", tidx)
        if do_sw:
            nd, nf, fbc = flat_mod.flat_sw(g["ground_albedo"], g[plan.gdir])
            _scatter(out["sw_norm_dir"], nd, tidx)
            _scatter(out["sw_norm_diff"], nf, tidx)
            for key in ("sw_albedo", "sw_albedo_dir"):
                bc[key][tidx] = fbc[key]
        if do_lw:
            li, ln, fbc = flat_mod.flat_lw(g["ground_emissivity"], g["ground_emission"])
            _scatter(out["lw_internal"], li, tidx)
            _scatter(out["lw_norm"], ln, tidx)
            for key in ("lw_emissivity", "lw_emission"):
                bc[key][tidx] = fbc[key]
        del g

    # ---- layered SPARTACUS tiles: every shard's solves are issued first,
    # then their results gathered on `device` and scattered
    def solve(ns_sw, ns_lw, dev, opt_sw, opt_lw, tidx):
        g = gather("layered", tidx, dev)
        inputs = lambda names: CanopyInputs(**{f: g[k] for f, k in names.items()})
        sw = lw = None
        if opt_sw is not None:
            inp = inputs({**_SW_KEYS, "ground_albedo_dir": plan.gdir})
            sw = (inp.cos_sza > 0.0, spartacus_sw(
                inp, opt_sw, _lg(ns_sw), with_profiles=profiles, route=route))
        if opt_lw is not None:  # not masked by sun_up
            lw = spartacus_lw(inputs(_LW_KEYS), opt_lw, _lg(ns_lw),
                              with_profiles=profiles, route=route)
        return tidx, sw, lw

    solved = [solve(ns_sw, ns_lw, *shard, pl["idx"])
              for (ns_sw, ns_lw, shards), pls in zip(plan.layered, payload["layered"])
              for shard, pl in zip(shards, pls)]
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
        tidx, is_inf = pl["idx"], pl["is_inf"]
        g, g0 = gather("simple", tidx), gather("lay0", tidx, lay0=True)
        geom = (g0["dz"], g0["building_fraction"], g0["building_scale"])
        opts = dict(min_building_fraction=plan.min_building_fraction,
                    with_profiles=profiles)
        if do_sw:
            ndir, ndiff, sbc = su_mod.simple_urban_sw(
                *geom, g["cos_sza"], is_inf, g["ground_albedo"], g[plan.gdir],
                g0["roof_albedo"], g0["wall_albedo"], **opts)
            sun_up = g["cos_sza"] > 0.0
            _scatter(out["sw_norm_dir"], ndir, tidx, sun_up, layer0=True)
            _scatter(out["sw_norm_diff"], ndiff, tidx, sun_up, layer0=True)
            for key in ("sw_albedo", "sw_albedo_dir"):
                bc[key][tidx] = sbc[key]
        if do_lw:
            lint, lnorm, lbc = su_mod.simple_urban_lw(
                *geom, is_inf, g["ground_emissivity"], g["ground_emission"],
                g0["roof_emissivity"], g0["roof_emission"], g0["wall_emissivity"],
                g0["wall_emission"], **opts)
            _scatter(out["lw_internal"], lint, tidx, layer0=True)
            _scatter(out["lw_norm"], lnorm, tidx, layer0=True)
            for key in ("lw_emissivity", "lw_emission"):
                bc[key][tidx] = lbc[key]
    return out
