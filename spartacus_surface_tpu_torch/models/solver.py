"""The SPARTACUS multi-layer shortwave and longwave solvers (forest + urban).

Port of spartacus_surface_tpu/models/solver.py.  A forest is an urban canopy
with building_fraction == 0.  Columns are dense-padded above the canopy with
dz = 0 layers, which are exact no-ops (expm(0) = I).

Two routes compute the same fluxes:

  kernel route (the default): SW runs the layer factory K1, the adding
      up-sweep K2 and the fused direct+diffuse flux down-sweep K3
      (ops/layer_kernel.py, ops/sweep_kernels.py), then a plain-torch
      epilogue with the clear-sky direct recurrence and the sunlit fractions
      in closed form; LW runs K1 with the emission as a pseudo-beam, the
      up-sweep K4 and the fused internal+incoming down-sweep K5
      (ops/lw_sweep_kernels.py), then the ground fluxes in closed form.
      CUDA tensors run the hand-written CUDA kernels; CPU tensors run their
      plain PyTorch versions.  Reverse-mode differentiable through
      _KernelRouteGrad, whose backward is the scan route's.
  scan route (``route="scan"``): the reference formulation of the JAX XLA
      path, layer_matrices plus a Python loop per layer for the up and down
      recurrences (radsurf_urban_sw.F90:590-1001, radsurf_urban_lw.F90:
      551-858).  Plain torch on any device; the port's whole-solve
      reference and the gradient of both routes.

SolverOptions.associative_sweeps replaces the layer loops of the scan route
(and K2-K5 on the kernel route, whose factory stays K1 / K1d) with the
log-depth compositions of ops/assoc_adding.py.

The cosine of the solar zenith angle is clamped to >= 1e-6 throughout
(radsurf_urban_sw.F90:268).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..ops.assoc_adding import (
    affine_down_carries,
    ground_star_element,
    lw_layer_star_elements,
    scalar_suffix_carries,
    star_prefix,
    sw_layer_star_elements,
)
from ..ops.layer_kernel import layer_factory, lw_layer_factory
from ..ops.layer_matrices import layer_matrices_chunked, lw_layer_matrices_chunked
from ..ops.legendre_gauss import LegendreGauss
from ..ops.lw_sweep_kernels import lw_down_sweep_both, lw_out_rows, lw_up_sweep
from ..ops.matrix import matmul, matvec, solve
from ..ops.sweep_kernels import sw_down_sweep_both, sw_out_rows, sw_up_sweep
from ..utils import device_memory as DM
from ..utils import graphs
from ..utils.constants import Pi
from ..utils.debug import debug_arrays_enabled, maybe_dump
from ..utils.transfer import constant
from . import gamma as G
from .geometry import (
    norm_perim_urban,
    od_scaling_from_fsd,
    overlap_matrices_urban,
    region_fracs,
)


# ----------------------------------------------------------------------
# Expanded-overlap products (radtool_matrix.F90:505-651): overlap matrices
# act on the region index of (region, stream) vectors and matrices.
# ----------------------------------------------------------------------

def _safe_div(num, den):
    """num / den, and 0 where den has underflowed (horizon sun through a
    thick canopy: nothing is sunlit)."""
    ok = den > torch.finfo(den.dtype).tiny
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def _ov_vec(ov, x, ns):
    """[C, A, B] region overlap applied to [C, S, B*ns] -> [C, S, A*ns]."""
    c, s, _ = x.shape
    out = torch.einsum("cab,csbn->csan", ov, x.reshape(c, s, ov.shape[-1], ns))
    return out.reshape(c, s, ov.shape[-2] * ns)


def _ov_dirvec(ov, x):
    """[C, A, B] applied to a direct vector [C, S, B] -> [C, S, A]."""
    return torch.einsum("cab,csb->csa", ov, x)


def _u_mat_v(u, m, v, ns):
    """(u (x) I_ns) @ m @ (v (x) I_ns) (radsurf_urban_sw.F90:646-649)."""
    c, s = m.shape[:2]
    mr = m.reshape(c, s, u.shape[-1], ns, v.shape[-2], ns)
    out = torch.einsum("ctq,csqurv,crf->cstufv", u, mr, v)
    return out.reshape(c, s, u.shape[-2] * ns, v.shape[-1] * ns)


def _u_dmat_v(u, d, v, ns):
    """(u (x) I_ns) @ d @ v (radsurf_urban_sw.F90:650-653)."""
    c, s = d.shape[:2]
    dr = d.reshape(c, s, u.shape[-1], ns, d.shape[-1])
    out = torch.einsum("ctq,csqur,crf->cstuf", u, dr, v)
    return out.reshape(c, s, u.shape[-2] * ns, v.shape[-1])


# ----------------------------------------------------------------------
# Inputs and options
# ----------------------------------------------------------------------

@dataclass
class CanopyInputs:
    """Dense padded inputs for a group of columns sharing one solver config.

    Shapes: [C] per column, [C, L] per layer (bottom-up, padding above the
    canopy with dz=0 and zero fractions), [C, S] per column and band,
    [C, L, S] per layer and band.  The fields are those of the JAX
    ``CanopyInputs``; utils/convert.py builds one from it.
    """

    dz: torch.Tensor
    cos_sza: torch.Tensor
    veg_fraction: torch.Tensor
    veg_scale: torch.Tensor
    veg_ext: torch.Tensor
    veg_fsd: torch.Tensor
    veg_contact_fraction: torch.Tensor
    building_fraction: torch.Tensor
    building_scale: torch.Tensor
    air_ext: torch.Tensor
    air_ssa: torch.Tensor
    veg_ssa: torch.Tensor
    # SW facet properties
    ground_albedo: torch.Tensor | None = None
    ground_albedo_dir: torch.Tensor | None = None
    roof_albedo: torch.Tensor | None = None
    roof_albedo_dir: torch.Tensor | None = None
    wall_albedo: torch.Tensor | None = None
    wall_specular_frac: torch.Tensor | None = None
    # LW facet/volume properties
    ground_emissivity: torch.Tensor | None = None
    ground_emission: torch.Tensor | None = None
    roof_emissivity: torch.Tensor | None = None
    roof_emission: torch.Tensor | None = None
    wall_emissivity: torch.Tensor | None = None
    wall_emission: torch.Tensor | None = None
    clear_air_planck: torch.Tensor | None = None
    veg_planck: torch.Tensor | None = None
    veg_air_planck: torch.Tensor | None = None

    def tensors(self):
        """(name, tensor) for every field that is set."""
        return [(f.name, getattr(self, f.name)) for f in fields(self)
                if getattr(self, f.name) is not None]


@dataclass(frozen=True)
class SolverOptions:
    """Static solver configuration for one column group."""

    nreg: int
    nstream: int
    do_urban: bool  # include wall/roof physics and outputs
    use_symmetric_vegetation_scale: bool = True
    vegetation_isolation_factor: float = 0.0
    min_vegetation_fraction: float = 1.0e-6
    min_building_fraction: float = 1.0e-6
    # Doubling-step cap of the norm-adaptive factory: per-layer
    # ||Gamma dz|| up to theta * 2**n_double at full accuracy (30 covers
    # horizon sun, see the JAX SolverOptions).
    n_double: int = 30
    # Batch elements (column x band x layer) per step of the factory's
    # plain version (the CPU route), bounding its temporaries; the kernels
    # (K1, K1d) launch once over every element and need no workspace.
    factory_chunk: int = 65536
    # Solve in chunks of this many columns (0 = whole batch, -1 = AUTO:
    # the whole batch where the working-set model says it fits the device,
    # else the fewest equal chunks that fit; _resolve_column_chunk).  Under
    # autograd on the kernel route, each chunk's backward recomputes its own
    # scan graph, so the chunk also bounds a gradient step's memory.
    column_chunk: int = 0
    # The O(log L)-depth associative adding and flux recurrences
    # (ops/assoc_adding.py) in place of the sequential layer loops: ~4-6x
    # the FLOPs for L / log2(L) less dependency depth, for very deep
    # canopies at small batch.  On the kernel route the factory stays K1 /
    # K1d and the sweeps are these plain ones (K2-K5 do not run).
    associative_sweeps: bool = False


# ----------------------------------------------------------------------
# Shared front end: geometry and Gamma assembly
# ----------------------------------------------------------------------

def _prepare_geometry(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
                      lw: bool):
    nreg = opt.nreg
    frac = region_fracs(inp.veg_fraction, inp.building_fraction, nreg)
    u_ov, v_ov = overlap_matrices_urban(frac, nreg, opt.min_vegetation_fraction,
                                        inp.building_fraction)
    norm_perim, norm_perim_wall = norm_perim_urban(
        inp.building_fraction, inp.building_scale, inp.veg_fraction,
        inp.veg_scale, inp.veg_contact_fraction, nreg=nreg,
        use_symmetric_vegetation_scale=opt.use_symmetric_vegetation_scale,
        vegetation_isolation_factor=opt.vegetation_isolation_factor,
        min_vegetation_fraction=opt.min_vegetation_fraction,
        min_building_fraction=opt.min_building_fraction,
    )
    f_exchange = G.exchange_rates(norm_perim, frac, nreg,
                                  opt.min_vegetation_fraction)
    f_wall = G.wall_rates(norm_perim_wall, frac, nreg,
                          opt.min_vegetation_fraction,
                          lg.vadjustment2 if lw else 1.0)
    if not opt.do_urban:
        f_wall = torch.zeros_like(f_wall)
    return dict(frac=frac, od_scaling=od_scaling_from_fsd(inp.veg_fsd, nreg),
                u_ov=u_ov, v_ov=v_ov, norm_perim_wall=norm_perim_wall,
                f_exchange=f_exchange, f_wall=f_wall)


def debug_dump_sw(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss):
    """PRINT_ARRAYS equivalent: print the geometry and Gamma matrices of the
    first column, layer and band when SPARTACUS_DEBUG_ARRAYS is set (cf.
    radsurf_forest_sw.F90:389-403; JAX solver.py:282-321)."""
    if not debug_arrays_enabled():
        return
    zcos, sin0, geo, _, (g0, g1, g2, g3) = _sw_front(inp, opt, lg)
    ext_reg, ssa_reg = G.region_optics_sw(
        inp.air_ext, inp.air_ssa, inp.veg_ext, inp.veg_ssa,
        geo["od_scaling"], opt.nreg)
    maybe_dump("SW first column, layer 0, band 0", {
        "frac": geo["frac"][0, 0],
        "od_scaling": geo["od_scaling"][0, 0],
        "f_exchange": geo["f_exchange"][0, 0],
        "f_wall": geo["f_wall"][0, 0],
        "norm_perim_wall": geo["norm_perim_wall"][0, 0],
        "u_overlap": geo["u_ov"][0, 0],
        "v_overlap": geo["v_ov"][0, 0],
        "ext_reg": ext_reg[0, 0, 0],
        "ssa_reg": ssa_reg[0, 0, 0],
        "gamma0": g0[0, 0, 0],
        "gamma1": g1[0, 0, 0],
        "gamma2": g2[0, 0, 0],
        "gamma3": g3[0, 0, 0],
    })


def _itransp(air_ext, dz):
    """Most transparent spectral interval per column
    (radsurf_urban_sw.F90:310)."""
    return torch.argmin((air_ext * dz[..., None]).sum(1), dim=-1)


def _take_spec(x, itr):
    """Gather the itransp spectral slice: [C, ..., S] -> [C, ...]."""
    idx = itr.reshape(itr.shape + (1,) * (x.ndim - 1))
    return torch.take_along_dim(x, idx, dim=-1)[..., 0]


def _pad_od(od_scaling):
    """[C, L, nreg-1] -> [C, L, max(nreg-1, 1)] (nreg=1: unused zeros)."""
    if od_scaling.shape[-1] == 0:
        return od_scaling.new_zeros(od_scaling.shape[:-1] + (1,))
    return od_scaling


def _sw_front(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss):
    """Geometry, per-layer facet properties and the Gamma matrices."""
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    zcos = inp.cos_sza.clamp_min(1.0e-6)
    sin0 = torch.sqrt(1.0 - zcos * zcos)
    geo = _prepare_geometry(inp, opt, lg, lw=False)
    zeros = inp.air_ext.new_zeros((C, L, S))
    if opt.do_urban:
        # radsurf_urban_sw.F90:412-418
        wall_ext = 1.0 - inp.wall_albedo * inp.wall_specular_frac
        wall_factor = inp.wall_albedo * (1.0 - inp.wall_specular_frac)
        facets = dict(wall_albedo=inp.wall_albedo, roof_albedo=inp.roof_albedo,
                      roof_albedo_dir=inp.roof_albedo_dir)
    else:
        wall_ext = wall_factor = zeros
        facets = dict(wall_albedo=zeros, roof_albedo=zeros,
                      roof_albedo_dir=zeros)
    ext_reg, ssa_reg = G.region_optics_sw(
        inp.air_ext, inp.air_ssa, inp.veg_ext, inp.veg_ssa,
        geo["od_scaling"], opt.nreg)
    g0, g1, g2, g3 = G.assemble_gammas(
        ext_reg, ssa_reg, geo["f_exchange"], geo["f_wall"], wall_ext,
        wall_factor, lg, opt.nreg, cos_sza=zcos, sin_sza=sin0,
        tan_sza=sin0 / zcos)
    g0 = g0.expand(C, L, S, opt.nreg, opt.nreg)
    return zcos, sin0, geo, facets, (g0, g1, g2, g3)


def _clear_sky(inp: CanopyInputs, opt: SolverOptions, geo, zcos):
    """Per-column, per-layer clear-sky quantities of the sunlit fractions
    (radsurf_urban_sw.F90:292-298, 405-410, 804-848)."""
    C = inp.dz.shape[0]
    itr = _itransp(inp.air_ext, inp.dz)
    air_ext_t = torch.take_along_dim(inp.air_ext, itr[:, None, None], -1)[..., 0]
    bf_above = torch.cat([inp.building_fraction[:, 1:],
                          inp.building_fraction.new_zeros((C, 1))], dim=1)
    nbf = 1.0 - inp.building_fraction
    npw_sum = geo["norm_perim_wall"].sum(-1)
    fwdc = torch.where(
        nbf > opt.min_building_fraction,
        npw_sum / (Pi * nbf.clamp_min(opt.min_building_fraction)), 0.0)
    return dict(
        itr=itr, air_ext_t=air_ext_t,
        roof_fraction=(inp.building_fraction - bf_above).clamp_min(0.0),
        nbf=nbf, nbf_above=1.0 - bf_above,
        tdc=torch.exp(-air_ext_t * inp.dz / zcos[:, None]),
        fwdc=fwdc,
    )


def _ground_fluxes(outs, dn_dir_fin, dn_diff_fin, up_fin, with_direct, zcos,
                   lg, nreg, top_albedo):
    """Ground and top-of-canopy entries (radsurf_urban_sw.F90:861-876)."""
    C, S = dn_diff_fin.shape[:2]
    ground_dn_dir = zcos[:, None] * dn_dir_fin.sum(-1)
    ground_dn = dn_diff_fin.sum(-1)
    if with_direct:
        ground_dn = ground_dn + ground_dn_dir
    outs["ground_dn"] = ground_dn
    outs["ground_net"] = ground_dn - up_fin.sum(-1)
    tan_over_pi = constant(np.tile(lg.tan_ang, nreg) / Pi, zcos.device, zcos.dtype)
    outs["ground_vertical_diff"] = (dn_diff_fin + up_fin) @ tan_over_pi
    one = torch.ones_like(ground_dn)
    outs["top_dn_dir"] = one if with_direct else torch.zeros_like(one)
    outs["top_dn"] = one
    outs["top_net"] = 1.0 - top_albedo
    return ground_dn_dir


# ----------------------------------------------------------------------
# Scan route (the JAX XLA path, radsurf_urban_sw.F90:590-1001), with the
# log-depth associative sweeps of ops/assoc_adding.py under
# opt.associative_sweeps (JAX solver.py:499, 769)
# ----------------------------------------------------------------------

def _to_layers(x):
    """[C, L, ...] -> [L, C, ...] (a view)."""
    return x.transpose(0, 1)


def _fold(x):
    """[L, C, ...] -> [L*C, ...]: every layer's columns as one batch."""
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


def _down_steps(step, carry, per_layer, per_col, up_names, ups, carry_in=None):
    """Run a downward flux step over every layer: top-down in sequence from
    `carry`, or, given the carry-in of every layer (`carry_in`, [L, C, ...]
    each, from the associative route), once over all layers as one batch of
    L*C columns.  per_layer: {name: [C, L, ...]}; per_col: {name: [C, ...]};
    ups: the up-sweep's per-layer results ([L, C, ...] or per-layer
    sequences) under up_names.  Returns (final carry, {name: [C, L, ...]});
    with carry_in the final carry is None."""
    C, L = next(iter(per_layer.values())).shape[:2]
    if carry_in is None:
        outs = [None] * L
        for l in range(L - 1, -1, -1):
            x = {k: v[:, l] for k, v in per_layer.items()}
            x.update(per_col)
            x.update({k: u[l] for k, u in zip(up_names, ups)})
            carry, outs[l] = step(carry, x)
        return carry, {k: torch.stack([o[k] for o in outs], dim=1)
                       for k in outs[0]}
    x = {k: _fold(_to_layers(v)) for k, v in per_layer.items()}
    x.update({k: v.repeat((L,) + (1,) * (v.ndim - 1)) for k, v in per_col.items()})
    x.update({k: _fold(u) for k, u in zip(up_names, ups)})
    _, out = step(tuple(_fold(c) for c in carry_in), x)
    return None, {k: v.reshape((L, C) + v.shape[1:]).transpose(0, 1)
                  for k, v in out.items()}


def _diffuse_carry_map(T, v_reg, denom, ns):
    """denom^-1 T (v_reg (x) I_ns) of every layer: the map of the diffuse
    downwelling carry across a layer's top interface and through the layer
    ([L, C, S, nd, nd]; v_reg [L, C, nreg, nreg]), the C slot of the
    associative route's affine maps."""
    L, C, S, nd = T.shape[:4]
    nreg = v_reg.shape[-1]
    TV = torch.einsum("lcsirn,lcrq->lcsiqn", T.reshape(L, C, S, nd, nreg, ns), v_reg)
    return solve(denom, TV.reshape(L, C, S, nd, nd))


def _sw_up_layer(a_above, d_above, R, T, E, Sup, Sdn, a_roof, d_roof):
    """One SW adding step short of the overlap into the next interface
    (radsurf_urban_sw.F90:604-643): (denom, a_below, d_below) with the
    exposed-roof rows, on any leading batch dims."""
    nd, nreg = Sup.shape[-2:]
    eye = torch.eye(nd, dtype=R.dtype, device=R.device)
    denom = eye - matmul(a_above, R)
    a_below_reg = R + matmul(T, solve(denom, matmul(a_above, T)))
    d_rhs = matmul(d_above, E) + matmul(a_above, Sdn)
    d_below_reg = Sup + matmul(T, solve(denom, d_rhs))
    nd2 = nd + a_roof.shape[-1]
    a_below = R.new_zeros(R.shape[:-2] + (nd2, nd2))
    a_below[..., :nd, :nd] = a_below_reg
    a_below[..., nd:, nd:] = a_roof
    d_below = R.new_zeros(R.shape[:-2] + (nd2, nreg + 1))
    d_below[..., :nd, :nreg] = d_below_reg
    d_below[..., nd:, nreg] = d_roof
    return denom, a_below, d_below


_SW_UPS = ("a_above", "d_above", "denom", "a_below", "d_below")


def _sw_scan(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
             with_profiles: bool = False):
    front = _sw_front(inp, opt, lg)
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    flat = [g.reshape((C * L * S,) + g.shape[-2:]) for g in front[-1]]
    lay = layer_matrices_chunked(
        *flat, inp.dz[:, :, None].expand(C, L, S).reshape(-1),
        n_double=opt.n_double, chunk=opt.factory_chunk)
    lay = {k: v.reshape((C, L, S) + v.shape[-2:]) for k, v in lay.items()}
    return _sw_adding(inp, opt, lg, with_profiles, front, lay)


def _sw_adding(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
               with_profiles, front, lay):
    """The SW up and down recurrences on the layer operators lay ({name:
    [C, L, S, n, m]}): sequential, or associative with
    opt.associative_sweeps."""
    nreg, ns = opt.nreg, lg.nstream
    nd = nreg * ns
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    dtype, dev = inp.air_ext.dtype, inp.air_ext.device
    t = lambda x: constant(x, dev, dtype)
    mu, hw, tan_s = t(lg.mu), t(lg.hweight), t(lg.tan_ang)
    zcos, sin0, geo, facets, _ = front
    assoc = opt.associative_sweeps
    lay_l = {k: _to_layers(v) for k, v in lay.items()}  # [L, C, S, ...] views

    # ---- upward adding recurrence (radsurf_urban_sw.F90:590-654)
    galb, galb_dir = inp.ground_albedo, inp.ground_albedo_dir
    same_reg = torch.block_diag(*[hw[:, None].expand(ns, ns)] * nreg)
    a_ground = galb[:, :, None, None] * same_reg  # [C, S, nd, nd]
    dmask = torch.block_diag(*[hw[:, None]] * nreg)  # [nd, nreg]
    d_ground = (zcos[:, None] * galb_dir)[:, :, None, None] * dmask
    # exposed-roof rows (radsurf_urban_sw.F90:627-643)
    a_roof = facets["roof_albedo"][..., None, None] * hw[:, None].expand(ns, ns)
    d_roof = (zcos[:, None, None] * facets["roof_albedo_dir"])[..., None] * hw
    up_ops = ("R", "T", "E", "Sup", "Sdn")
    if assoc:
        # all per-layer carry-ins at once by the Redheffer-star prefix, then
        # every layer's step at once (without the overlap into the next
        # interface, which the prefix already holds)
        uov, vov = _to_layers(geo["u_ov"]), _to_layers(geo["v_ov"])
        a_roof_l, d_roof_l = _to_layers(a_roof), _to_layers(d_roof)
        prefix = star_prefix(
            sw_layer_star_elements(*(lay_l[k] for k in up_ops), uov, vov,
                                   a_roof_l, d_roof_l, nreg, ns),
            ground_star_element(a_ground, d_ground, nreg))
        a_above, d_above = prefix["Rd"][-1], prefix["Su"][-1]
        carries = (prefix["Rd"][:-1], prefix["Su"][:-1])
        ups = carries + _sw_up_layer(*carries, *(lay_l[k] for k in up_ops),
                                     a_roof_l, d_roof_l)
    else:
        a_above, d_above = a_ground, d_ground
        steps = []
        for l in range(L):
            ys = _sw_up_layer(a_above, d_above,
                              *(lay[k][:, l] for k in up_ops),
                              a_roof[:, l], d_roof[:, l])
            steps.append((a_above, d_above) + ys)
            a_above = _u_mat_v(geo["u_ov"][:, l], ys[1], geo["v_ov"][:, l], ns)
            d_above = _u_dmat_v(geo["u_ov"][:, l], ys[2], geo["v_ov"][:, l], ns)
        ups = tuple(zip(*steps))  # per name, the L layers' values

    top_albedo_diff = (a_above[..., :ns, :ns] @ hw).sum(-1)
    top_albedo_dir = d_above[..., :ns, 0].sum(-1) / zcos[:, None]
    bc = {"top_albedo_diff": top_albedo_diff, "top_albedo_dir": top_albedo_dir}

    # ---- downward flux recurrences (radsurf_urban_sw.F90:676-1001)
    cs = _clear_sky(inp, opt, geo, zcos)
    eps = torch.finfo(dtype).eps
    per_layer = dict(
        v_ov=geo["v_ov"], fw=geo["f_wall"], od=_pad_od(geo["od_scaling"]),
        ab=inp.air_ext * (1.0 - inp.air_ssa),
        vb=inp.veg_ext[..., None] * (1.0 - inp.veg_ssa),
        wa=facets["wall_albedo"], dz=inp.dz, vfr=inp.veg_fraction,
        **{k: cs[k] for k in ("roof_fraction", "nbf", "nbf_above", "tdc",
                              "fwdc", "air_ext_t")},
        **{k: lay[k] for k in ("R", "T", "E", "Sdn", "int_dir", "int_diff",
                               "int_dir_diff")})
    per_col = dict(zcos=zcos, sin0=sin0, itr=cs["itr"])

    def sweep(with_direct):
        def step(carry, x):
            dn_dir, dn_diff, dn_dir_clear = carry
            zcos, sin0 = x["zcos"], x["sin0"]
            take = lambda v: _take_spec(v, x["itr"])
            c, s = dn_diff.shape[:2]
            dn_dir_below = _ov_dirvec(x["v_ov"], dn_dir)  # [C, S, nreg+1]
            dn_diff_below = _ov_vec(x["v_ov"], dn_diff, ns)  # [C, S, nd2]
            up_below = matvec(x["a_below"], dn_diff_below)
            if with_direct:
                up_below = up_below + matvec(x["d_below"], dn_dir_below)
            out = {}
            # roof fluxes (radsurf_urban_sw.F90:716-721)
            roof_in_dir = zcos[:, None] * dn_dir_below[..., nreg]
            roof_in = dn_diff_below[..., nd:].sum(-1)
            if with_direct:
                roof_in = roof_in + roof_in_dir
                out["roof_in_dir"] = roof_in_dir
            out["roof_in"] = roof_in
            out["roof_net"] = roof_in - up_below[..., nd:].sum(-1)
            # fluxes at layer base (radsurf_urban_sw.F90:723-735)
            if with_direct:
                dn_dir_new = matvec(x["E"], dn_dir_below[..., :nreg])
                refl_dir = matvec(x["d_above"], dn_dir_new)
                rhs = (matvec(x["T"], dn_diff_below[..., :nd])
                       + matvec(x["R"], refl_dir)
                       + matvec(x["Sdn"], dn_dir_below[..., :nreg]))
                dn_diff_new = solve(x["denom"], rhs)
                up_above = matvec(x["a_above"], dn_diff_new) + refl_dir
            else:
                dn_dir_new = dn_dir
                dn_diff_new = solve(x["denom"],
                                    matvec(x["T"], dn_diff_below[..., :nd]))
                up_above = matvec(x["a_above"], dn_diff_new)
            if with_profiles:  # radsurf_urban_sw.F90:737-751
                out["flux_dn_layer_top"] = dn_diff_below[..., :nd].sum(-1)
                out["flux_up_layer_top"] = up_below[..., :nd].sum(-1)
                out["flux_dn_layer_base"] = dn_diff_new.sum(-1)
                out["flux_up_layer_base"] = up_above.sum(-1)
                if with_direct:
                    out["flux_dn_dir_layer_top"] = (
                        zcos[:, None] * dn_dir_below[..., :nreg].sum(-1))
                    out["flux_dn_dir_layer_base"] = zcos[:, None] * dn_dir_new.sum(-1)
                    out["flux_dn_layer_top"] = (
                        out["flux_dn_layer_top"] + out["flux_dn_dir_layer_top"])
                    out["flux_dn_layer_base"] = (
                        out["flux_dn_layer_base"] + out["flux_dn_dir_layer_base"])
            # integrated fluxes (radsurf_urban_sw.F90:753-761)
            conv_diff = (dn_diff_below[..., :nd] - dn_diff_new
                         - up_below[..., :nd] + up_above)
            int_flux_diff = matvec(x["int_diff"], conv_diff)
            if with_direct:
                conv_dir = dn_dir_below[..., :nreg] - dn_dir_new
                int_flux_dir = matvec(x["int_dir"], conv_dir)
                int_flux_diff = int_flux_diff + matvec(x["int_dir_diff"], conv_dir)
            else:
                int_flux_dir = dn_diff.new_zeros((c, s, nreg))
            # absorption (radsurf_urban_sw.F90:763-788)
            ifd = int_flux_diff.reshape(c, s, nreg, ns)
            ifd_mu = ifd @ (1.0 / mu)
            ab, vb = x["ab"], x["vb"]
            out["clear_air_abs"] = ab * (int_flux_dir[..., 0] + ifd_mu[..., 0])
            if nreg > 1:
                odl = x["od"][:, None, :]
                tot = int_flux_dir[..., 1:] + ifd_mu[..., 1:]
                out["veg_air_abs"] = ab * tot.sum(-1)
                out["veg_abs"] = vb * (tot * odl).sum(-1)
                if with_direct:
                    out["veg_abs_dir"] = vb * (int_flux_dir[..., 1:] * odl).sum(-1)
            # walls (radsurf_urban_sw.F90:790-802, 955-963)
            if opt.do_urban:
                wall_in = torch.einsum("cr,csr->cs", x["fw"], ifd @ tan_s)
                if with_direct:
                    wall_in_dir = sin0[:, None] * torch.einsum(
                        "cr,csr->cs", x["fw"], int_flux_dir)
                    out["wall_in_dir"] = wall_in_dir
                    wall_in = wall_in + wall_in_dir
                out["wall_in"] = wall_in
                out["wall_net"] = wall_in * (1.0 - x["wa"])
            # sunlit fractions (radsurf_urban_sw.F90:804-848)
            if with_direct:
                out["roof_sunlit_frac"] = _safe_div(
                    take(roof_in_dir) * x["nbf_above"],
                    zcos * dn_dir_clear
                    * x["roof_fraction"].clamp_min(opt.min_building_fraction))
                dn_dir_clear = dn_dir_clear * x["nbf"] / x["nbf_above"]
                aet = x["air_ext_t"]
                int_dir_clear = torch.where(
                    aet > 0.0,
                    dn_dir_clear * (1.0 - x["tdc"]) * zcos
                    / torch.where(aet > 0.0, aet, 1.0),
                    dn_dir_clear * x["dz"])
                if nreg > 1:
                    vfr = x["vfr"]
                    clear = int_dir_clear * take(vb) * vfr
                    out["veg_sunlit_frac"] = torch.where(
                        vfr >= opt.min_vegetation_fraction,
                        take(out["veg_abs_dir"]) / clear.clamp_min(eps), 0.0)
                if opt.do_urban:
                    out["wall_sunlit_frac"] = 0.5 * take(out["wall_in_dir"]) / (
                        x["fwdc"] * sin0 * int_dir_clear).clamp_min(eps)
                dn_dir_clear = dn_dir_clear * x["tdc"]
            return (dn_dir_new, dn_diff_new, dn_dir_clear), out

        # top of canopy (radsurf_urban_sw.F90:687-700)
        dn_dir = inp.air_ext.new_zeros((C, S, nreg))
        dn_diff = inp.air_ext.new_zeros((C, S, nd))
        if with_direct:
            dn_dir[..., 0] = 1.0 / zcos[:, None]
            dn_dir_clear = 1.0 / zcos
        else:
            dn_diff[..., :ns] = hw
            dn_dir_clear = torch.ones_like(zcos)
        carry_in = None
        if assoc:
            # the downward recurrence is block-affine in its carry: compose
            # the per-layer maps by suffix scan, then every layer at once
            v_reg = _to_layers(geo["v_ov"])[..., :nreg, :]
            Cmap = _diffuse_carry_map(lay_l["T"], v_reg, ups[2], ns)
            if with_direct:
                Amap = torch.einsum("lcspr,lcrw->lcspw", lay_l["E"], v_reg)
                SdnV = torch.einsum("lcsip,lcpw->lcsiw", lay_l["Sdn"], v_reg)
                Bmap = solve(ups[2], matmul(lay_l["R"], matmul(ups[1], Amap)) + SdnV)
                clear = _to_layers(cs["nbf"] / cs["nbf_above"] * cs["tdc"])
            else:
                Amap = torch.eye(nreg, dtype=dtype, device=dev).expand(
                    L, C, S, nreg, nreg)
                Bmap = inp.air_ext.new_zeros((L, C, S, nd, nreg))
                clear = inp.air_ext.new_ones((L, C))
            (dir_in, diff_in), (dn_dir, dn_diff) = affine_down_carries(
                Amap, Bmap, Cmap, dn_dir, dn_diff)
            clear_in, dn_dir_clear = scalar_suffix_carries(clear, dn_dir_clear)
            carry_in = (dir_in, diff_in, clear_in)
        carry, outs = _down_steps(step, (dn_dir, dn_diff, dn_dir_clear),
                                  per_layer, per_col, _SW_UPS, ups, carry_in)
        if carry is not None:
            dn_dir, dn_diff, dn_dir_clear = carry
        # ground (radsurf_urban_sw.F90:861-876)
        up_fin = matvec(a_ground, dn_diff)
        if with_direct:
            up_fin = up_fin + matvec(d_ground, dn_dir)
        gdd = _ground_fluxes(outs, dn_dir, dn_diff, up_fin, with_direct, zcos,
                             lg, nreg, top_albedo_dir if with_direct
                             else top_albedo_diff)
        if with_direct:
            outs["ground_dn_dir"] = gdd
            outs["ground_sunlit_frac"] = _safe_div(_take_spec(gdd, cs["itr"]),
                                                   zcos * dn_dir_clear)
        return outs

    return sweep(True), sweep(False), bc


# ----------------------------------------------------------------------
# Kernel route: K1 -> K2 -> K3 in the struct-of-arrays layout [L, rows, B]
# (B = C*S, b = c*S + s), then the plain-torch epilogue.
# ----------------------------------------------------------------------

def _soa(x):
    """[C, L, S, n, m] -> [L, n*m, C*S] (contiguous)."""
    C, L, S, n, m = x.shape
    return x.permute(1, 3, 4, 0, 2).reshape(L, n * m, C * S).contiguous()


def _soa_cls(x):
    """Per layer and band [C, L, S] -> [L, C*S]."""
    C, L, S = x.shape
    return x.permute(1, 0, 2).reshape(L, C * S).contiguous()


def _unsoa(x, C, S, n, m=None):
    """[L, n*m, C*S] -> [C, L, S, n, m] (without m: [L, n, C*S] ->
    [C, L, S, n]), the inverse of _soa."""
    L = x.shape[0]
    if m is None:
        return x.reshape(L, n, C, S).permute(2, 0, 3, 1)
    return x.reshape(L, n, m, C, S).permute(3, 0, 4, 1, 2)


def _sw_kernel_path(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
                    with_profiles: bool = False):
    nreg, ns = opt.nreg, lg.nstream
    nd = nreg * ns
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    B = C * S
    dtype, dev = inp.air_ext.dtype, inp.air_ext.device
    hw = constant(lg.hweight, dev, dtype)

    front = _sw_front(inp, opt, lg)
    zcos, sin0, geo, facets, (g0, g1, g2, g3) = front
    dz_soa = _soa_cls(inp.dz[:, :, None].expand(C, L, S))
    lay = layer_factory(_soa(g0), _soa(g1), _soa(g2), _soa(g3), dz_soa,
                        nd=nd, ndir=nreg, n_double=opt.n_double,
                        chunk=opt.factory_chunk)
    if opt.associative_sweeps:  # K1 (or K1d), then the associative sweeps
        shapes = dict(R=(nd, nd), T=(nd, nd), E=(nreg, nreg), Sup=(nd, nreg),
                      Sdn=(nd, nreg), int_diff=(nd, nd), int_dir=(nreg, nreg),
                      int_dir_diff=(nd, nreg))
        lay = {k: _unsoa(v, C, S, *shapes[k]) for k, v in lay.items()}
        return _sw_adding(inp, opt, lg, with_profiles, front, lay)

    # ---- K2: up-sweep
    ov = lambda x: x.permute(1, 2, 3, 0).reshape(L, -1, C).contiguous()
    uov, vov = ov(geo["u_ov"]), ov(geo["v_ov"])
    zcos_b = zcos[:, None].expand(C, S).reshape(B).contiguous()
    grd = torch.stack([inp.ground_albedo.reshape(B),
                       inp.ground_albedo_dir.reshape(B), zcos_b])
    stacks, top = sw_up_sweep(
        lay["R"], lay["T"], lay["E"], lay["Sup"], lay["Sdn"], uov, vov,
        _soa_cls(facets["roof_albedo"]), _soa_cls(facets["roof_albedo_dir"]),
        grd, hw, nd=nd, ns=ns, nreg=nreg)
    a_top = top[:nd * nd].t().reshape(C, S, nd, nd)
    d_top = top[nd * nd:].t().reshape(C, S, nd, nreg)
    top_albedo_diff = (a_top[..., :ns, :ns] @ hw).sum(-1)
    top_albedo_dir = d_top[..., :ns, 0].sum(-1) / zcos[:, None]
    bc = {"top_albedo_diff": top_albedo_diff, "top_albedo_dir": top_albedo_dir}

    # ---- K3: both normalizations in one down-sweep.  aux rows per layer:
    # [f_wall (nreg) | od (max(nreg-1, 1)) | ab_coef | vb_coef | wall_albedo]
    ab_coef = inp.air_ext * (1.0 - inp.air_ssa)  # [C, L, S]
    vb_coef = inp.veg_ext[..., None] * (1.0 - inp.veg_ssa)
    per_col = torch.cat([geo["f_wall"], _pad_od(geo["od_scaling"])], dim=-1)
    aux = torch.cat([
        per_col.permute(1, 2, 0)[..., None].expand(-1, -1, C, S).reshape(L, -1, B),
        torch.stack([_soa_cls(ab_coef), _soa_cls(vb_coef),
                     _soa_cls(facets["wall_albedo"])], dim=1),
    ], dim=1)
    rmu = constant(1.0 / lg.mu, dev, dtype)
    rtan = constant(lg.tan_ang, dev, dtype)
    outs, fin = sw_down_sweep_both(
        lay["R"], lay["T"], lay["E"], lay["Sdn"], lay["int_dir"],
        lay["int_diff"], lay["int_dir_diff"], stacks, vov, aux, zcos_b, hw,
        rmu, rtan, nd=nd, ns=ns, nreg=nreg, do_urban=opt.do_urban,
        with_profiles=with_profiles)

    # ---- epilogue: unpack, clear-sky recurrence in closed form, ground
    cs = _clear_sky(inp, opt, geo, zcos)
    itr = cs["itr"]
    g_fac = cs["nbf"] / cs["nbf_above"] * cs["tdc"]
    suffix = torch.flip(torch.cumprod(torch.flip(g_fac, [1]), 1), [1])
    c_in = (1.0 / zcos)[:, None] * torch.cat(
        [suffix[:, 1:], suffix.new_ones((C, 1))], dim=1)
    c_mid = c_in * cs["nbf"] / cs["nbf_above"]
    aet = cs["air_ext_t"]
    int_dir_clear = torch.where(
        aet > 0.0, c_mid * (1.0 - cs["tdc"]) * zcos[:, None]
        / torch.where(aet > 0.0, aet, 1.0), c_mid * inp.dz)
    dn_dir_clear_fin = (1.0 / zcos) * suffix[:, 0]
    eps = torch.finfo(dtype).eps

    row = 0
    results = []
    for with_direct, fin_rows in ((True, fin[:nreg + nd]),
                                  (False, fin[nreg + nd:])):
        names = sw_out_rows(with_direct, opt.do_urban, nreg, with_profiles)
        res = {k: outs[:, row + i].reshape(L, C, S).permute(1, 0, 2)
               for i, k in enumerate(names)}
        row += len(names)
        if with_direct:
            dn_dir_fin = fin_rows[:nreg].t().reshape(C, S, nreg)
            dn_diff_fin = fin_rows[nreg:].t().reshape(C, S, nd)
        else:
            dn_dir_fin = inp.air_ext.new_zeros((C, S, nreg))
            dn_diff_fin = fin_rows.t().reshape(C, S, nd)
        # ground operators applied without forming them
        dsum = dn_diff_fin.reshape(C, S, nreg, ns).sum(-1)
        up = inp.ground_albedo[..., None, None] * hw * dsum[..., None]
        if with_direct:
            up = up + ((zcos[:, None] * inp.ground_albedo_dir)[..., None, None]
                       * hw * dn_dir_fin[..., None])
        gdd = _ground_fluxes(res, dn_dir_fin, dn_diff_fin, up.reshape(C, S, nd),
                             with_direct, zcos, lg, nreg,
                             top_albedo_dir if with_direct else top_albedo_diff)
        if with_direct:
            res["ground_dn_dir"] = gdd
            res["ground_sunlit_frac"] = _safe_div(_take_spec(gdd, itr),
                                                  zcos * dn_dir_clear_fin)
            res["roof_sunlit_frac"] = _safe_div(
                _take_spec(res["roof_in_dir"], itr) * cs["nbf_above"],
                zcos[:, None] * c_in
                * cs["roof_fraction"].clamp_min(opt.min_building_fraction))
            if nreg > 1:
                clear = int_dir_clear * _take_spec(vb_coef, itr) * inp.veg_fraction
                res["veg_sunlit_frac"] = torch.where(
                    inp.veg_fraction >= opt.min_vegetation_fraction,
                    _take_spec(res["veg_abs_dir"], itr) / clear.clamp_min(eps),
                    0.0)
            if opt.do_urban:
                res["wall_sunlit_frac"] = 0.5 * _take_spec(
                    res["wall_in_dir"], itr) / (
                    cs["fwdc"] * sin0[:, None] * int_dir_clear).clamp_min(eps)
        results.append(res)
    return results[0], results[1], bc


# ----------------------------------------------------------------------
# Longwave (radsurf_urban_lw.F90:35-883; forest = radsurf_forest_lw.F90 via
# building_fraction = 0)
# ----------------------------------------------------------------------

def _lw_front(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss):
    """Geometry, facet properties, the diffuse Gamma matrices, the emission
    rates and the emission bookkeeping of the LW solve."""
    nreg = opt.nreg
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    geo = _prepare_geometry(inp, opt, lg, lw=True)
    frac = geo["frac"]
    ones = inp.air_ext.new_ones((C, L, S))
    # Walls fully intercept (radsurf_urban_lw.F90:384-392); the full
    # spectral wall emissivity scatters (the reference's band-1 value is
    # the same for nlw = 1).  Forests: black, non-emitting facets.
    if opt.do_urban:
        facets = dict(wall_emissivity=inp.wall_emissivity,
                      wall_emission=inp.wall_emission,
                      roof_emissivity=inp.roof_emissivity,
                      roof_emission=inp.roof_emission)
        wall_factor = 1.0 - inp.wall_emissivity
    else:
        zeros = torch.zeros_like(ones)
        facets = dict(wall_emissivity=ones, wall_emission=zeros,
                      roof_emissivity=ones, roof_emission=zeros)
        wall_factor = zeros
    ext_reg, ssa_reg, planck_reg = G.region_optics_lw(
        inp.air_ext, inp.air_ssa, inp.clear_air_planck, inp.veg_ext,
        inp.veg_ssa, inp.veg_planck, inp.veg_air_planck, geo["od_scaling"],
        nreg)
    _, g1, g2, _ = G.assemble_gammas(ext_reg, ssa_reg, geo["f_exchange"],
                                     geo["f_wall"], ones, wall_factor, lg,
                                     nreg)
    em = G.emission_rates(ext_reg, ssa_reg, planck_reg, frac,
                          geo["norm_perim_wall"], facets["wall_emission"], lg,
                          nreg)

    # Emission bookkeeping (radsurf_urban_lw.F90:446-477)
    emiss_factor = 2.0 * float(np.sum(np.asarray(lg.hweight)
                                      / np.asarray(lg.mu)))
    em["emiss_reg"] = emiss_factor * em["volume_emiss"]  # [C, L, S, nreg]
    if nreg > 1:
        # clear-air properties (radsurf_urban_lw.F90:466-469)
        air_src = inp.air_ext * (1.0 - inp.air_ssa) * inp.veg_air_planck
        em["emiss_air"] = emiss_factor * frac[..., None, 1:] * air_src[..., None]
        em["emiss_veg"] = (emiss_factor * frac[..., None, 1:]
                           * (inp.veg_ext[..., None] * (1.0 - inp.veg_ssa)
                              * inp.veg_planck)[..., None]
                           * geo["od_scaling"][..., None, :])
    else:
        em["emiss_air"] = em["emiss_veg"] = inp.air_ext.new_zeros((C, L, S, 1))
    em["emiss_wall"] = (geo["norm_perim_wall"].sum(-1)[..., None]
                        * lg.vadjustment * facets["wall_emission"])  # [C, L, S]
    # Exposed-roof fraction at the top of each layer
    # (radsurf_urban_lw.F90:589-599; zero for forests, _sanitize_forest)
    bf_above = torch.cat([inp.building_fraction[:, 1:],
                          inp.building_fraction.new_zeros((C, 1))], dim=1)
    facets["exposed_roof"] = (inp.building_fraction - bf_above).clamp_min(0.0)
    return geo, facets, (g1, g2), em


def _lw_top_bc(a_top, source_top, hw, ns):
    """Top-of-canopy emissivity and emission (radsurf_urban_lw.F90:629-637)."""
    return {"top_emissivity": 1.0 - (a_top[..., :ns, :ns] @ hw).sum(-1),
            "top_emission": source_top[..., :ns].sum(-1)}


def _lw_ground_fluxes(outs, dn_fin, up_fin, with_source, lg, nreg, bc):
    """Ground and top-of-canopy entries (radsurf_urban_lw.F90:806-828)."""
    dtype, dev = dn_fin.dtype, dn_fin.device
    outs["ground_dn"] = dn_fin.sum(-1)
    outs["ground_net"] = outs["ground_dn"] - up_fin.sum(-1)
    tan_over_pi = constant(np.tile(lg.tan_ang, nreg) / Pi, dev, dtype)
    outs["ground_vertical_diff"] = (dn_fin + up_fin) @ tan_over_pi
    if with_source:
        outs["top_dn"] = torch.zeros_like(outs["ground_dn"])
        outs["top_net"] = -bc["top_emission"]
    else:
        outs["top_dn"] = torch.ones_like(outs["ground_dn"])
        outs["top_net"] = bc["top_emissivity"]
    return outs


def _lw_up_layer(a_above, source_above, R, T, p, a_roof, source_roof):
    """One LW adding step short of the overlap into the next interface
    (radsurf_urban_lw.F90:567-614): (denom, a_below, source_below) with the
    exposed-roof rows, on any leading batch dims."""
    nd = R.shape[-1]
    eye = torch.eye(nd, dtype=R.dtype, device=R.device)
    denom = eye - matmul(a_above, R)
    a_below_reg = R + matmul(T, solve(denom, matmul(a_above, T)))
    # Eq. 34 (radsurf_urban_lw.F90:583-587)
    src_rhs = solve(denom, source_above + matvec(a_above, p))
    nd2 = nd + a_roof.shape[-1]
    a_below = R.new_zeros(R.shape[:-2] + (nd2, nd2))
    a_below[..., :nd, :nd] = a_below_reg
    a_below[..., nd:, nd:] = a_roof
    source_below = torch.cat([p + matvec(T, src_rhs), source_roof], dim=-1)
    return denom, a_below, source_below


_LW_UPS = ("a_above", "source_above", "denom", "a_below", "source_below")


def _lw_scan(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
             with_profiles: bool = False):
    front = _lw_front(inp, opt, lg)
    g1, g2 = front[2]
    em = front[3]
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    nd = opt.nreg * lg.nstream
    N = C * L * S
    lay = lw_layer_matrices_chunked(
        g1.reshape(N, nd, nd), g2.reshape(N, nd, nd),
        em["emiss_rate"].reshape(N, nd),
        inp.dz[:, :, None].expand(C, L, S).reshape(N),
        n_double=opt.n_double, chunk=opt.factory_chunk)
    lay = {k: v.reshape((C, L, S) + v.shape[1:]) for k, v in lay.items()}
    return _lw_adding(inp, opt, lg, with_profiles, front, lay)


def _lw_adding(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
               with_profiles, front, lay):
    """The LW up and down recurrences on the layer operators lay ({name:
    [C, L, S, ...]}): sequential, or associative with
    opt.associative_sweeps."""
    nreg, ns = opt.nreg, lg.nstream
    nd = nreg * ns
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    dtype, dev = inp.air_ext.dtype, inp.air_ext.device
    t = lambda x: constant(x, dev, dtype)
    mu, hw, tan_s = t(lg.mu), t(lg.hweight), t(lg.tan_ang)
    geo, facets, _, em = front
    assoc = opt.associative_sweeps
    lay_l = {k: _to_layers(v) for k, v in lay.items()}  # [L, C, S, ...] views

    # ---- ground operators (radsurf_urban_lw.F90:551-565)
    same_reg = torch.block_diag(*[hw[:, None].expand(ns, ns)] * nreg)
    a_ground = (1.0 - inp.ground_emissivity)[:, :, None, None] * same_reg
    frac0 = geo["frac"][:, 0, :]  # lowest-layer fractions [C, nreg]
    source_ground = (inp.ground_emission[:, :, None]
                     * (frac0[:, :, None] * hw).reshape(C, 1, nd))  # [C, S, nd]

    # ---- upward adding recurrence (radsurf_urban_lw.F90:567-627)
    a_roof = ((1.0 - facets["roof_emissivity"])[..., None, None]
              * hw[:, None].expand(ns, ns))
    source_roof = (facets["roof_emission"]
                   * facets["exposed_roof"][..., None])[..., None] * hw
    up_ops = ("R", "T", "p")
    if assoc:
        # emission rides as a width-1 source channel through the star prefix
        a_roof_l, source_roof_l = _to_layers(a_roof), _to_layers(source_roof)
        prefix = star_prefix(
            lw_layer_star_elements(*(lay_l[k] for k in up_ops),
                                   _to_layers(geo["u_ov"]),
                                   _to_layers(geo["v_ov"]), a_roof_l,
                                   source_roof_l, nreg, ns),
            ground_star_element(a_ground, source_ground[..., None], 1))
        a_above, source_above = prefix["Rd"][-1], prefix["Su"][-1][..., 0]
        carries = (prefix["Rd"][:-1], prefix["Su"][:-1, ..., 0])
        ups = carries + _lw_up_layer(*carries, *(lay_l[k] for k in up_ops),
                                     a_roof_l, source_roof_l)
    else:
        a_above, source_above = a_ground, source_ground
        steps = []
        for l in range(L):
            ys = _lw_up_layer(a_above, source_above,
                              *(lay[k][:, l] for k in up_ops),
                              a_roof[:, l], source_roof[:, l])
            steps.append((a_above, source_above) + ys)
            a_above = _u_mat_v(geo["u_ov"][:, l], ys[1], geo["v_ov"][:, l], ns)
            source_above = _ov_vec(geo["u_ov"][:, l], ys[2], ns)
        ups = tuple(zip(*steps))  # per name, the L layers' values
    bc = _lw_top_bc(a_above, source_above, hw, ns)

    # ---- downward flux recurrences (radsurf_urban_lw.F90:639-858)
    per_layer = dict(
        v_ov=geo["v_ov"], fw=geo["f_wall"], od=_pad_od(geo["od_scaling"]),
        ab=inp.air_ext * (1.0 - inp.air_ssa),
        vb=inp.veg_ext[..., None] * (1.0 - inp.veg_ssa),
        weps=facets["wall_emissivity"], dz=inp.dz,
        er=em["emiss_reg"][..., 0], ea=em["emiss_air"].sum(-1),
        ev=em["emiss_veg"].sum(-1), ew=em["emiss_wall"],
        **{k: lay[k] for k in ("R", "T", "p", "int_diff", "int_source")})

    def sweep(with_source):
        def step(carry, x):
            dn, = carry
            dz_l = x["dz"][:, None]
            dn_below = _ov_vec(x["v_ov"], dn, ns)  # [C, S, nd2]
            up_below = matvec(x["a_below"], dn_below)
            if with_source:
                up_below = up_below + x["source_below"]
            out = {"roof_in": dn_below[..., nd:].sum(-1)}
            out["roof_net"] = out["roof_in"] - up_below[..., nd:].sum(-1)
            rhs = matvec(x["T"], dn_below[..., :nd])
            if with_source:
                rhs = rhs + matvec(x["R"], x["source_above"]) + x["p"]
            dn_new = solve(x["denom"], rhs)
            up_above = matvec(x["a_above"], dn_new)
            if with_source:
                up_above = up_above + x["source_above"]
            if with_profiles:
                out["flux_dn_layer_top"] = dn_below[..., :nd].sum(-1)
                out["flux_up_layer_top"] = up_below[..., :nd].sum(-1)
                out["flux_dn_layer_base"] = dn_new.sum(-1)
                out["flux_up_layer_base"] = up_above.sum(-1)
            conv = dn_below[..., :nd] - dn_new - up_below[..., :nd] + up_above
            int_flux = matvec(x["int_diff"], conv)
            if with_source:
                int_flux = int_flux + x["int_source"]
            iflux = int_flux.reshape(int_flux.shape[:2] + (nreg, ns))
            if_mu = iflux @ (1.0 / mu)
            ab, vb = x["ab"], x["vb"]
            out["clear_air_abs"] = ab * if_mu[..., 0]
            if nreg > 1:
                out["veg_air_abs"] = ab * if_mu[..., 1:].sum(-1)
                out["veg_abs"] = vb * (if_mu[..., 1:] * x["od"][:, None, :]).sum(-1)
            if with_source:
                out["clear_air_abs"] = out["clear_air_abs"] - x["er"] * dz_l
                if nreg > 1:
                    out["veg_air_abs"] = out["veg_air_abs"] - x["ea"] * dz_l
                    out["veg_abs"] = out["veg_abs"] - x["ev"] * dz_l
            if opt.do_urban:
                out["wall_in"] = torch.einsum("cr,csr->cs", x["fw"],
                                              iflux @ tan_s)
                out["wall_net"] = out["wall_in"] * x["weps"]
                if with_source:
                    out["wall_net"] = out["wall_net"] - x["ew"] * dz_l
            return (dn_new,), out

        dn = inp.air_ext.new_zeros((C, S, nd))
        if not with_source:
            dn[..., :ns] = hw
        carry_in = None
        if assoc:
            # affine carry maps with the emission constant in the B slot,
            # over a frozen width-1 channel pinned at 1
            Cmap = _diffuse_carry_map(lay_l["T"], _to_layers(geo["v_ov"])[..., :nreg, :],
                                      ups[2], ns)
            if with_source:
                Bmap = solve(ups[2], matvec(lay_l["R"], ups[1]) + lay_l["p"])[..., None]
            else:
                Bmap = inp.air_ext.new_zeros((L, C, S, nd, 1))
            (_, dn_in), (_, dn) = affine_down_carries(
                inp.air_ext.new_ones((L, C, S, 1, 1)), Bmap, Cmap,
                inp.air_ext.new_ones((C, S, 1)), dn)
            carry_in = (dn_in,)
        carry, outs = _down_steps(step, (dn,), per_layer, {}, _LW_UPS, ups,
                                  carry_in)
        if carry is not None:
            dn, = carry
        up_fin = matvec(a_ground, dn)
        if with_source:
            up_fin = up_fin + source_ground
        return _lw_ground_fluxes(outs, dn, up_fin, with_source, lg, nreg, bc)

    return sweep(True), sweep(False), bc


def _lw_kernel_path(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
                    with_profiles: bool = False):
    """K1 (LW mode) -> K4 -> K5 in the [L, rows, B] layout (B = C*S), then
    the ground fluxes in closed form (cf. JAX _lw_pallas_path); with
    opt.associative_sweeps, K1 then the associative sweeps."""
    nreg, ns = opt.nreg, lg.nstream
    nd = nreg * ns
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    B = C * S
    dtype, dev = inp.air_ext.dtype, inp.air_ext.device
    t = lambda x: constant(x, dev, dtype)
    hw = t(lg.hweight)

    front = _lw_front(inp, opt, lg)
    geo, facets, (g1, g2), em = front
    dz_cls = inp.dz[:, :, None].expand(C, L, S)
    lay = lw_layer_factory(_soa(g1), _soa(g2), _soa(em["emiss_rate"][..., None]),
                           _soa_cls(dz_cls), nd=nd, n_double=opt.n_double,
                           chunk=opt.factory_chunk)
    if opt.associative_sweeps:
        lay = {k: _unsoa(v, C, S, nd, nd if k in ("R", "T", "int_diff") else None)
               for k, v in lay.items()}
        return _lw_adding(inp, opt, lg, with_profiles, front, lay)

    # ---- K4: up-sweep
    ov = lambda x: x.permute(1, 2, 3, 0).reshape(L, -1, C).contiguous()
    uov, vov = ov(geo["u_ov"]), ov(geo["v_ov"])
    frac0 = geo["frac"][:, 0, :, None].expand(C, nreg, S)  # [C, nreg, S]
    grd = torch.cat([inp.ground_emissivity.reshape(1, B),
                     inp.ground_emission.reshape(1, B),
                     frac0.permute(1, 0, 2).reshape(nreg, B)]).contiguous()
    exposed = facets["exposed_roof"][..., None].expand(C, L, S)
    stacks, top = lw_up_sweep(
        lay["R"], lay["T"], lay["p"], uov, vov,
        _soa_cls(facets["roof_emissivity"]), _soa_cls(facets["roof_emission"]),
        _soa_cls(exposed), grd, hw, nd=nd, ns=ns, nreg=nreg)
    bc = _lw_top_bc(top[:nd * nd].t().reshape(C, S, nd, nd),
                    top[nd * nd:].t().reshape(C, S, nd), hw, ns)

    # ---- K5: both source modes in one down-sweep.  aux rows per layer:
    # [f_wall (nreg) | od (max(nreg-1, 1)) | ab_coef | vb_coef |
    #  wall_emissivity | sub_air | sub_vegair | sub_veg | sub_wall]
    dz_cs = inp.dz[:, :, None]
    per_col = torch.cat([geo["f_wall"], _pad_od(geo["od_scaling"])], dim=-1)
    per_band = [inp.air_ext * (1.0 - inp.air_ssa),
                inp.veg_ext[..., None] * (1.0 - inp.veg_ssa),
                facets["wall_emissivity"],
                em["emiss_reg"][..., 0] * dz_cs,
                em["emiss_air"].sum(-1) * dz_cs,
                em["emiss_veg"].sum(-1) * dz_cs,
                em["emiss_wall"] * dz_cs]
    aux = torch.cat([
        per_col.permute(1, 2, 0)[..., None].expand(-1, -1, C, S).reshape(L, -1, B),
        torch.stack([_soa_cls(x.expand(C, L, S)) for x in per_band], dim=1),
    ], dim=1)
    outs, fin = lw_down_sweep_both(
        lay["R"], lay["T"], lay["p"], lay["int_diff"], lay["int_source"],
        stacks, vov, aux, hw, t(1.0 / np.asarray(lg.mu)), t(lg.tan_ang),
        nd=nd, ns=ns, nreg=nreg, do_urban=opt.do_urban,
        with_profiles=with_profiles)

    # ---- unpack; ground fluxes without forming the ground operators
    names = lw_out_rows(opt.do_urban, nreg, with_profiles)
    geps, gemit = inp.ground_emissivity, inp.ground_emission
    results = []
    for mode, with_source in enumerate((True, False)):
        rows = outs[:, mode * len(names):(mode + 1) * len(names)]
        res = {k: rows[:, i].reshape(L, C, S).permute(1, 0, 2)
               for i, k in enumerate(names)}
        dn_fin = fin[mode * nd:(mode + 1) * nd].t().reshape(C, S, nd)
        dsum = dn_fin.reshape(C, S, nreg, ns).sum(-1)
        up = (1.0 - geps)[..., None, None] * hw * dsum[..., None]
        if with_source:
            up = up + gemit[..., None, None] * geo["frac"][:, None, 0, :, None] * hw
        results.append(_lw_ground_fluxes(res, dn_fin, up.reshape(C, S, nd),
                                         with_source, lg, nreg, bc))
    return results[0], results[1], bc


# ----------------------------------------------------------------------
# Public entry point
# ----------------------------------------------------------------------

def _resolve_column_chunk(opt: SolverOptions, lg, C: int, L: int, S: int,
                          dtype, device, *, lw: bool, route: str,
                          with_profiles: bool = False, budget=None) -> int:
    """Resolve the column_chunk sentinel: -1 = AUTO.  On the kernel route
    (K1-K5; not under associative_sweeps, whose sweeps are plain torch)
    AUTO takes the whole batch where the working-set model
    (utils/device_memory.py) says that one solve of the C columns fits the
    device's budget (device_budget, or `budget` bytes where given), else
    the fewest equal chunks that fit; elsewhere, and on the CPU, whose
    budget is unbounded, 0.  Explicit values pass through.  Chunked, every
    chunk's outputs are kept and then concatenated: that takes twice the
    outputs of the C columns besides one chunk's transient.  On CUDA the
    solve is captured as a CUDA graph at its second call, whose pool holds
    up to CAPTURE_FACTOR x the transient (utils/device_memory.py): the
    plan is for that, so that the capture fits as the eager call does."""
    ck = opt.column_chunk
    if ck != -1:
        return ck
    if route != "kernel" or opt.associative_sweeps:
        return 0
    if budget is None:
        budget = DM.device_budget(device)
    transient, kept = DM.solve_bytes(C, L, S, opt.nreg, lg.nstream,
                                     torch.finfo(dtype).bits // 8, lw=lw,
                                     do_urban=opt.do_urban, with_profiles=with_profiles)
    if torch.device(device).type == "cuda":
        transient *= DM.CAPTURE_FACTOR
    if transient <= budget:
        return 0
    room = budget - 2 * kept
    if room <= 0 or transient / C > room:
        raise RuntimeError(
            f"column_chunk=-1: not one column fits the device budget of"
            f" {budget / 2**30:.3g} GiB ({C} columns x {L} layers x {S} bands"
            f" hold {2 * kept / 2**30:.3g} GiB of outputs); stream the"
            " columns instead (parallel/streaming.py)")
    n_chunks = math.ceil(transient / room)
    return -(-C // n_chunks)


def resolve_chunk(opt: SolverOptions, lg, C: int, L: int, S: int, dtype,
                  device, *, lw: bool, route: str, with_profiles: bool = False,
                  budget=None) -> SolverOptions:
    """opt with its column chunk resolved (_resolve_column_chunk)."""
    return replace(opt, column_chunk=_resolve_column_chunk(
        opt, lg, C, L, S, dtype, device, lw=lw, route=route,
        with_profiles=with_profiles, budget=budget))


def _chunked_solve(impl, inp: CanopyInputs, opt: SolverOptions, lg,
                   with_profiles, *, lw: bool, route: str, budget=None):
    """Solve in chunks of opt.column_chunk columns (0: the whole batch, -1:
    AUTO, _resolve_column_chunk); the chunk, resolved, is in the options
    each chunk's solve gets (it keys the chunk's graph, _compiled)."""
    C, L = inp.dz.shape
    opt = resolve_chunk(opt, lg, C, L, inp.air_ext.shape[-1],
                        inp.air_ext.dtype, inp.air_ext.device, lw=lw,
                        route=route, with_profiles=with_profiles, budget=budget)
    ck = opt.column_chunk
    if not ck or C <= ck:
        return impl(inp, opt, lg, with_profiles)
    parts = [impl(replace(inp, **{k: x[i:i + ck] for k, x in inp.tensors()}),
                  opt, lg, with_profiles) for i in range(0, C, ck)]
    return tuple({k: torch.cat([p[j][k] for p in parts]) for k in parts[0][j]}
                 for j in range(3))


def _coerce_dtype(inp: CanopyInputs) -> CanopyInputs:
    """Cast every field to one working dtype (air_ext's)."""
    dtype = inp.air_ext.dtype
    kw = {k: x.to(dtype) for k, x in inp.tensors() if x.dtype != dtype}
    return replace(inp, **kw) if kw else inp


def _sanitize_forest(inp: CanopyInputs, opt: SolverOptions) -> CanopyInputs:
    """Forest solves ignore building inputs (radsurf_forest_sw.F90:226-234):
    input files may carry -1 sentinels there."""
    if opt.do_urban:
        return inp
    return replace(inp, building_fraction=torch.zeros_like(inp.building_fraction))


class _KernelRouteGrad(torch.autograd.Function):
    """The kernel route under reverse-mode autograd (JAX _sw_diff /
    _lw_diff, solver.py:1776-1825): the kernels have no backward of their
    own, but compute the same function as the scan route, so the scan
    route's gradient is theirs.  Forward: the kernel route (its CUDA
    kernels on CUDA tensors), saving only the inputs, as JAX's residual is
    the input.  Backward: the scan route recomputed on the saved inputs with
    the same options, associative_sweeps included, differentiated against
    the cotangents.  Inputs and outputs cross as flat tuples: the set
    fields `names` of CanopyInputs in, the three output dicts out, whose
    keys the forward appends to `keys`."""

    @staticmethod
    def forward(ctx, kernel, scan, opt, lg, with_profiles, lw, names, keys,
                *tensors):
        outs = _compiled(kernel, CanopyInputs(**dict(zip(names, tensors))),
                         opt, lg, with_profiles, lw)
        keys.extend(list(d) for d in outs)
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        ctx.setup = (scan, opt, lg, with_profiles, names, list(keys))
        return tuple(d[k] for d in outs for k in d)

    @staticmethod
    def backward(ctx, *cts):
        scan, opt, lg, with_profiles, names, keys = ctx.setup
        need = ctx.needs_input_grad[8:]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, need)]
            outs = scan(CanopyInputs(**dict(zip(names, xs))), opt, lg,
                        with_profiles)
            flat = [d[k] for d, ks in zip(outs, keys) for k in ks]
            pairs = [(o, c) for o, c in zip(flat, cts)
                     if c is not None and o.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], [x for x in xs if x.requires_grad],
                [c for _, c in pairs], allow_unused=True) if pairs else ())
        return (None,) * 8 + tuple(next(grads, None) if n else None
                                   for n in need)


def _needs_grad(x) -> bool:
    """Whether autograd must see through a solve with input x: reverse mode
    (grad mode on and x requires grad), or a forward-mode dual tensor, which
    _KernelRouteGrad refuses (no jvp, as JAX's custom_vjp has none)."""
    return ((torch.is_grad_enabled() and x.requires_grad)
            or fwAD.unpack_dual(x).tangent is not None)


def _compiled(kernel, inp: CanopyInputs, opt: SolverOptions, lg,
              with_profiles, lw: bool):
    """kernel(inp, opt, lg, with_profiles) as a compiled program
    (utils/graphs.py; JAX: jax.jit with static opt, lg and with_profiles):
    on CUDA tensors a CUDA graph per (kernel, opt with its resolved column
    chunk, nstream, with_profiles, the inputs' shapes, dtype and device),
    captured at the second call and replayed from then on.  The call needs
    the working-set model's transient bytes (utils/device_memory.py)."""
    named = inp.tensors()
    names = tuple(n for n, _ in named)
    C, L = inp.dz.shape
    need = DM.solve_bytes(C, L, inp.air_ext.shape[-1], opt.nreg, lg.nstream,
                          inp.air_ext.element_size(), lw=lw, do_urban=opt.do_urban,
                          with_profiles=with_profiles)[0]
    return graphs.call(
        (kernel, opt, lg.nstream, with_profiles, names),
        lambda *xs: kernel(CanopyInputs(**dict(zip(names, xs))), opt, lg,
                           with_profiles),
        [x for _, x in named], need=need)


def _with_grad(kernel, scan, lw: bool):
    """The kernel route `kernel` as a solve: a compiled program
    (_compiled), or, where an input needs a gradient, through
    _KernelRouteGrad with `scan` as its backward (one Function per column
    chunk, so a backward recomputes one chunk's scan graph at a time)."""
    def impl(inp, opt, lg, with_profiles):
        named = inp.tensors()
        if not any(_needs_grad(x) for _, x in named):
            return _compiled(kernel, inp, opt, lg, with_profiles, lw)
        keys = []
        flat = iter(_KernelRouteGrad.apply(
            kernel, scan, opt, lg, with_profiles, lw, [n for n, _ in named], keys,
            *(x for _, x in named)))
        return tuple({k: next(flat) for k in ks} for ks in keys)
    return impl


_ROUTES = {"kernel": _with_grad(_sw_kernel_path, _sw_scan, False), "scan": _sw_scan}
_LW_ROUTES = {"kernel": _with_grad(_lw_kernel_path, _lw_scan, True), "scan": _lw_scan}


def spartacus_sw(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
                 with_profiles: bool = False, route: str = "kernel",
                 budget=None):
    """Shortwave solve for one column group.

    Returns (norm_dir, norm_diff, bc): flux dicts normalized by the
    top-of-canopy direct / diffuse downwelling flux, and
    bc = {"top_albedo_diff", "top_albedo_dir"} [C, S].
    route: "kernel" (K1 -> K2 -> K3; CUDA kernels on CUDA tensors, their
    plain versions on CPU tensors) or "scan" (the plain reference).
    budget: the bytes an AUTO column chunk may plan for (default: the
    inputs' device_budget).  Parity: radsurf_urban_sw.F90:35-1007.
    """
    return _chunked_solve(_ROUTES[route],
                          _coerce_dtype(_sanitize_forest(inp, opt)),
                          opt, lg, with_profiles, lw=False, route=route,
                          budget=budget)


def spartacus_lw(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
                 with_profiles: bool = False, route: str = "kernel",
                 budget=None):
    """Longwave solve for one column group.

    Returns (internal, norm, bc): `internal` holds the fluxes from emission
    within the canopy, `norm` those normalized by unit top-of-canopy
    downwelling, and bc = {"top_emissivity", "top_emission"} [C, S].
    route: "kernel" (K1 in LW mode -> K4 -> K5; CUDA kernels on CUDA
    tensors, their plain versions on CPU tensors) or "scan" (the plain
    reference).  budget: as for spartacus_sw.  Parity:
    radsurf_urban_lw.F90:35-883.
    """
    return _chunked_solve(_LW_ROUTES[route],
                          _coerce_dtype(_sanitize_forest(inp, opt)),
                          opt, lg, with_profiles, lw=True, route=route,
                          budget=budget)
