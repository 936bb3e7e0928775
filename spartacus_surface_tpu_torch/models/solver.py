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
      plain PyTorch versions.  Forward only.
  scan route (``route="scan"``): the reference formulation of the JAX XLA
      path, layer_matrices plus a Python loop per layer for the up and down
      recurrences (radsurf_urban_sw.F90:590-1001, radsurf_urban_lw.F90:
      551-858).  Plain torch on any device; the port's whole-solve
      reference.

The cosine of the solar zenith angle is clamped to >= 1e-6 throughout
(radsurf_urban_sw.F90:268).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..ops.layer_kernel import layer_factory, lw_layer_factory
from ..ops.layer_matrices import layer_matrices_chunked, lw_layer_matrices_chunked
from ..ops.legendre_gauss import LegendreGauss
from ..ops.lw_sweep_kernels import lw_down_sweep_both, lw_out_rows, lw_up_sweep
from ..ops.matrix import matmul, matvec, solve
from ..ops.sweep_kernels import sw_down_sweep_both, sw_out_rows, sw_up_sweep
from ..utils.constants import Pi
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
    # Solve in chunks of this many columns (0 = whole batch).
    column_chunk: int = 0


# ----------------------------------------------------------------------
# Shared front end: geometry and Gamma assembly
# ----------------------------------------------------------------------

def _prepare_geometry(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
                      lw: bool):
    nreg = opt.nreg
    frac = region_fracs(inp.veg_fraction, inp.building_fraction, nreg)
    u_ov, v_ov = overlap_matrices_urban(frac, nreg, opt.min_vegetation_fraction)
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
    tan_over_pi = torch.as_tensor(np.tile(lg.tan_ang, nreg) / Pi,
                                  dtype=zcos.dtype, device=zcos.device)
    outs["ground_vertical_diff"] = (dn_diff_fin + up_fin) @ tan_over_pi
    one = torch.ones_like(ground_dn)
    outs["top_dn_dir"] = one if with_direct else torch.zeros_like(one)
    outs["top_dn"] = one
    outs["top_net"] = 1.0 - top_albedo
    return ground_dn_dir


# ----------------------------------------------------------------------
# Scan route (the JAX XLA path, radsurf_urban_sw.F90:590-1001)
# ----------------------------------------------------------------------

def _sw_scan(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
             with_profiles: bool = False):
    nreg, ns = opt.nreg, lg.nstream
    nd = nreg * ns
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    dtype, dev = inp.air_ext.dtype, inp.air_ext.device
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    mu, hw, tan_s = t(lg.mu), t(lg.hweight), t(lg.tan_ang)

    zcos, sin0, geo, facets, gammas = _sw_front(inp, opt, lg)
    flat = [g.reshape((C * L * S,) + g.shape[-2:]) for g in gammas]
    lay = layer_matrices_chunked(
        *flat, inp.dz[:, :, None].expand(C, L, S).reshape(-1),
        n_double=opt.n_double, chunk=opt.factory_chunk)
    lay = {k: v.reshape((C, L, S) + v.shape[-2:]) for k, v in lay.items()}

    # ---- upward adding recurrence (radsurf_urban_sw.F90:590-654)
    galb, galb_dir = inp.ground_albedo, inp.ground_albedo_dir
    same_reg = torch.block_diag(*[hw[:, None].expand(ns, ns)] * nreg)
    a_ground = galb[:, :, None, None] * same_reg  # [C, S, nd, nd]
    dmask = torch.block_diag(*[hw[:, None]] * nreg)  # [nd, nreg]
    d_ground = (zcos[:, None] * galb_dir)[:, :, None, None] * dmask
    eye = torch.eye(nd, dtype=dtype, device=dev)
    a_roof_m = hw[:, None].expand(ns, ns)
    nd2 = (nreg + 1) * ns

    a_above, d_above = a_ground, d_ground
    ups = []
    for l in range(L):
        R, T, E = lay["R"][:, l], lay["T"][:, l], lay["E"][:, l]
        Sup, Sdn = lay["Sup"][:, l], lay["Sdn"][:, l]
        denom = eye - matmul(a_above, R)
        a_below_reg = R + matmul(T, solve(denom, matmul(a_above, T)))
        d_rhs = matmul(d_above, E) + matmul(a_above, Sdn)
        d_below_reg = Sup + matmul(T, solve(denom, d_rhs))
        # exposed-roof rows (radsurf_urban_sw.F90:627-643)
        a_below = inp.air_ext.new_zeros((C, S, nd2, nd2))
        a_below[..., :nd, :nd] = a_below_reg
        a_below[..., nd:, nd:] = (facets["roof_albedo"][:, l, :, None, None]
                                  * a_roof_m)
        d_below = inp.air_ext.new_zeros((C, S, nd2, nreg + 1))
        d_below[..., :nd, :nreg] = d_below_reg
        d_below[..., nd:, nreg] = (
            zcos[:, None] * facets["roof_albedo_dir"][:, l])[..., None] * hw
        ups.append((a_above, d_above, denom, a_below, d_below))
        a_above = _u_mat_v(geo["u_ov"][:, l], a_below, geo["v_ov"][:, l], ns)
        d_above = _u_dmat_v(geo["u_ov"][:, l], d_below, geo["v_ov"][:, l], ns)

    top_albedo_diff = (a_above[..., :ns, :ns] @ hw).sum(-1)
    top_albedo_dir = d_above[..., :ns, 0].sum(-1) / zcos[:, None]
    bc = {"top_albedo_diff": top_albedo_diff, "top_albedo_dir": top_albedo_dir}

    # ---- downward flux recurrences (radsurf_urban_sw.F90:676-1001)
    ab_coef = inp.air_ext * (1.0 - inp.air_ssa)  # [C, L, S]
    vb_coef = inp.veg_ext[..., None] * (1.0 - inp.veg_ssa)
    cs = _clear_sky(inp, opt, geo, zcos)
    itr = cs["itr"]
    od = _pad_od(geo["od_scaling"])
    eps = torch.finfo(dtype).eps
    take = lambda x: _take_spec(x, itr)

    def sweep(with_direct):
        dn_dir = inp.air_ext.new_zeros((C, S, nreg))
        dn_diff = inp.air_ext.new_zeros((C, S, nd))
        if with_direct:
            dn_dir[..., 0] = 1.0 / zcos[:, None]
            dn_dir_clear = 1.0 / zcos
        else:
            dn_diff[..., :ns] = hw
            dn_dir_clear = torch.ones_like(zcos)
        per_layer = [None] * L
        for l in range(L - 1, -1, -1):
            R, T, E = lay["R"][:, l], lay["T"][:, l], lay["E"][:, l]
            Sdn = lay["Sdn"][:, l]
            a_above, d_above, denom, a_below, d_below = ups[l]
            v_ov = geo["v_ov"][:, l]
            dn_dir_below = _ov_dirvec(v_ov, dn_dir)  # [C, S, nreg+1]
            dn_diff_below = _ov_vec(v_ov, dn_diff, ns)  # [C, S, nd2]
            up_below = matvec(a_below, dn_diff_below)
            if with_direct:
                up_below = up_below + matvec(d_below, dn_dir_below)
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
                dn_dir_new = matvec(E, dn_dir_below[..., :nreg])
                refl_dir = matvec(d_above, dn_dir_new)
                rhs = (matvec(T, dn_diff_below[..., :nd]) + matvec(R, refl_dir)
                       + matvec(Sdn, dn_dir_below[..., :nreg]))
                dn_diff_new = solve(denom, rhs)
                up_above = matvec(a_above, dn_diff_new) + refl_dir
            else:
                dn_dir_new = dn_dir
                dn_diff_new = solve(denom, matvec(T, dn_diff_below[..., :nd]))
                up_above = matvec(a_above, dn_diff_new)
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
            int_flux_diff = matvec(lay["int_diff"][:, l], conv_diff)
            if with_direct:
                conv_dir = dn_dir_below[..., :nreg] - dn_dir_new
                int_flux_dir = matvec(lay["int_dir"][:, l], conv_dir)
                int_flux_diff = int_flux_diff + matvec(lay["int_dir_diff"][:, l],
                                                       conv_dir)
            else:
                int_flux_dir = inp.air_ext.new_zeros((C, S, nreg))
            # absorption (radsurf_urban_sw.F90:763-788)
            ifd = int_flux_diff.reshape(C, S, nreg, ns)
            ifd_mu = ifd @ (1.0 / mu)
            ab, vb = ab_coef[:, l], vb_coef[:, l]
            out["clear_air_abs"] = ab * (int_flux_dir[..., 0] + ifd_mu[..., 0])
            if nreg > 1:
                odl = od[:, l][:, None, :]
                tot = int_flux_dir[..., 1:] + ifd_mu[..., 1:]
                out["veg_air_abs"] = ab * tot.sum(-1)
                out["veg_abs"] = vb * (tot * odl).sum(-1)
                if with_direct:
                    out["veg_abs_dir"] = vb * (int_flux_dir[..., 1:] * odl).sum(-1)
            # walls (radsurf_urban_sw.F90:790-802, 955-963)
            if opt.do_urban:
                fw = geo["f_wall"][:, l]
                wall_in = torch.einsum("cr,csr->cs", fw, ifd @ tan_s)
                if with_direct:
                    wall_in_dir = sin0[:, None] * torch.einsum(
                        "cr,csr->cs", fw, int_flux_dir)
                    out["wall_in_dir"] = wall_in_dir
                    wall_in = wall_in + wall_in_dir
                out["wall_in"] = wall_in
                out["wall_net"] = wall_in * (1.0 - facets["wall_albedo"][:, l])
            # sunlit fractions (radsurf_urban_sw.F90:804-848)
            if with_direct:
                out["roof_sunlit_frac"] = _safe_div(
                    take(roof_in_dir) * cs["nbf_above"][:, l],
                    zcos * dn_dir_clear
                    * cs["roof_fraction"][:, l].clamp_min(opt.min_building_fraction))
                dn_dir_clear = dn_dir_clear * cs["nbf"][:, l] / cs["nbf_above"][:, l]
                aet = cs["air_ext_t"][:, l]
                int_dir_clear = torch.where(
                    aet > 0.0,
                    dn_dir_clear * (1.0 - cs["tdc"][:, l]) * zcos
                    / torch.where(aet > 0.0, aet, 1.0),
                    dn_dir_clear * inp.dz[:, l])
                if nreg > 1:
                    vfr = inp.veg_fraction[:, l]
                    clear = int_dir_clear * take(vb) * vfr
                    out["veg_sunlit_frac"] = torch.where(
                        vfr >= opt.min_vegetation_fraction,
                        take(out["veg_abs_dir"]) / clear.clamp_min(eps), 0.0)
                if opt.do_urban:
                    out["wall_sunlit_frac"] = 0.5 * take(out["wall_in_dir"]) / (
                        cs["fwdc"][:, l] * sin0 * int_dir_clear).clamp_min(eps)
                dn_dir_clear = dn_dir_clear * cs["tdc"][:, l]
            per_layer[l] = out
            dn_dir, dn_diff = dn_dir_new, dn_diff_new

        outs = {k: torch.stack([o[k] for o in per_layer], dim=1)
                for k in per_layer[0]}
        # ground (radsurf_urban_sw.F90:861-876)
        up_fin = matvec(a_ground, dn_diff)
        if with_direct:
            up_fin = up_fin + matvec(d_ground, dn_dir)
        gdd = _ground_fluxes(outs, dn_dir, dn_diff, up_fin, with_direct, zcos,
                             lg, nreg, top_albedo_dir if with_direct
                             else top_albedo_diff)
        if with_direct:
            outs["ground_dn_dir"] = gdd
            outs["ground_sunlit_frac"] = _safe_div(take(gdd), zcos * dn_dir_clear)
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


def _check_no_grad(inp: CanopyInputs):
    for name, x in inp.tensors():
        if x.requires_grad:
            raise NotImplementedError(
                f"the kernel route is forward-only, but input {name!r}"
                " requires grad; autograd is not ported yet")


def _sw_kernel_path(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
                    with_profiles: bool = False):
    _check_no_grad(inp)
    nreg, ns = opt.nreg, lg.nstream
    nd = nreg * ns
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    B = C * S
    dtype, dev = inp.air_ext.dtype, inp.air_ext.device
    hw = torch.as_tensor(lg.hweight, dtype=dtype, device=dev)

    zcos, sin0, geo, facets, (g0, g1, g2, g3) = _sw_front(inp, opt, lg)
    dz_soa = _soa_cls(inp.dz[:, :, None].expand(C, L, S))
    lay = layer_factory(_soa(g0), _soa(g1), _soa(g2), _soa(g3), dz_soa,
                        nd=nd, ndir=nreg, n_double=opt.n_double,
                        chunk=opt.factory_chunk)

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
    rmu = torch.as_tensor(1.0 / lg.mu, dtype=dtype, device=dev)
    rtan = torch.as_tensor(lg.tan_ang, dtype=dtype, device=dev)
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
    tan_over_pi = torch.as_tensor(np.tile(lg.tan_ang, nreg) / Pi, dtype=dtype,
                                  device=dev)
    outs["ground_vertical_diff"] = (dn_fin + up_fin) @ tan_over_pi
    if with_source:
        outs["top_dn"] = torch.zeros_like(outs["ground_dn"])
        outs["top_net"] = -bc["top_emission"]
    else:
        outs["top_dn"] = torch.ones_like(outs["ground_dn"])
        outs["top_net"] = bc["top_emissivity"]
    return outs


def _lw_scan(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
             with_profiles: bool = False):
    nreg, ns = opt.nreg, lg.nstream
    nd = nreg * ns
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    dtype, dev = inp.air_ext.dtype, inp.air_ext.device
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    mu, hw, tan_s = t(lg.mu), t(lg.hweight), t(lg.tan_ang)

    geo, facets, (g1, g2), em = _lw_front(inp, opt, lg)
    N = C * L * S
    lay = lw_layer_matrices_chunked(
        g1.reshape(N, nd, nd), g2.reshape(N, nd, nd),
        em["emiss_rate"].reshape(N, nd),
        inp.dz[:, :, None].expand(C, L, S).reshape(N),
        n_double=opt.n_double, chunk=opt.factory_chunk)
    lay = {k: v.reshape((C, L, S) + v.shape[1:]) for k, v in lay.items()}

    # ---- ground operators (radsurf_urban_lw.F90:551-565)
    same_reg = torch.block_diag(*[hw[:, None].expand(ns, ns)] * nreg)
    a_ground = (1.0 - inp.ground_emissivity)[:, :, None, None] * same_reg
    frac0 = geo["frac"][:, 0, :]  # lowest-layer fractions [C, nreg]
    source_ground = (inp.ground_emission[:, :, None]
                     * (frac0[:, :, None] * hw).reshape(C, 1, nd))  # [C, S, nd]

    # ---- upward adding recurrence (radsurf_urban_lw.F90:567-627)
    eye = torch.eye(nd, dtype=dtype, device=dev)
    nd2 = (nreg + 1) * ns
    a_above, source_above = a_ground, source_ground
    ups = []
    for l in range(L):
        R, T, p = lay["R"][:, l], lay["T"][:, l], lay["p"][:, l]
        denom = eye - matmul(a_above, R)
        a_below_reg = R + matmul(T, solve(denom, matmul(a_above, T)))
        # Eq. 34 (radsurf_urban_lw.F90:583-587)
        src_rhs = solve(denom, source_above + matvec(a_above, p))
        a_below = inp.air_ext.new_zeros((C, S, nd2, nd2))
        a_below[..., :nd, :nd] = a_below_reg
        a_below[..., nd:, nd:] = ((1.0 - facets["roof_emissivity"][:, l])
                                  [..., None, None] * hw[:, None])
        source_below = torch.cat([
            p + matvec(T, src_rhs),
            (facets["roof_emission"][:, l]
             * facets["exposed_roof"][:, l, None])[..., None] * hw], dim=-1)
        ups.append((a_above, source_above, denom, a_below, source_below))
        a_above = _u_mat_v(geo["u_ov"][:, l], a_below, geo["v_ov"][:, l], ns)
        source_above = _ov_vec(geo["u_ov"][:, l], source_below, ns)
    bc = _lw_top_bc(a_above, source_above, hw, ns)

    # ---- downward flux recurrences (radsurf_urban_lw.F90:639-858)
    ab_coef = inp.air_ext * (1.0 - inp.air_ssa)  # [C, L, S]
    vb_coef = inp.veg_ext[..., None] * (1.0 - inp.veg_ssa)
    od = _pad_od(geo["od_scaling"])

    def sweep(with_source):
        dn = inp.air_ext.new_zeros((C, S, nd))
        if not with_source:
            dn[..., :ns] = hw
        per_layer = [None] * L
        for l in range(L - 1, -1, -1):
            R, T, p = lay["R"][:, l], lay["T"][:, l], lay["p"][:, l]
            a_above, source_above, denom, a_below, source_below = ups[l]
            dz_l = inp.dz[:, l, None]
            dn_below = _ov_vec(geo["v_ov"][:, l], dn, ns)  # [C, S, nd2]
            up_below = matvec(a_below, dn_below)
            if with_source:
                up_below = up_below + source_below
            out = {"roof_in": dn_below[..., nd:].sum(-1)}
            out["roof_net"] = out["roof_in"] - up_below[..., nd:].sum(-1)
            rhs = matvec(T, dn_below[..., :nd])
            if with_source:
                rhs = rhs + matvec(R, source_above) + p
            dn_new = solve(denom, rhs)
            up_above = matvec(a_above, dn_new)
            if with_source:
                up_above = up_above + source_above
            if with_profiles:
                out["flux_dn_layer_top"] = dn_below[..., :nd].sum(-1)
                out["flux_up_layer_top"] = up_below[..., :nd].sum(-1)
                out["flux_dn_layer_base"] = dn_new.sum(-1)
                out["flux_up_layer_base"] = up_above.sum(-1)
            conv = dn_below[..., :nd] - dn_new - up_below[..., :nd] + up_above
            int_flux = matvec(lay["int_diff"][:, l], conv)
            if with_source:
                int_flux = int_flux + lay["int_source"][:, l]
            iflux = int_flux.reshape(C, S, nreg, ns)
            if_mu = iflux @ (1.0 / mu)
            ab, vb = ab_coef[:, l], vb_coef[:, l]
            out["clear_air_abs"] = ab * if_mu[..., 0]
            if nreg > 1:
                out["veg_air_abs"] = ab * if_mu[..., 1:].sum(-1)
                out["veg_abs"] = vb * (if_mu[..., 1:] * od[:, l][:, None, :]).sum(-1)
            if with_source:
                out["clear_air_abs"] = (out["clear_air_abs"]
                                        - em["emiss_reg"][:, l, :, 0] * dz_l)
                if nreg > 1:
                    out["veg_air_abs"] = (out["veg_air_abs"]
                                          - em["emiss_air"][:, l].sum(-1) * dz_l)
                    out["veg_abs"] = (out["veg_abs"]
                                      - em["emiss_veg"][:, l].sum(-1) * dz_l)
            if opt.do_urban:
                out["wall_in"] = torch.einsum("cr,csr->cs", geo["f_wall"][:, l],
                                              iflux @ tan_s)
                out["wall_net"] = out["wall_in"] * facets["wall_emissivity"][:, l]
                if with_source:
                    out["wall_net"] = (out["wall_net"]
                                       - em["emiss_wall"][:, l] * dz_l)
            per_layer[l] = out
            dn = dn_new
        outs = {k: torch.stack([o[k] for o in per_layer], dim=1)
                for k in per_layer[0]}
        up_fin = matvec(a_ground, dn)
        if with_source:
            up_fin = up_fin + source_ground
        return _lw_ground_fluxes(outs, dn, up_fin, with_source, lg, nreg, bc)

    return sweep(True), sweep(False), bc


def _lw_kernel_path(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
                    with_profiles: bool = False):
    """K1 (LW mode) -> K4 -> K5 in the [L, rows, B] layout (B = C*S), then
    the ground fluxes in closed form (cf. JAX _lw_pallas_path)."""
    _check_no_grad(inp)
    nreg, ns = opt.nreg, lg.nstream
    nd = nreg * ns
    C, L = inp.dz.shape
    S = inp.air_ext.shape[-1]
    B = C * S
    dtype, dev = inp.air_ext.dtype, inp.air_ext.device
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    hw = t(lg.hweight)

    geo, facets, (g1, g2), em = _lw_front(inp, opt, lg)
    dz_cls = inp.dz[:, :, None].expand(C, L, S)
    lay = lw_layer_factory(_soa(g1), _soa(g2), _soa(em["emiss_rate"][..., None]),
                           _soa_cls(dz_cls), nd=nd, n_double=opt.n_double,
                           chunk=opt.factory_chunk)

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

def _chunked_solve(impl, inp: CanopyInputs, opt: SolverOptions, lg,
                   with_profiles):
    """Solve in chunks of opt.column_chunk columns (0: the whole batch)."""
    C = inp.dz.shape[0]
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


_ROUTES = {"kernel": _sw_kernel_path, "scan": _sw_scan}
_LW_ROUTES = {"kernel": _lw_kernel_path, "scan": _lw_scan}


def spartacus_sw(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
                 with_profiles: bool = False, route: str = "kernel"):
    """Shortwave solve for one column group.

    Returns (norm_dir, norm_diff, bc): flux dicts normalized by the
    top-of-canopy direct / diffuse downwelling flux, and
    bc = {"top_albedo_diff", "top_albedo_dir"} [C, S].
    route: "kernel" (K1 -> K2 -> K3; CUDA kernels on CUDA tensors, their
    plain versions on CPU tensors) or "scan" (the plain reference).
    Parity: radsurf_urban_sw.F90:35-1007.
    """
    return _chunked_solve(_ROUTES[route],
                          _coerce_dtype(_sanitize_forest(inp, opt)),
                          opt, lg, with_profiles)


def spartacus_lw(inp: CanopyInputs, opt: SolverOptions, lg: LegendreGauss,
                 with_profiles: bool = False, route: str = "kernel"):
    """Longwave solve for one column group.

    Returns (internal, norm, bc): `internal` holds the fluxes from emission
    within the canopy, `norm` those normalized by unit top-of-canopy
    downwelling, and bc = {"top_emissivity", "top_emission"} [C, S].
    route: "kernel" (K1 in LW mode -> K4 -> K5; CUDA kernels on CUDA
    tensors, their plain versions on CPU tensors) or "scan" (the plain
    reference).  Parity: radsurf_urban_lw.F90:35-883.
    """
    return _chunked_solve(_LW_ROUTES[route],
                          _coerce_dtype(_sanitize_forest(inp, opt)),
                          opt, lg, with_profiles)
