"""[Frozen copy of spartacus_surface_tpu_torch/models/gamma.py.]

Region optical properties, Gamma-matrix assembly and LW emission rates.

Port of spartacus_surface_tpu/models/gamma.py, batched over [C, L, S].
Diffuse index i = region * ns + stream (radsurf_forest_sw.F90:338-339);
assembled matrices have shape [C, L, S, n, m].
Parity: radsurf_urban_sw.F90:340-494 and radsurf_urban_lw.F90:300-477
(forest = the f_wall = 0 limit).
"""

from __future__ import annotations

import numpy as np
import torch

from .legendre_gauss import LegendreGauss
from .matrix import constant

_EXT_EPS = 1.0e-8  # floor used by the reference (radsurf_forest_sw.F90:282)


def region_optics_sw(air_ext, air_ssa, veg_ext, veg_ssa, od_scaling, nreg: int):
    """Per-region extinction and single-scattering albedo [C, L, S, nreg]
    (radsurf_forest_sw.F90:277-297)."""
    ext1 = air_ext[..., None]
    ssa1 = air_ssa[..., None]
    if nreg == 1:
        return ext1, ssa1
    scaled_veg = od_scaling[..., None, :] * veg_ext[..., None, None]
    ext_v = ext1 + scaled_veg
    ssa_v = (ext1 * ssa1 + scaled_veg * veg_ssa[..., None]) / ext_v.clamp_min(_EXT_EPS)
    return torch.cat([ext1, ext_v], dim=-1), torch.cat([ssa1, ssa_v], dim=-1)


def region_optics_lw(air_ext, air_ssa, clear_air_planck, veg_ext, veg_ssa,
                     veg_planck, veg_air_planck, od_scaling, nreg: int):
    """Per-region ext, ssa and Planck source [C, L, S, nreg]
    (radsurf_forest_lw.F90:271-301)."""
    ext_reg, ssa_reg = region_optics_sw(air_ext, air_ssa, veg_ext, veg_ssa,
                                        od_scaling, nreg)
    p1 = clear_air_planck[..., None]
    if nreg == 1:
        return ext_reg, ssa_reg, p1
    scaled_veg = od_scaling[..., None, :] * veg_ext[..., None, None]
    num = (air_ext[..., None] * (1.0 - air_ssa[..., None]) * veg_air_planck[..., None]
           + scaled_veg * (1.0 - veg_ssa[..., None]) * veg_planck[..., None])
    den = (ext_reg[..., 1:] * (1.0 - ssa_reg[..., 1:])).clamp_min(_EXT_EPS)
    return ext_reg, ssa_reg, torch.cat([p1, num / den], dim=-1)


def exchange_rates(norm_perim, frac, nreg: int, min_frac: float):
    """Rates of exchange f_exchange[..., to, fr] between regions
    (radsurf_forest_sw.F90:299-321), zeroed where a region is below min_frac."""
    f = frac.new_zeros(frac.shape[:-1] + (nreg, nreg))
    if nreg == 1:
        return f

    def rate(edge, fr, to):
        ok = (frac[..., fr] > min_frac) & (frac[..., to] > min_frac)
        return torch.where(ok, edge / (np.pi * frac[..., fr].clamp_min(min_frac)), 0.0)

    for j in range(nreg - 1):
        f[..., j + 1, j] = rate(norm_perim[..., j], j, j + 1)
        f[..., j, j + 1] = rate(norm_perim[..., j], j + 1, j)
    if nreg > 2:
        edge = norm_perim[..., nreg - 1]
        ok = edge > 0.0
        f[..., 0, 2] = torch.where(ok, rate(edge, 2, 0), 0.0)
        f[..., 2, 0] = torch.where(ok, rate(edge, 0, 2), 0.0)
    return f


def wall_rates(norm_perim_wall, frac, nreg: int, min_frac: float,
               adjustment: float):
    """Rate of interception by walls f_wall [..., nreg]
    (radsurf_urban_sw.F90:395-403)."""
    return torch.where(frac > min_frac,
                       norm_perim_wall * adjustment
                       / (np.pi * frac.clamp_min(min_frac)), 0.0)


def assemble_gammas(ext_reg, ssa_reg, f_exchange, f_wall, wall_ext,
                    wall_factor, lg: LegendreGauss, nreg: int, *, cos_sza=None,
                    sin_sza=None, tan_sza=None):
    """gamma0 [C,L,S,nreg,nreg], gamma1/gamma2 [C,L,S,nd,nd],
    gamma3 [C,L,S,nd,nreg] (radsurf_urban_sw.F90:420-494).

    ext_reg, ssa_reg [C, L, S, nreg]; f_exchange [C, L, nreg, nreg];
    f_wall [C, L, nreg]; wall_ext, wall_factor [C, L, S]; solar angles [C].
    Without the solar angles (longwave, radsurf_urban_lw.F90:394-444) only
    the diffuse matrices are built: (None, gamma1, gamma2, None).
    """
    ns = lg.nstream
    nd = nreg * ns
    kw = dict(dtype=ext_reg.dtype, device=ext_reg.device)
    t = lambda x: constant(x, ext_reg.device, ext_reg.dtype)
    tan_s, mu_s, w_s, vw_s = t(lg.tan_ang), t(lg.mu), t(lg.weight), t(lg.vweight)
    eye_s = torch.eye(ns, **kw)
    reg_eye = torch.eye(nreg, **kw)
    diag_mask = reg_eye[:, None, :, None] * eye_s[None, :, None, :]

    fex = f_exchange[..., None, :, :]  # [C, L, 1, to, fr]
    fwall = f_wall[..., None, :]  # [C, L, 1, nreg]
    fex_colsum = fex.sum(-2)  # [C, L, 1, fr]

    # gamma1 before adding gamma2, as [.., nreg, ns, nreg, ns]
    off = fex[..., :, None, :, None] * (eye_s * tan_s[:, None])[None, :, None, :]
    diag_vals = -(fex_colsum[..., :, None] * tan_s
                  + ext_reg[..., :, None] / mu_s
                  + (fwall * wall_ext[..., None])[..., :, None] * tan_s)
    g1 = off + diag_vals[..., :, :, None, None] * diag_mask

    scat = ext_reg * ssa_reg
    wallscat = fwall * wall_factor[..., None]
    g2_block = 0.5 * (scat[..., :, None, None] * (w_s[:, None] / mu_s[None, :])
                      + wallscat[..., :, None, None]
                      * (vw_s[:, None] * tan_s[None, :]))
    g2 = g2_block[..., :, :, None, :] * reg_eye[:, None, :, None]
    bshape = torch.broadcast_shapes(g1.shape, g2.shape)
    batch = bshape[:-4]
    gamma1 = (g1 + g2).expand(bshape).reshape(batch + (nd, nd))
    gamma2 = g2.expand(bshape).reshape(batch + (nd, nd))
    if cos_sza is None:
        return None, gamma1, gamma2, None

    tan0 = tan_sza[:, None, None]
    mu0 = cos_sza[:, None, None]
    sin0 = sin_sza[:, None, None]
    off0 = fex * tan0[..., None, None]
    diag0 = -(fex_colsum * tan0[..., None] + ext_reg / mu0[..., None]
              + fwall * wall_ext[..., None] * tan0[..., None])
    gamma0 = off0 * (1.0 - reg_eye) + diag0[..., None, :] * reg_eye

    g3_vals = 0.5 * (scat[..., :, None] * w_s
                     + (wallscat * sin0[..., None])[..., :, None] * vw_s)
    gamma3 = (g3_vals[..., :, :, None] * reg_eye[:, None, :]).reshape(
        batch + (nd, nreg))
    return gamma0, gamma1, gamma2, gamma3


def emission_rates(ext_reg, ssa_reg, planck_reg, frac, norm_perim_wall,
                   wall_emission, lg: LegendreGauss, nreg: int):
    """LW emission-rate vector b ("b" of Eq. 32) and the volume emission
    (radsurf_urban_lw.F90:446-477; forest: zero wall terms).

    Returns {"emiss_rate" [C, L, S, nd], "volume_emiss" [C, L, S, nreg]}.
    """
    hw, mu, vw = (constant(x, ext_reg.device, ext_reg.dtype)
                  for x in (lg.hweight, lg.mu, lg.vweight))
    volume_emiss = frac[..., None, :] * ext_reg * (1.0 - ssa_reg) * planck_reg
    wall_emiss = (norm_perim_wall[..., None, :] * lg.vadjustment
                  * wall_emission[..., None])
    b = (volume_emiss[..., :, None] * (hw / mu)
         + wall_emiss[..., :, None] * (0.5 * vw))
    return {"emiss_rate": b.reshape(b.shape[:-2] + (nreg * lg.nstream,)),
            "volume_emiss": volume_emiss}
