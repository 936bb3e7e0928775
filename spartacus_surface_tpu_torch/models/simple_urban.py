"""Single-layer "simple urban" shortwave solver (Harman et al. 2004 2x2
method), infinite-street and exponential geometries selected per column.

Port of spartacus_surface_tpu/models/simple_urban.py ``simple_urban_sw``
(radsurf/radsurf_simple_urban_sw.F90:28-294).  Every column has exactly one
real layer; the dispatcher enforces this (radsurf_interface.F90:281-284).
"""

from __future__ import annotations

import torch

from ..utils.constants import Pi
from .geometry import norm_perim_urban
from .view_factor import view_factors_exp, view_factors_inf


def _view_factors(dz, building_fraction, building_scale, is_infinite_street,
                  min_building_fraction, cos_sza):
    zero = torch.zeros_like(building_fraction)
    _, npw = norm_perim_urban(
        building_fraction, building_scale, zero, torch.ones_like(zero), zero,
        nreg=1, use_symmetric_vegetation_scale=True,
        vegetation_isolation_factor=0.0, min_vegetation_fraction=1.0e-6,
        min_building_fraction=min_building_fraction,
    )
    npw = npw[..., 0]  # radsurf_simple_urban_sw.F90:129-134
    npw_safe = npw.clamp_min(1.0e-12)
    street_width = 2.0 * (1.0 - building_fraction) / npw_safe
    sep_scale = Pi * (1.0 - building_fraction) / npw_safe
    vgs_i, vww_i, vdg_i = view_factors_inf(dz / street_width, cos_sza)
    vgs_e, vww_e, vdg_e = view_factors_exp(dz / sep_scale, cos_sza)
    vgs = torch.where(is_infinite_street, vgs_i, vgs_e)
    vww = torch.where(is_infinite_street, vww_i, vww_e)
    vdg = torch.where(is_infinite_street, vdg_i, vdg_e)
    return dict(
        view_ground_sky=vgs,
        view_wall_wall=vww,
        view_wall_ground=0.5 * (1.0 - vww),
        view_ground_wall=1.0 - vgs,
        norm_perim_wall=npw,
        view_dir_ground=vdg,
        view_dir_wall=1.0 - vdg,
    )


def _solve2x2(m11, m12, m21, m22, b1, b2):
    det = m11 * m22 - m12 * m21
    return (m22 * b1 - m12 * b2) / det, (m11 * b2 - m21 * b1) / det


def simple_urban_sw(dz, building_fraction, building_scale, cos_sza,
                    is_infinite_street, ground_albedo_diff, ground_albedo_dir,
                    roof_albedo, wall_albedo, *, min_building_fraction=1.0e-6,
                    with_profiles=False):
    """SW 2x2 solve.  Scalars [C]; spectral fields [C, S].
    Returns (norm_dir, norm_diff, bc)."""
    vf = _view_factors(dz, building_fraction, building_scale,
                       is_infinite_street, min_building_fraction, cos_sza)
    b = building_fraction[:, None]
    vdg = vf["view_dir_ground"][:, None]
    vdw = vf["view_dir_wall"][:, None]
    vgs = vf["view_ground_sky"][:, None]
    vww = vf["view_wall_wall"][:, None]
    vwg = vf["view_wall_ground"][:, None]
    vgw = vf["view_ground_wall"][:, None]

    # Interaction matrix (radsurf_simple_urban_sw.F90:166-169)
    m11 = torch.ones_like(wall_albedo)
    m12 = -vwg * wall_albedo
    m21 = -vgw * ground_albedo_diff
    m22 = 1.0 - vww * wall_albedo

    # Direct normalization (radsurf_simple_urban_sw.F90:181-237)
    src2 = (vdw + ground_albedo_dir * vdg * vgw) * (1.0 - b)
    one = torch.ones_like(src2)
    zero = torch.zeros_like(src2)
    sol1, sol2 = _solve2x2(m11, m12, m21, m22, zero, src2)
    nd = {}
    nd["ground_dn_dir"] = vdg * (1.0 - b) * one
    nd["ground_dn"] = nd["ground_dn_dir"] + sol1
    nd["ground_net"] = (nd["ground_dn_dir"] * (1.0 - ground_albedo_dir)
                       + sol1 * (1.0 - ground_albedo_diff))
    nd["ground_vertical_diff"] = zero
    nd["ground_sunlit_frac"] = vf["view_dir_ground"]
    nd["roof_in_dir"] = b * one
    nd["roof_in"] = b * one
    nd["roof_net"] = b * (1.0 - roof_albedo)
    nd["roof_sunlit_frac"] = torch.ones_like(building_fraction)
    nd["wall_in_dir"] = vdw * (1.0 - b) * one
    nd["wall_in"] = sol2
    nd["wall_net"] = sol2 * (1.0 - wall_albedo)
    tan_sza = torch.sqrt(1.0 / (cos_sza * cos_sza) - 1.0)
    nd["wall_sunlit_frac"] = 0.5 * vf["view_dir_wall"] / (
        tan_sza.clamp_min(1.0e-6) * vf["norm_perim_wall"] * dz
        / (Pi * (1.0 - building_fraction)))
    nd["top_dn_dir"] = one
    nd["top_dn"] = one
    up_top = ((nd["ground_dn"] - nd["ground_net"]) * vgs
              + (nd["wall_in"] - nd["wall_net"]) * vwg)
    nd["top_net"] = 1.0 - b * roof_albedo - up_top
    if with_profiles:
        nd["flux_dn_dir_layer_top"] = (1.0 - b) * one
        nd["flux_dn_layer_top"] = (1.0 - b) * one
        nd["flux_up_layer_top"] = up_top
        nd["flux_dn_dir_layer_base"] = nd["ground_dn_dir"]
        nd["flux_dn_layer_base"] = nd["ground_dn"]
        nd["flux_up_layer_base"] = nd["ground_dn"] - nd["ground_net"]

    # Diffuse normalization (radsurf_simple_urban_sw.F90:246-288)
    sol1, sol2 = _solve2x2(m11, m12, m21, m22, vgs * (1.0 - b) * one,
                           vgw * (1.0 - b) * one)
    nf = {}
    nf["ground_dn_dir"] = zero
    nf["ground_dn"] = sol1
    nf["ground_net"] = sol1 * (1.0 - ground_albedo_diff)
    nf["ground_vertical_diff"] = zero
    nf["roof_in"] = b * one
    nf["roof_net"] = b * (1.0 - roof_albedo)
    nf["wall_in"] = sol2
    nf["wall_net"] = sol2 * (1.0 - wall_albedo)
    nf["top_dn_dir"] = zero
    nf["top_dn"] = one
    up_top = ((nf["ground_dn"] - nf["ground_net"]) * vgs
              + (nf["wall_in"] - nf["wall_net"]) * vwg)
    nf["top_net"] = 1.0 - b * roof_albedo - up_top
    if with_profiles:
        nf["flux_dn_layer_top"] = (1.0 - b) * one
        nf["flux_up_layer_top"] = up_top
        nf["flux_dn_layer_base"] = nf["ground_dn"]
        nf["flux_up_layer_base"] = nf["ground_dn"] - nf["ground_net"]

    bc = {"sw_albedo": 1.0 - nf["top_net"], "sw_albedo_dir": 1.0 - nd["top_net"]}
    return nd, nf, bc
