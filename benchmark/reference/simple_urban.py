"""[Frozen copy of spartacus_surface_tpu_torch/models/simple_urban.py.]

Single-layer "simple urban" solvers (Harman et al. 2004 2x2 method),
infinite-street and exponential geometries selected per column.

Port of spartacus_surface_tpu/models/simple_urban.py
(radsurf/radsurf_simple_urban_sw.F90:28-294, radsurf_simple_urban_lw.F90:
28-257).  Every column has exactly one real layer; the dispatcher enforces
this (radsurf_interface.F90:281-284).  The reference's LW interaction
matrix uses the GROUND emissivity in its (2,2) element, where the wall's is
expected physically (radsurf_simple_urban_lw.F90:157); kept.
"""

from __future__ import annotations

import torch

from .constants import Pi
from .geometry import norm_perim_urban
from .view_factor import view_factors_exp, view_factors_inf


def _view_factors(dz, building_fraction, building_scale, is_infinite_street,
                  min_building_fraction, cos_sza=None):
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
    inf = view_factors_inf(dz / street_width, cos_sza)
    exp = view_factors_exp(dz / sep_scale, cos_sza)
    vgs, vww, *vdg = (torch.where(is_infinite_street, i, e)
                      for i, e in zip(inf, exp))
    out = dict(
        view_ground_sky=vgs,
        view_wall_wall=vww,
        view_wall_ground=0.5 * (1.0 - vww),
        view_ground_wall=1.0 - vgs,
        norm_perim_wall=npw,
    )
    if vdg:
        out.update(view_dir_ground=vdg[0], view_dir_wall=1.0 - vdg[0])
    return out


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


def simple_urban_lw(dz, building_fraction, building_scale, is_infinite_street,
                    ground_emissivity, ground_emission, roof_emissivity,
                    roof_emission, wall_emissivity, wall_emission, *,
                    min_building_fraction=1.0e-6, with_profiles=False):
    """LW 2x2 solve.  Scalars [C]; spectral fields [C, S].
    Returns (internal, norm, bc)."""
    vf = _view_factors(dz, building_fraction, building_scale,
                       is_infinite_street, min_building_fraction)
    b = building_fraction[:, None]
    vgs = vf["view_ground_sky"][:, None]
    vww = vf["view_wall_wall"][:, None]
    vwg = vf["view_wall_ground"][:, None]
    vgw = vf["view_ground_wall"][:, None]
    npw_dz = (vf["norm_perim_wall"] * dz)[:, None]

    # Interaction matrix (radsurf_simple_urban_lw.F90:154-157; the (2,2)
    # element with the ground emissivity, as the reference)
    m11 = torch.ones_like(wall_emissivity)
    m12 = -vwg * (1.0 - wall_emissivity)
    m21 = -vgw * (1.0 - ground_emissivity)
    m22 = 1.0 - vww * (1.0 - ground_emissivity)

    # Internal emission (radsurf_simple_urban_lw.F90:159-204)
    sol1, sol2 = _solve2x2(
        m11, m12, m21, m22, vwg * wall_emission * npw_dz,
        vgw * ground_emission * (1.0 - b) + vww * wall_emission * npw_dz)
    zero = torch.zeros_like(sol1)
    ni = {}
    ni["ground_dn"] = sol1
    ni["ground_net"] = sol1 * ground_emissivity - ground_emission * (1.0 - b)
    ni["ground_vertical_diff"] = zero
    ni["roof_in"] = zero
    ni["roof_net"] = -b * roof_emission
    ni["wall_in"] = sol2
    ni["wall_net"] = sol2 * wall_emissivity - wall_emission * npw_dz
    ni["top_dn"] = zero
    up_top = ((ni["ground_dn"] - ni["ground_net"]) * vgs
              + (ni["wall_in"] - ni["wall_net"]) * vwg)
    ni["top_net"] = -b * roof_emission - up_top
    if with_profiles:
        ni["flux_dn_layer_top"] = zero
        ni["flux_up_layer_top"] = up_top
        ni["flux_dn_layer_base"] = ni["ground_dn"]
        ni["flux_up_layer_base"] = ni["ground_dn"] - ni["ground_net"]

    # Normalized by the top-of-canopy downwelling
    # (radsurf_simple_urban_lw.F90:206-251)
    one = torch.ones_like(sol1)
    sol1, sol2 = _solve2x2(m11, m12, m21, m22, vgs * (1.0 - b) * one,
                           vgw * (1.0 - b) * one)
    nn = {}
    nn["ground_dn"] = sol1
    nn["ground_net"] = sol1 * ground_emissivity
    nn["ground_vertical_diff"] = zero
    nn["roof_in"] = b * one
    nn["roof_net"] = b * roof_emissivity
    nn["wall_in"] = sol2
    nn["wall_net"] = sol2 * wall_emissivity
    nn["top_dn"] = one
    up_top = ((nn["ground_dn"] - nn["ground_net"]) * vgs
              + (nn["wall_in"] - nn["wall_net"]) * vwg)
    nn["top_net"] = 1.0 - b * (1.0 - roof_emissivity) - up_top
    if with_profiles:
        nn["flux_dn_layer_top"] = (1.0 - b) * one
        nn["flux_up_layer_top"] = up_top
        nn["flux_dn_layer_base"] = nn["ground_dn"]
        nn["flux_up_layer_base"] = nn["ground_dn"] - nn["ground_net"]

    bc = {"lw_emissivity": nn["top_net"], "lw_emission": -ni["top_net"]}
    return ni, nn, bc
