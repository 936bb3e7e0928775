"""[Frozen copy of spartacus_surface_tpu_torch/models/geometry.py.]

Statistical canopy geometry: region fractions, normalized perimeters and
maximum-random overlap matrices, elementwise over a dense [..., nlay] grid.

Port of spartacus_surface_tpu/models/geometry.py.  Forests are urban
canopies with building_fraction == 0.  Parity map:
  region_fracs            <-> radsurf_urban_sw.F90:283-291
  od_scaling_from_fsd     <-> radsurf_forest_sw.F90:284-297
  norm_perim_urban        <-> radsurf_norm_perim.F90:131-281
  overlap_matrices_urban  <-> radsurf_overlap.F90:178-394
"""

from __future__ import annotations

import math

import torch


def od_scaling_from_fsd(veg_fsd, nreg: int):
    """[..., nreg-1] optical-depth scalings of regions 2..nreg."""
    if nreg <= 1:
        return veg_fsd.new_zeros(veg_fsd.shape + (0,))
    if nreg == 2:
        return veg_fsd.new_ones(veg_fsd.shape + (1,))
    s2 = torch.exp(-veg_fsd * (1.0 + 0.5 * veg_fsd * (1.0 + 0.5 * veg_fsd)))
    return torch.stack([s2, 2.0 - s2], dim=-1)


def region_fracs(veg_fraction, building_fraction, nreg: int):
    """Area fraction of each permeable region, [..., nreg]."""
    f1 = 1.0 - building_fraction
    if nreg == 1:
        return f1[..., None]
    f1v = torch.clamp_min(f1 - veg_fraction, 0.0)
    fveg = torch.clamp_min(1.0 - building_fraction - f1v, 0.0) / (nreg - 1)
    return torch.cat([f1v[..., None],
                      fveg[..., None].expand(fveg.shape + (nreg - 1,))], dim=-1)


def norm_perim_urban(building_fraction, building_scale, veg_fraction,
                     veg_scale, veg_contact_fraction, *, nreg: int,
                     use_symmetric_vegetation_scale: bool,
                     vegetation_isolation_factor: float,
                     min_vegetation_fraction: float,
                     min_building_fraction: float):
    """(norm_perim [..., nreg], norm_perim_wall [..., nreg]) in m-1; see the
    JAX function for the edge convention."""
    shape = torch.broadcast_shapes(building_fraction.shape, veg_fraction.shape)
    zero = building_fraction.new_zeros(shape)
    np_cols = [zero] * max(nreg, 1)
    npw_cols = [zero] * max(nreg, 1)
    has_veg = veg_fraction > min_vegetation_fraction
    iso = vegetation_isolation_factor
    where = lambda c, a, b: torch.where(c, a, b)

    if nreg > 1:
        den = torch.clamp_min(1.0 - building_fraction, min_building_fraction)
        if use_symmetric_vegetation_scale:
            base = (4.0 * veg_fraction
                    * torch.clamp_min(1.0 - veg_fraction - building_fraction, 0.0)
                    / (den * veg_scale))
        else:
            base = 4.0 * veg_fraction / veg_scale
        if nreg == 2:
            np_cols[0] = where(has_veg, base, zero)
        else:
            np_cols[nreg - 1] = where(has_veg, 0.5 * iso * base, zero)
            np_cols[0] = where(has_veg, (1.0 - 0.5 * iso) * base, zero)
            if use_symmetric_vegetation_scale:
                mid = ((1.0 - iso) * 4.0 * (0.5 * veg_fraction)
                       * (1.0 - 0.5 * veg_fraction - building_fraction)
                       / (den * veg_scale))
            else:
                # Lollipop model, Hogan, Quaife and Braghiere (2018)
                mid = (1.0 - iso) * 4.0 * veg_fraction / (math.sqrt(2.0) * veg_scale)
            np_cols[1] = where(has_veg, mid, zero)

    has_bldg = building_fraction > min_building_fraction
    wall_all = where(has_bldg, 4.0 * building_fraction / building_scale, zero)
    if nreg == 1:
        npw_cols[0] = wall_all
    else:
        no_clear = (1.0 - veg_fraction - building_fraction) <= min_vegetation_fraction
        cf = veg_contact_fraction
        if nreg == 2:
            w2_full, w2_contact = wall_all, wall_all * cf
        else:
            w2_full = wall_all * (1.0 - iso)
            w2_contact = wall_all * cf * (1.0 - iso)
        nominal = has_veg & ~no_clear
        npw_cols[0] = where(no_clear, zero,
                            where(nominal, wall_all * (1.0 - cf), wall_all))
        npw_cols[1] = where(no_clear, w2_full, where(nominal, w2_contact, zero))
        if nreg == 3:
            npw_cols[2] = where(no_clear, wall_all * iso,
                                where(nominal, wall_all * cf * iso, zero))
    return (torch.stack(np_cols[:nreg], dim=-1),
            torch.stack(npw_cols[:nreg], dim=-1))


def _overlap_matrix_urban(fu, fl, nreg: int):
    """Non-directional overlap matrix O [..., nreg, nreg+1] (fu [..., nreg]
    upper fractions, fl [..., nreg+1] lower fractions incl. exposed roof),
    with the reference's nreg == 3 overhang quirk (radsurf_overlap.F90:271)."""
    z = fu.new_zeros(fu.shape[:-1])
    where = torch.where
    if nreg == 1:
        return torch.stack([fl[..., 0], fl[..., 1]], dim=-1)[..., None, :]
    if nreg == 2:
        pc = torch.maximum(fu[..., 1], fl[..., 1])
        no = pc <= fl[..., 0] + fl[..., 1]
        row1 = torch.stack([where(no, fl[..., 0] + fl[..., 1] - pc, z),
                            where(no, pc - fu[..., 1], z),
                            where(no, fl[..., 2], fu[..., 0])], dim=-1)
        row2 = torch.stack([where(no, pc - fl[..., 1], fl[..., 0]),
                            where(no, fu[..., 1] + fl[..., 1] - pc, fl[..., 1]),
                            where(no, z, fu[..., 1] - fl[..., 0] - fl[..., 1])],
                           dim=-1)
        return torch.stack([row1, row2], dim=-2)
    if nreg == 3:
        fu_veg = fu[..., 1] + fu[..., 2]
        fl_veg = fl[..., 1] + fl[..., 2]
        pc = torch.maximum(fu_veg, fl_veg)
        no = pc <= fl[..., 0] + fl_veg
        more = pc > fu_veg
        a11 = fl[..., 0] + fl_veg - pc
        a21 = where(more, z, fu[..., 1] - fl[..., 1])
        a31 = where(more, z, fu[..., 2] - fl[..., 2])
        a22 = where(more, fu[..., 1], fl[..., 1])
        a33 = where(more, fu[..., 2], fl[..., 2])
        a12 = where(more, fl[..., 1] - fu[..., 1], z)
        a13 = where(more, fl[..., 2] - fu[..., 2], z)
        b24 = (fl[..., 3] - fu[..., 0]) * 0.5
        sel = lambda a, b: where(no, a, b)
        row1 = torch.stack([sel(a11, z), sel(a12, z), sel(a13, z),
                            sel(fl[..., 3], fu[..., 0])], -1)
        row2 = torch.stack([sel(a21, fl[..., 0] * 0.5), sel(a22, fl[..., 1]), z,
                            sel(z, b24)], -1)
        # reference quirk: O(3,1) = O(1,2), which is zero, under overhang
        row3 = torch.stack([sel(a31, z), z, sel(a33, fl[..., 2]), sel(z, b24)], -1)
        return torch.stack([row1, row2, row3], dim=-2)
    raise ValueError(f"nreg={nreg} not supported (must be 1, 2 or 3)")


def overlap_matrices_urban(frac, nreg: int, frac_threshold: float,
                           building_fraction):
    """Directional overlap matrices at the top of every layer:
    (u_overlap [..., nlay, nreg, nreg+1], v_overlap [..., nlay, nreg+1, nreg]).

    The exposed roof at the top of layer l is building_fraction[l] minus
    that of the layer above (0 above the top), not the difference of the
    two layers' region-fraction sums: at a building fraction equal to the
    threshold, the rounding of those sums would decide whether the roof
    reflects (the JAX function keeps it under jit and drops it op by op).
    Parity: radsurf_overlap.F90:289-394."""
    free_atm = torch.zeros_like(frac[..., :1, :])
    free_atm[..., 0] = 1.0
    frac_up = torch.cat([frac[..., 1:, :], free_atm], dim=-2)
    sum_lower = frac.sum(-1)
    sum_upper = frac_up.sum(-1)
    bf = building_fraction
    roof = bf - torch.cat([bf[..., 1:], torch.zeros_like(bf[..., :1])], dim=-1)
    one = torch.ones_like(sum_lower)
    scale = torch.where(
        roof < 0.0, sum_upper / torch.where(sum_lower > 0.0, sum_lower, one), one)
    fl = torch.cat([frac * scale[..., None], roof.clamp_min(0.0)[..., None]], dim=-1)
    o = _overlap_matrix_urban(frac_up, fl, nreg)
    lower_ok = fl >= frac_threshold
    upper_ok = frac_up >= frac_threshold
    u_ov = torch.where(lower_ok[..., None, :],
                       o / torch.where(lower_ok, fl, 1.0)[..., None, :], 0.0)
    v_ov = torch.where(upper_ok[..., None, :],
                       o.transpose(-1, -2)
                       / torch.where(upper_ok, frac_up, 1.0)[..., None, :], 0.0)
    return u_ov, v_ov
