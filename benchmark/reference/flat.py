"""[Frozen copy of spartacus_surface_tpu_torch/models/flat.py.]

Flat-tile analytic path.

Port of spartacus_surface_tpu/models/flat.py (radsurf/radsurf_interface.F90:
122-173); outputs are the normalized flux components of the canopy_flux
containers, [C, S].
"""

from __future__ import annotations

import torch


def flat_sw(ground_albedo, ground_albedo_dir):
    """Returns (norm_dir, norm_diff, bc) dicts for flat columns."""
    one = torch.ones_like(ground_albedo)
    zero = torch.zeros_like(ground_albedo)
    norm_dir = {
        "ground_dn_dir": one,
        "ground_dn": one,
        "ground_net": 1.0 - ground_albedo_dir,
        "ground_vertical_diff": 0.5 * ground_albedo_dir,
        "top_dn_dir": one,
        "top_dn": one,
        "top_net": 1.0 - ground_albedo_dir,
    }
    norm_diff = {
        "ground_dn_dir": zero,
        "ground_dn": one,
        "ground_net": 1.0 - ground_albedo,
        "ground_vertical_diff": 0.5 * (1.0 + ground_albedo),
        "top_dn_dir": zero,
        "top_dn": one,
        "top_net": 1.0 - ground_albedo,
    }
    bc = {"sw_albedo": ground_albedo, "sw_albedo_dir": ground_albedo_dir}
    return norm_dir, norm_diff, bc


def flat_lw(ground_emissivity, ground_emission):
    """Returns (internal, norm, bc) dicts for flat columns."""
    one = torch.ones_like(ground_emissivity)
    zero = torch.zeros_like(ground_emissivity)
    internal = {
        "ground_dn": zero,
        "ground_net": -ground_emission,
        "ground_vertical_diff": 0.5 * ground_emission,
        "top_dn": zero,
        "top_net": -ground_emission,
    }
    norm = {
        "ground_dn": one,
        "ground_net": ground_emissivity,
        "ground_vertical_diff": 0.5 * (2.0 - ground_emissivity),
        "top_dn": one,
        "top_net": ground_emissivity,
    }
    bc = {"lw_emissivity": ground_emissivity, "lw_emission": ground_emission}
    return internal, norm, bc
