"""[Frozen copy of spartacus_surface_tpu_torch/models/view_factor.py.]

View factors for the single-layer "simple urban" solvers.

Port of spartacus_surface_tpu/models/view_factor.py
(radsurf/radsurf_view_factor.F90; equations of Hogan, BLM 2019).
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import Pi
from .matrix import constant

# 8-point quadrature over the cosine of zenith angle of the exponential
# model (radsurf_view_factor.F90:85-95).
_EXP_WEIGHTS = np.array(
    [0.0506142681451884, 0.111190517226687, 0.156853322938944, 0.181341891689181,
     0.181341891689181, 0.156853322938944, 0.111190517226687, 0.0506142681451884]
)
_EXP_NODES = np.array(
    [0.0198550717512319, 0.101666761293187, 0.237233795041836, 0.408282678752175,
     0.591717321247825, 0.762766204958164, 0.898333238706813, 0.980144928248768]
)


def view_factors_inf(h, cos_sza=None):
    """Infinite-street view factors (radsurf_view_factor.F90:28-70):
    (view_ground_sky, view_wall_wall, view_dir_ground), without the last
    when cos_sza is None (longwave)."""
    view_ground_sky = torch.sqrt(h * h + 1.0) - h
    view_wall_wall = torch.sqrt(1.0 / (h * h) + 1.0) - 1.0 / h
    if cos_sza is None:
        return view_ground_sky, view_wall_wall
    norm_x0 = (Pi * 0.5) * h * torch.sqrt(1.0 / (cos_sza * cos_sza) - 1.0)
    y_over_w = torch.sqrt((norm_x0 * norm_x0 - 1.0).clamp_min(0.0))
    pos = y_over_w > 0.0
    view_dir_ground = torch.where(
        pos,
        (2.0 / Pi) * (y_over_w - norm_x0
                      + torch.atan(1.0 / torch.where(pos, y_over_w, 1.0))),
        1.0 - 2.0 * norm_x0 / Pi,
    )
    return view_ground_sky, view_wall_wall, view_dir_ground


def view_factors_exp(r, cos_sza=None):
    """Exponential-model view factors (radsurf_view_factor.F90:76-138),
    Eqs. 41/42 of Hogan (2019a); returns as view_factors_inf."""
    w = constant(_EXP_WEIGHTS, r.device, r.dtype)
    nodes = constant(_EXP_NODES, r.device, r.dtype)
    hweight = w * nodes / (w * nodes).sum()
    vweight = w * torch.sqrt(1.0 - nodes * nodes)
    vweight = vweight / vweight.sum()
    tk = r[..., None] * torch.sqrt(1.0 / (nodes * nodes) - 1.0)
    exp_tk = torch.exp(-tk)
    view_ground_sky = (hweight * exp_tk).sum(-1)
    view_wall_wall = 1.0 - (vweight * (1.0 - exp_tk) / tk).sum(-1)
    if cos_sza is None:
        return view_ground_sky, view_wall_wall
    norm_x0 = r * torch.sqrt(1.0 / (cos_sza * cos_sza) - 1.0)
    return view_ground_sky, view_wall_wall, torch.exp(-norm_x0)
