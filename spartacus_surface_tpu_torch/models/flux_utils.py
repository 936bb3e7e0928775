"""Canopy-flux container operations: scale, sum, conservation check.

Port of spartacus_surface_tpu/models/flux_utils.py (canopy_flux_type
methods scale/sum/check, radsurf/radsurf_canopy_flux.F90:212-282, 399-460,
465-542).  The budget reductions run on the flux tensors' own device; only
the per-column [C] components are fetched for printing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.transfer import to_device
from .dispatch import (
    _COL_FIELDS,
    _LAY_FIELDS,
    TILE_FLAT,
    TILE_FOREST,
    TILE_INFINITE_STREET,
    TILE_SIMPLE_URBAN,
    TILE_URBAN,
    TILE_VEGETATED_URBAN,
)


def scale_flux(flux: dict, factor) -> dict:
    """Multiply normalized fluxes by the top-of-canopy flux [C, S]; sunlit
    fractions are not scaled (radsurf_canopy_flux.F90:208-211)."""
    out = {}
    for key, val in flux.items():
        if key in _COL_FIELDS:
            val = val * factor
        elif key in _LAY_FIELDS:
            val = val * factor[:, None, :]
        out[key] = val
    return out


def sum_flux(flux1: dict, flux2: dict) -> dict:
    """flux1 + flux2 elementwise (radsurf_canopy_flux.F90:423-447)."""
    return {key: flux1[key] + flux2[key] for key in flux1}


def representation_masks(i_representation, device) -> dict:
    """Tile masks for the budget reductions (bool [C])."""
    rep = np.asarray(i_representation)
    urban = [TILE_URBAN, TILE_VEGETATED_URBAN, TILE_SIMPLE_URBAN,
             TILE_INFINITE_STREET]
    masks = {"canopy": rep != TILE_FLAT, "urban": np.isin(rep, urban),
             "veg": np.isin(rep, [TILE_FOREST, TILE_VEGETATED_URBAN])}
    return {k: to_device(v, device) for k, v in masks.items()}


def budget_with_masks(flux: dict, masks: dict) -> dict:
    """Per-column energy-budget components ground/air/wall/roof/veg/veg_air/
    top, [C] tensors, from the tile masks of representation_masks
    (radsurf_canopy_flux.F90:465-500): reductions on the flux tensors' own
    device, so only [C] vectors need fetching."""
    lay = lambda key: flux[key].sum((-1, -2))
    return {
        "ground": flux["ground_net"].sum(-1),
        "top": flux["top_net"].sum(-1),
        "air": lay("clear_air_abs") * masks["canopy"],
        "wall": lay("wall_net") * masks["urban"],
        "roof": lay("roof_net") * masks["urban"],
        "veg": lay("veg_abs") * masks["veg"],
        "veg_air": lay("veg_air_abs") * masks["veg"],
    }


def budget_components(flux: dict, i_representation) -> dict:
    """budget_with_masks with the masks of i_representation."""
    return budget_with_masks(
        flux, representation_masks(i_representation, flux["ground_net"].device))


def budget_residual(comp: dict):
    """ground + air + wall + roof + veg + veg_air - top, per column."""
    return (comp["ground"] + comp["air"] + comp["wall"] + comp["roof"]
            + comp["veg"] + comp["veg_air"] - comp["top"])


def print_budget(comp: dict, printer=print, max_table_columns: int = 1000):
    """Print the reference-format budget table (a one-line summary beyond
    max_table_columns); returns the residual [C] as numpy.  comp holds [C]
    tensors or host numpy arrays."""
    comp = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in comp.items()}
    residual = budget_residual(comp)
    ncol = len(residual)
    if ncol > max_table_columns:
        jworst = int(np.argmax(np.abs(residual)))
        printer(f"Energy budget over {ncol} columns: max |residual| ="
                f" {abs(residual[jworst]):.3e} (column {jworst + 1}),"
                f" mean |residual| = {np.abs(residual).mean():.3e}")
        return residual
    printer("Column  Ground      Air     Wall     Roof      Veg  Air-veg"
            "      Top   Residual")
    for j in range(ncol):
        printer(f"{j + 1:5d}"
                + "".join(f"{comp[k][j]:9.3f}" for k in
                          ("ground", "air", "wall", "roof", "veg", "veg_air",
                           "top"))
                + f"{residual[j]:11.3e}")
    return residual


def check_flux(flux: dict, arrays: dict, name: str, printer=print,
               max_table_columns: int = 1000):
    """Per-column energy budget (radsurf_canopy_flux.F90:465-542); returns
    the residual [C] and prints the reference-format table."""
    comp = budget_components(flux, arrays["i_representation"])
    return print_budget(comp, printer, max_table_columns)
