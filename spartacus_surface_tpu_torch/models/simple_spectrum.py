"""Monochromatic longwave "gas optics": sigma*eps*T^4 emissions and Planck
sources.

Parity: radsurf/radsurf_simple_spectrum.F90:20-68 (per-column-block in the
reference; here one vectorized pass) plus calc_monochromatic_emission
(radsurf/radsurf_lw_spectral_properties.F90:161-199).

Extension beyond the reference (which ABORTS for nlw > 1,
radsurf_simple_spectrum.F90:44-46): with `lw_band_fraction` weights in the
&radsurf namelist, the sigma*T^4 Planck emission is split across nlw bands
(the solver is fully spectral already; band-dependent emissivities then
take effect).

A copy of spartacus_surface_tpu/models/simple_spectrum.py (numpy, no JAX): the
port imports nothing of the JAX package.
The driver calls it on the host arrays before the solve.
"""

from __future__ import annotations

import numpy as np

from ..utils.constants import StefanBoltzmann


def calc_simple_spectrum_lw(config, arrays: dict) -> None:
    """Fill ground/roof/wall emission and clear-air/veg Planck fields from
    the temperature arrays, in place."""
    if config.nlw > 1 and getattr(config, "lw_band_fraction", None) is None:
        raise ValueError(
            "Simple longwave spectrum only possible with one input spectral"
            " interval (set the lw_band_fraction namelist extension to"
            " split the Planck emission over nlw bands)"
        )
    sb = StefanBoltzmann
    if config.nlw > 1:
        sb = sb * np.asarray(config.lw_band_fraction, np.float64)
    arrays["ground_emission"] = (
        sb * arrays["ground_emissivity"]
        * arrays["ground_temperature"][:, None] ** 4
    )
    if "roof_temperature" in arrays:
        arrays["roof_emission"] = (
            sb * arrays["roof_emissivity"]
            * arrays["roof_temperature"][:, :, None] ** 4
        )
        arrays["wall_emission"] = (
            sb * arrays["wall_emissivity"]
            * arrays["wall_temperature"][:, :, None] ** 4
        )
    else:
        arrays["roof_emission"] = np.zeros_like(arrays["roof_emissivity"])
        arrays["wall_emission"] = np.zeros_like(arrays["wall_emissivity"])
    arrays["clear_air_planck"] = (
        sb * arrays["clear_air_temperature"][:, :, None] ** 4
    )
    if "veg_temperature" in arrays:
        arrays["veg_planck"] = sb * arrays["veg_temperature"][:, :, None] ** 4
        arrays["veg_air_planck"] = (
            sb * arrays["veg_air_temperature"][:, :, None] ** 4
        )
    else:
        arrays["veg_planck"] = np.zeros_like(arrays["clear_air_planck"])
        arrays["veg_air_planck"] = np.zeros_like(arrays["clear_air_planck"])
