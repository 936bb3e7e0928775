"""Input reader: NetCDF -> dense padded numpy arrays.

Parity: driver/spartacus_surface_read_input.F90:20-384, including the
driver-config physical overrides, the default air optical properties
(air_ext = 1e-5 m-1 hardcoded; SW air_ssa = 0.999, LW air_ssa = 0;
read_input.F90:258-261,362-365), the veg_contact_fraction default
(read_input.F90:159-166) and the sky-temperature fallback for the
top-of-canopy longwave flux (read_input.F90:273-280).

Layout change vs the reference: the packed ragged layout
(ntotlay + istartlay, radsurf_canopy_properties.F90:43-59) becomes dense
padded [ncol, nlay_max] arrays.  Padding layers (above each column's real
canopy) carry dz = 0 and zero cover fractions, which the solver treats as
exact no-ops; air_ext keeps its default there so the Gamma matrices stay
invertible.

A copy of spartacus_surface_tpu/driver/read_input.py (numpy, no JAX): the
port imports nothing of the JAX package.
It returns float64 host arrays; the driver casts them to the working
precision and models.dispatch.run_radsurf moves them to the device.
"""

from __future__ import annotations

import numpy as np

from ..utils.config import Config, DriverConfig
from ..utils.constants import StefanBoltzmann
from ..utils.netcdf_io import InputFile


def _pad_dense(var2d, nlay, nlay_max, fill=0.0):
    """[C, <=nlay_max] -> [C, nlay_max] with `fill` beyond each column's
    nlay."""
    ncol = var2d.shape[0]
    out = np.full((ncol, nlay_max), fill, np.float64)
    ncopy = min(var2d.shape[1], nlay_max)
    out[:, :ncopy] = var2d[:, :ncopy]
    mask = np.arange(nlay_max)[None, :] >= nlay[:, None]
    out[mask] = fill
    return out


def _read_spectral_col(f: InputFile, name: str, nspec: int):
    """Per-column possibly-spectral variable -> [C, nspec]
    (parity: read_2d, read_input.F90:387-415)."""
    data = f.get(name)
    if data.ndim == 1:
        data = data[:, None]
    if data.shape[1] == 1 and nspec > 1:
        data = np.repeat(data, nspec, axis=1)
    return data


def _read_spectral_lay(f: InputFile, name: str, nlay, nlay_max, nspec,
                       fill=0.0):
    """Per-layer possibly-spectral variable -> [C, L, nspec]
    (parity: read_packed_2d, read_input.F90:451-496)."""
    data = f.get(name)
    if data.ndim == 2:
        data = data[:, :, None]
    if data.shape[2] == 1 and nspec > 1:
        data = np.repeat(data, nspec, axis=2)
    ncol = data.shape[0]
    out = np.full((ncol, nlay_max, data.shape[2]), fill, np.float64)
    ncopy = min(data.shape[1], nlay_max)
    out[:, :ncopy] = data[:, :ncopy]
    mask = np.arange(nlay_max)[None, :] >= nlay[:, None]
    out[mask] = fill
    return out


def read_input(path: str, config: Config, driver_config: DriverConfig,
               verbose_print=None) -> dict:
    """Read one input file into the dense arrays dict consumed by
    models.dispatch.run_radsurf, plus top-of-canopy fluxes."""
    log = verbose_print or (lambda *a: None)
    arrays: dict = {}
    with InputFile(path) as f:
        nlay = f.get("nlayer", np.int64).astype(int)
        ncol = nlay.shape[0]
        nlay_max = int(nlay.max())
        arrays["nlay"] = nlay

        if config.do_sw:
            if driver_config.cos_sza_override >= 0.0:
                log(f"  Overriding cosine of the solar zenith angle with "
                    f"{driver_config.cos_sza_override:g}")
                cos_sza = np.full(ncol, driver_config.cos_sza_override)
            else:
                cos_sza = f.get("cos_solar_zenith_angle")
        else:
            cos_sza = np.full(ncol, 0.5)
        arrays["cos_sza"] = cos_sza

        height = f.get("height")  # [C, L+1]
        dz_raw = height[:, 1:] - height[:, :-1]
        arrays["dz"] = _pad_dense(dz_raw, nlay, nlay_max)

        if driver_config.isurfacetype >= 0:
            log(f"  Overriding all surface types with "
                f"{driver_config.isurfacetype}")
            rep = np.full(ncol, driver_config.isurfacetype, int)
        else:
            rep = f.get("surface_type", np.int64).astype(int)
        arrays["i_representation"] = rep

        def lay1(name, fill=0.0, default=None, override=None, scale=None):
            if override is not None and override >= 0.0:
                log(f"  Overriding {name} with {override:g}")
                out = np.full((ncol, nlay_max), override)
                mask = np.arange(nlay_max)[None, :] >= nlay[:, None]
                out[mask] = fill
                return out
            if not f.exists(name):
                if default is None:
                    raise KeyError(f"required input variable '{name}' missing")
                return np.full((ncol, nlay_max), default)
            out = _pad_dense(f.get(name), nlay, nlay_max, fill)
            if scale is not None and scale >= 0.0:
                log(f"  Scaling {name} by {scale:g}")
                out = out * scale
            return out

        # Canopy geometry (read_input.F90:106-169)
        dc = driver_config
        if config.do_urban:
            arrays["building_fraction"] = lay1("building_fraction")
            arrays["building_scale"] = lay1("building_scale", fill=1.0)
        else:
            arrays["building_fraction"] = np.zeros((ncol, nlay_max))
            arrays["building_scale"] = np.ones((ncol, nlay_max))
        if config.do_vegetation:
            arrays["veg_fraction"] = lay1(
                "veg_fraction", override=dc.vegetation_fraction
            )
            arrays["veg_ext"] = lay1(
                "veg_extinction",
                override=dc.vegetation_extinction,
                scale=dc.vegetation_extinction_scaling,
            )
            arrays["veg_scale"] = lay1("veg_scale", fill=1.0)
            arrays["veg_fsd"] = lay1(
                "veg_fsd", override=dc.vegetation_fsd, default=0.0
            )
            if config.do_urban:
                if f.exists("veg_contact_fraction"):
                    arrays["veg_contact_fraction"] = lay1(
                        "veg_contact_fraction"
                    )
                else:
                    # Random placement default (read_input.F90:159-166)
                    arrays["veg_contact_fraction"] = np.minimum(
                        1.0,
                        arrays["veg_fraction"]
                        / np.maximum(
                            config.min_vegetation_fraction,
                            1.0 - arrays["building_fraction"],
                        ),
                    )
            else:
                arrays["veg_contact_fraction"] = np.zeros((ncol, nlay_max))
        else:
            for key in ("veg_fraction", "veg_ext", "veg_fsd",
                        "veg_contact_fraction"):
                arrays[key] = np.zeros((ncol, nlay_max))
            arrays["veg_scale"] = np.ones((ncol, nlay_max))

        top_flux_dn_sw = top_flux_dn_direct_sw = top_flux_dn_lw = None

        if config.do_lw:
            nlw = config.nlw
            arrays["ground_temperature"] = f.get("ground_temperature")
            if config.do_urban:
                arrays["roof_temperature"] = lay1("roof_temperature",
                                                  fill=273.0)
                arrays["wall_temperature"] = lay1("wall_temperature",
                                                  fill=273.0)
            ge = _read_spectral_col(f, "ground_lw_emissivity", nlw)
            if dc.ground_lw_emissivity >= 0.0:
                log("  Overriding ground longwave emissivity")
                ge[:] = dc.ground_lw_emissivity
            arrays["ground_emissivity"] = ge
            if config.do_urban:
                re = _read_spectral_lay(f, "roof_lw_emissivity", nlay,
                                        nlay_max, nlw, fill=1.0)
                if dc.roof_lw_emissivity >= 0.0:
                    re[:] = dc.roof_lw_emissivity
                arrays["roof_emissivity"] = re
                we = _read_spectral_lay(f, "wall_lw_emissivity", nlay,
                                        nlay_max, nlw, fill=1.0)
                if dc.wall_lw_emissivity >= 0.0:
                    we[:] = dc.wall_lw_emissivity
                arrays["wall_emissivity"] = we
            else:
                arrays["roof_emissivity"] = np.ones((ncol, nlay_max, nlw))
                arrays["wall_emissivity"] = np.ones((ncol, nlay_max, nlw))
            if config.do_vegetation:
                vs = _read_spectral_lay(f, "veg_lw_ssa", nlay, nlay_max, nlw)
                if dc.vegetation_lw_ssa >= 0.0:
                    vs[:] = dc.vegetation_lw_ssa
                arrays["lw_veg_ssa"] = vs
            else:
                arrays["lw_veg_ssa"] = np.zeros((ncol, nlay_max, nlw))
            # Air temperatures (read_input.F90:227-257)
            if f.exists("clear_air_temperature"):
                arrays["clear_air_temperature"] = lay1(
                    "clear_air_temperature", fill=273.0
                )
                arrays["veg_air_temperature"] = lay1(
                    "veg_air_temperature", fill=273.0, default=273.0
                )
            else:
                arrays["clear_air_temperature"] = lay1("air_temperature",
                                                        fill=273.0)
                arrays["veg_air_temperature"] = arrays[
                    "clear_air_temperature"
                ].copy()
            if f.exists("veg_temperature"):
                arrays["veg_temperature"] = lay1("veg_temperature",
                                                  fill=273.0)
            else:
                log("  Setting vegetation temperature equal to air "
                    "temperature")
                arrays["veg_temperature"] = arrays[
                    "clear_air_temperature"
                ].copy()
            # Default air optics (read_input.F90:258-261)
            arrays["lw_air_ext"] = np.full((ncol, nlay_max, nlw), 1.0e-5)
            arrays["lw_air_ssa"] = np.zeros((ncol, nlay_max, nlw))
            # Top-of-canopy longwave flux (read_input.F90:273-280).  For
            # nlw > 1, broadband values (the scalar override and the
            # sky-temperature sigma*T^4 fallback) are split across bands by
            # lw_band_fraction (nlw > 1 is an extension; the reference
            # aborts, radsurf_simple_spectrum.F90:44-46).
            def band_weights():
                # Broadband -> per-band split requires lw_band_fraction
                # when nlw > 1; refusing to guess matches
                # calc_simple_spectrum_lw, which raises for the same
                # configuration (the reference aborts for any nlw > 1,
                # radsurf_simple_spectrum.F90:44-46).
                if nlw == 1:
                    return np.ones(1)
                if config.lw_band_fraction is None:
                    raise ValueError(
                        "nlw > 1 with a broadband longwave boundary "
                        "condition requires lw_band_fraction in &radsurf"
                    )
                return np.asarray(config.lw_band_fraction, np.float64)

            if dc.top_flux_dn_lw >= 0.0:
                top_flux_dn_lw = dc.top_flux_dn_lw * np.broadcast_to(
                    band_weights(), (ncol, nlw)
                ).copy()
            elif f.exists("top_flux_dn_lw"):
                top_flux_dn_lw = _read_spectral_col(f, "top_flux_dn_lw", nlw)
            else:
                raw = np.asarray(f.get("sky_temperature"))
                if raw.ndim >= 2 and raw.shape[1] == nlw and nlw > 1:
                    # Per-band sky temperatures: sigma*T_b^4 per band, no
                    # extra band-weighting (T is a temperature, not a
                    # fraction of the broadband flux).
                    top_flux_dn_lw = StefanBoltzmann * raw.astype(
                        np.float64
                    ) ** 4
                else:
                    sky_t = _read_spectral_col(f, "sky_temperature", nlw)
                    top_flux_dn_lw = (
                        StefanBoltzmann * sky_t**4 * band_weights()
                    )

        if config.do_sw:
            nsw = config.nsw
            ga = _read_spectral_col(f, "ground_sw_albedo", nsw)
            if dc.ground_sw_albedo >= 0.0:
                log("  Overriding ground shortwave albedo")
                ga[:] = dc.ground_sw_albedo
            arrays["ground_albedo"] = ga
            if f.exists("ground_sw_albedo_direct"):
                arrays["ground_albedo_dir"] = _read_spectral_col(
                    f, "ground_sw_albedo_direct", nsw
                )
            else:
                arrays["ground_albedo_dir"] = ga.copy()
            if config.do_urban:
                ra = _read_spectral_lay(f, "roof_sw_albedo", nlay, nlay_max,
                                        nsw)
                if dc.roof_sw_albedo >= 0.0:
                    ra[:] = dc.roof_sw_albedo
                arrays["roof_albedo"] = ra
                if f.exists("roof_sw_albedo_direct"):
                    arrays["roof_albedo_dir"] = _read_spectral_lay(
                        f, "roof_sw_albedo_direct", nlay, nlay_max, nsw
                    )
                else:
                    log("  Assuming roof albedo to direct is the same as to "
                        "diffuse")
                    arrays["roof_albedo_dir"] = ra.copy()
                wa = _read_spectral_lay(f, "wall_sw_albedo", nlay, nlay_max,
                                        nsw)
                if dc.wall_sw_albedo >= 0.0:
                    wa[:] = dc.wall_sw_albedo
                arrays["wall_albedo"] = wa
                if f.exists("wall_sw_specular_fraction"):
                    arrays["wall_specular_frac"] = _read_spectral_lay(
                        f, "wall_sw_specular_fraction", nlay, nlay_max, nsw
                    )
                else:
                    log("  Assuming wall reflection is Lambertian")
                    arrays["wall_specular_frac"] = np.zeros(
                        (ncol, nlay_max, nsw)
                    )
            else:
                arrays["roof_albedo"] = np.zeros((ncol, nlay_max, nsw))
                arrays["roof_albedo_dir"] = np.zeros((ncol, nlay_max, nsw))
                arrays["wall_albedo"] = np.zeros((ncol, nlay_max, nsw))
                arrays["wall_specular_frac"] = np.zeros(
                    (ncol, nlay_max, nsw)
                )
            if config.do_vegetation:
                vs = _read_spectral_lay(f, "veg_sw_ssa", nlay, nlay_max, nsw)
                if dc.vegetation_sw_ssa >= 0.0:
                    log("  Overriding vegetation shortwave ssa")
                    vs[:] = dc.vegetation_sw_ssa
                arrays["sw_veg_ssa"] = vs
            else:
                arrays["sw_veg_ssa"] = np.zeros((ncol, nlay_max, nsw))
            # Default air optics (read_input.F90:362-365)
            arrays["sw_air_ext"] = np.full((ncol, nlay_max, nsw), 1.0e-5)
            arrays["sw_air_ssa"] = np.full((ncol, nlay_max, nsw), 0.999)
            # Top-of-canopy fluxes (read_input.F90:368-381)
            if dc.top_flux_dn_sw >= 0.0:
                top_flux_dn_sw = np.full((ncol, nsw), dc.top_flux_dn_sw)
            else:
                top_flux_dn_sw = _read_spectral_col(f, "top_flux_dn_sw", nsw)
            if dc.top_flux_dn_direct_sw >= 0.0:
                top_flux_dn_direct_sw = np.full(
                    (ncol, nsw), dc.top_flux_dn_direct_sw
                )
            else:
                top_flux_dn_direct_sw = _read_spectral_col(
                    f, "top_flux_dn_direct_sw", nsw
                )

    return {
        "arrays": arrays,
        "ncol": ncol,
        "nlay_max": nlay_max,
        "top_flux_dn_sw": top_flux_dn_sw,
        "top_flux_dn_direct_sw": top_flux_dn_direct_sw,
        "top_flux_dn_lw": top_flux_dn_lw,
    }
