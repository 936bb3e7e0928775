"""Algorithm and driver configuration (the &radsurf and &radsurf_driver
namelists).

The fields are those of spartacus_surface_tpu/utils/config.py ``Config``
(radsurf/radsurf_config.F90:32-113) and ``DriverConfig``
(driver/spartacus_surface_config.F90:21-66); tests/test_torch_ops.py and
tests/test_torch_cli.py hold them equal.  The dataclasses are declared here
rather than imported because the JAX package's ``Config.consolidate``
imports JAX (through ``spartacus_surface_tpu.ops``), and this package must
import nothing of the JAX package.  ``consolidate`` builds this package's
``LegendreGauss``; ``from_namelist`` and ``print_config`` are the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from dataclasses import dataclass, field

import numpy as np

from ..ops.legendre_gauss import LegendreGauss
from .namelist import read_namelists


@dataclass
class Config:
    """Algorithm configuration; field meanings as in the JAX ``Config``."""

    do_sw: bool = True
    do_lw: bool = True
    use_sw_direct_albedo: bool = False
    do_vegetation: bool = True
    do_urban: bool = True
    n_vegetation_region_forest: int = 1
    n_vegetation_region_urban: int = 1
    nsw: int = 1
    nlw: int = 1
    n_stream_sw_forest: int = 4
    n_stream_sw_urban: int = 4
    n_stream_lw_forest: int = 4
    n_stream_lw_urban: int = 4
    use_symmetric_vegetation_scale_forest: bool = True
    use_symmetric_vegetation_scale_urban: bool = True
    vegetation_isolation_factor_forest: float = 0.0
    vegetation_isolation_factor_urban: float = 0.0
    min_vegetation_fraction: float = 1.0e-6
    min_building_fraction: float = 1.0e-6
    do_save_broadband_flux: bool = True
    do_save_spectral_flux: bool = False
    do_save_flux_profile: bool = False
    iverbose: int = 3

    # Computed in consolidate() (radsurf_config.F90:260-266)
    nswinternal: int = field(default=0, repr=False)
    nlwinternal: int = field(default=0, repr=False)
    lg_sw_forest: object = field(default=None, repr=False)
    lg_sw_urban: object = field(default=None, repr=False)
    lg_lw_forest: object = field(default=None, repr=False)
    lg_lw_urban: object = field(default=None, repr=False)

    # Doubling-step cap of the layer factory (see SolverOptions.n_double).
    n_double: int = 30
    # Column chunk of the layered solves: N > 0 columns at a time, 0 the
    # whole group at once, -1 (the default, as in the JAX Config) AUTO:
    # sized per solve from the card's free memory (SolverOptions.column_chunk).
    column_chunk: int = -1
    # Per-band Planck weights for nlw > 1 (normalized in consolidate()).
    lw_band_fraction: object = None

    @classmethod
    def from_namelist(cls, path: str) -> "Config":
        """Config with the &radsurf group of a namelist file applied."""
        cfg = cls()
        group = read_namelists(path).get("radsurf", {})
        names = {f.name for f in dataclasses.fields(cls)}
        for key, val in group.items():
            if key in names:
                setattr(cfg, key, val)
        return cfg

    def consolidate(self) -> "Config":
        self.nswinternal = self.nsw
        self.nlwinternal = self.nlw
        self.lg_sw_forest = LegendreGauss(self.n_stream_sw_forest)
        self.lg_sw_urban = LegendreGauss(self.n_stream_sw_urban)
        self.lg_lw_forest = LegendreGauss(self.n_stream_lw_forest)
        self.lg_lw_urban = LegendreGauss(self.n_stream_lw_urban)
        if self.lw_band_fraction is not None:
            w = np.atleast_1d(np.asarray(self.lw_band_fraction, np.float64))
            if w.size != self.nlw:
                raise ValueError(
                    f"lw_band_fraction has {w.size} entries but nlw ="
                    f" {self.nlw}"
                )
            if not np.all(w > 0.0):
                raise ValueError("lw_band_fraction entries must be > 0")
            self.lw_band_fraction = w / w.sum()
        return self

    def print_config(self, iverbose: int | None = None, out=None) -> None:
        """Echo the consolidated configuration at iverbose >= 2.

        Parity: config_type%print (radsurf/radsurf_config.F90:275-362),
        including the reference's fixed-width line layout
        (NPrintStringLen = 41, radsurf_config.F90:23).
        """
        write = (out or sys.stdout).write
        verb = self.iverbose if iverbose is None else iverbose
        if verb < 2:
            return

        def p_log(msg, name, val):
            s = f"{msg}{' ON ' if val else ' OFF'}"
            write(f"{s:<41} ({name}={'T' if val else 'F'})\n")

        def p_int(msg, name, val):
            write(f"{msg + ' = ' + str(int(val)):<41} ({name})\n")

        def p_real(msg, name, val):
            write(f"{msg + ' = ' + format(float(val), '.3g'):<41} ({name})\n")

        write("General settings:\n")
        p_log("  Represent vegetation", "do_vegetation", self.do_vegetation)
        p_log("  Represent urban areas", "do_urban", self.do_urban)
        p_log("  Do shortwave (SW) calculations", "do_sw", self.do_sw)
        p_log("  Do longwave (LW) calculations", "do_sw", self.do_lw)
        p_log("  Save broadband fluxes", "do_save_broadband_flux",
              self.do_save_broadband_flux)
        p_log("  Save spectral fluxes", "do_save_spectral_flux",
              self.do_save_spectral_flux)
        if self.do_sw:
            p_int("  Number of SW spectral intervals", "nsw", self.nsw)
        if self.do_lw:
            p_int("  Number of LW spectral intervals", "nlw", self.nlw)
        if self.do_vegetation:
            p_real("  Minimum vegetation fraction",
                   "min_vegetation_fraction", self.min_vegetation_fraction)
            write("Settings for forests:\n")
            p_int("  Number of vegetation regions",
                  "n_vegetation_region_forest",
                  self.n_vegetation_region_forest)
            p_log("  Use symmetric vegetation scale",
                  "use_symmetric_vegetation_scale_forest",
                  self.use_symmetric_vegetation_scale_forest)
            p_real("  Vegetation isolation factor",
                   "vegetation_isolation_factor_forest",
                   self.vegetation_isolation_factor_forest)
            if self.do_sw:
                p_int("  SW diffuse streams per hemisphere",
                      "n_stream_sw_forest", self.n_stream_sw_forest)
            if self.do_lw:
                p_int("  LW streams per hemisphere",
                      "n_stream_lw_forest", self.n_stream_lw_forest)
        if self.do_urban:
            write("Settings for urban areas:\n")
            p_real("  Minimum building fraction",
                   "min_building_fraction", self.min_building_fraction)
            if self.do_vegetation:
                p_int("  Number of vegetation regions",
                      "n_vegetation_region_urban",
                      self.n_vegetation_region_urban)
                p_log("  Use symmetric vegetation scale",
                      "use_symmetric_vegetation_scale_urban",
                      self.use_symmetric_vegetation_scale_urban)
                p_real("  Vegetation isolation factor",
                       "vegetation_isolation_factor_urban",
                       self.vegetation_isolation_factor_urban)
            if self.do_sw:
                p_int("  SW diffuse streams per hemisphere",
                      "n_stream_sw_urban", self.n_stream_sw_urban)
            if self.do_lw:
                p_int("  LW streams per hemisphere",
                      "n_stream_lw_urban", self.n_stream_lw_urban)


@dataclass
class DriverConfig:
    """Driver configuration (the &radsurf_driver namelist); -1 marks an
    override that is not set (spartacus_surface_config.F90:44-61)."""

    do_parallel: bool = True
    nblocksize: int = 16
    nrepeat: int = 1
    istartcol: int = 1
    iendcol: int = 0
    iverbose: int = 3
    do_conservation_check: bool = False

    cos_sza_override: float = -1.0
    ground_sw_albedo: float = -1.0
    roof_sw_albedo: float = -1.0
    wall_sw_albedo: float = -1.0
    ground_lw_emissivity: float = -1.0
    roof_lw_emissivity: float = -1.0
    wall_lw_emissivity: float = -1.0
    vegetation_fraction: float = -1.0
    vegetation_extinction: float = -1.0
    vegetation_extinction_scaling: float = -1.0
    vegetation_fsd: float = -1.0
    vegetation_sw_ssa: float = -1.0
    vegetation_lw_ssa: float = -1.0
    top_flux_dn_sw: float = -1.0
    top_flux_dn_direct_sw: float = -1.0
    top_flux_dn_lw: float = -1.0
    isurfacetype: int = -1

    @classmethod
    def from_namelist(cls, path: str) -> "DriverConfig":
        """DriverConfig with the &radsurf_driver group applied, including
        the solar_zenith_angle degrees alternative
        (spartacus_surface_config.F90:155-161)."""
        cfg = cls()
        group = read_namelists(path).get("radsurf_driver", {})
        names = {f.name for f in dataclasses.fields(cls)}
        renames = {"cos_solar_zenith_angle": "cos_sza_override"}
        sza_deg = None
        for key, val in group.items():
            key = renames.get(key, key)
            if key == "solar_zenith_angle":
                sza_deg = val
            elif key in names:
                setattr(cfg, key, val)
        if cfg.cos_sza_override == -1.0 and sza_deg is not None:
            if 0.0 <= sza_deg <= 180.0:
                cfg.cos_sza_override = math.cos(sza_deg * math.pi / 180.0)
        return cfg
