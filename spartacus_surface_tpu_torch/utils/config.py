"""Algorithm configuration (the &radsurf namelist).

The fields are those of spartacus_surface_tpu/utils/config.py ``Config``
(radsurf/radsurf_config.F90:32-113); tests/test_torch_ops.py holds the two
field lists equal.  The dataclass is declared here rather than imported
because the JAX package's ``Config.consolidate`` imports JAX (through
``spartacus_surface_tpu.ops``), and this package must import nothing of the
JAX package.  ``consolidate`` builds this package's ``LegendreGauss``.
The namelist reader and ``print_config`` arrive with the CLI.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops.legendre_gauss import LegendreGauss


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
    # Column chunk of the layered solve: 0 = whole batch, N > 0 = N columns.
    column_chunk: int = 0
    # Per-band Planck weights for nlw > 1 (normalized in consolidate()).
    lw_band_fraction: object = None

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
