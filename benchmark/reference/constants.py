"""[Frozen copy of spartacus_surface_tpu_torch/utils/constants.py.]

Physical constants.

Parity: reference radtool/radiation_constants.F90:24-32 (the same values as
spartacus_surface_tpu/utils/constants.py).
"""

Pi = 3.14159265358979323846
StefanBoltzmann = 5.67037321e-8  # W m-2 K-4
