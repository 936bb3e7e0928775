"""Duplicate the columns of an input file across a sweep of solar zenith
angles.

Replaces the reference's nco-based duplicate_profiles.sh
(test/rami4pilps/duplicate_profiles.sh, test/urban/duplicate_profiles.sh):
replicates every variable with a leading column dimension NSZA times and
overwrites cos_solar_zenith_angle with the standard 46-angle sweep (or a
user-provided list).

Usage: python -m spartacus_surface_tpu_torch.driver.duplicate_profiles in.nc out.nc

A copy of spartacus_surface_tpu/driver/duplicate_profiles.py (numpy and scipy, no JAX): the
port imports nothing of the JAX package.  Unlike the copy's original it
writes 64-bit offsets, so that outputs beyond 2 GiB can be written.
"""

from __future__ import annotations

import sys

import numpy as np
from scipy.io import netcdf_file

# The 46 cosines of duplicate_profiles.sh (0 to ~89.4 degrees)
DEFAULT_COS_SZA = np.array([
    1.0, 0.999391, 0.997564, 0.994522, 0.990268, 0.984808, 0.978148,
    0.970296, 0.961262, 0.951057, 0.939693, 0.927184, 0.913545, 0.898794,
    0.882948, 0.866025, 0.848048, 0.829038, 0.809017, 0.788011, 0.766044,
    0.743145, 0.71934, 0.694658, 0.669131, 0.642788, 0.615661, 0.587785,
    0.559193, 0.529919, 0.5, 0.469472, 0.438371, 0.406737, 0.374607,
    0.34202, 0.309017, 0.275637, 0.241922, 0.207912, 0.173648, 0.139173,
    0.104528, 0.0697565, 0.0348995, 0.01,
])


def duplicate_profiles(in_path: str, out_path: str, cos_sza=None,
                       n_copies: int | None = None):
    cos_sza = DEFAULT_COS_SZA if cos_sza is None else np.asarray(cos_sza)
    src = netcdf_file(in_path, "r", mmap=False)
    ncol_in = src.dimensions["column"]
    if n_copies is None:
        n_copies = len(cos_sza)
    # NetCDF3 with 64-bit offsets (as utils/netcdf_io writes): a classic
    # file's int32 variable offsets overflow beyond 2 GiB, which 50,048
    # copies of one 62-layer, 14-band profile exceed
    dst = netcdf_file(out_path, "w", version=2)
    for name, size in src.dimensions.items():
        dst.createDimension(name, n_copies * ncol_in if name == "column"
                            else size)
    for name, var in src.variables.items():
        data = np.array(var[:])
        if var.dimensions and var.dimensions[0] == "column":
            data = np.tile(data, (n_copies,) + (1,) * (data.ndim - 1))
        if name == "cos_solar_zenith_angle":
            data = np.repeat(cos_sza[:n_copies], ncol_in)
        v = dst.createVariable(name, data.dtype.char, var.dimensions)
        v[:] = data
    src.close()
    dst.close()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 1
    duplicate_profiles(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
