"""Lightweight NetCDF read/write.

Replaces the reference's easy_netcdf wrapper (utilities/easy_netcdf.F90).
All the reference test inputs are classic NetCDF3 (CDF-1), which
scipy.io.netcdf handles without external dependencies; outputs are written
as NetCDF3 classic, matching the reference driver's default output format.

A copy of spartacus_surface_tpu/utils/netcdf_io.py (numpy and scipy, no JAX): the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from . import netcdf_c


def _is_classic(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(3) == b"CDF"


class InputFile:
    """Read-only NetCDF file with numpy-native variable access.

    Classic (CDF-1/2/5) files go through scipy; NetCDF4/HDF5 files go
    through the native libnetcdf binding (utils.netcdf_c), matching the
    reference's format coverage (easy_netcdf reads both).
    """

    def __init__(self, path: str):
        if _is_classic(path):
            self._native = None
            self._f = netcdf_file(path, "r", mmap=False)
        elif netcdf_c.available():
            self._native = netcdf_c.NativeFile(path, "r")
            self._f = None
        else:
            raise RuntimeError(
                f"{path} is not classic NetCDF and libnetcdf is unavailable"
            )

    def close(self):
        if self._native is not None:
            self._native.close()
        else:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def exists(self, name: str) -> bool:
        if self._native is not None:
            return self._native.exists(name)
        return name in self._f.variables

    def get(self, name: str, dtype=np.float64) -> np.ndarray:
        if self._native is not None:
            return self._native.get(name, dtype)
        v = self._f.variables[name]
        data = np.array(v[:])
        return data.astype(dtype)


class OutputFile:
    """NetCDF writer mirroring the easy_netcdf create/define/put API used
    by the output writer (radsurf/radsurf_save.F90).

    Default format is NetCDF3 classic via scipy (the reference driver's
    default); is_hdf5_file=True writes NetCDF4/HDF5 through the native
    libnetcdf binding (the reference's is_hdf5_file option,
    radsurf_save.F90:28,83-84).
    """

    def __init__(self, path: str, is_hdf5_file: bool = False):
        if is_hdf5_file:
            if not netcdf_c.available():
                raise RuntimeError("libnetcdf needed for NetCDF4 output")
            self._native = netcdf_c.NativeFile(path, "w", netcdf4=True)
            self._f = None
        else:
            self._native = None
            # version=2 = NetCDF3 with 64-bit offsets: identical headers
            # and data layout, but variables may start beyond 2 GiB —
            # production-scale outputs (10^5+ columns of spectral
            # profiles) overflow the version-1 int32 'begin' fields.
            self._f = netcdf_file(path, "w", version=2)

    def define_dimension(self, name: str, size: int):
        if self._native is not None:
            self._native.define_dimension(name, size)
        else:
            self._f.createDimension(name, size)

    def put_global_attributes(self, **attrs):
        for key, val in attrs.items():
            if self._native is not None:
                self._native.put_attribute(None, key, val)
            else:
                setattr(self._f, key, val)

    def define_variable(self, name, dims, dtype="d", units=None,
                        long_name=None, fill_value=None, **attrs):
        all_attrs = dict(attrs)
        if units is not None:
            all_attrs["units"] = units
        if long_name is not None:
            all_attrs["long_name"] = long_name
        if fill_value is not None:
            all_attrs["_FillValue"] = fill_value
        if self._native is not None:
            np_dtype = {"d": np.float64, "f": np.float32, "h": np.int16,
                        "i": np.int32}[dtype]
            self._native.define_variable(name, dims, np_dtype, **all_attrs)
            return None
        var = self._f.createVariable(name, dtype, dims)
        for key, val in all_attrs.items():
            setattr(var, key, val)
        return var

    def put(self, name, data):
        if self._native is not None:
            self._native.put(name, data)
        else:
            self._f.variables[name][:] = np.asarray(data)

    def close(self):
        if self._native is not None:
            self._native.close()
        else:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
