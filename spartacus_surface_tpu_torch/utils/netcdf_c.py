"""Native NetCDF backend: ctypes binding to the system C libnetcdf.

The reference's I/O layer is a 2357-line Fortran wrapper over the NetCDF C
library (utilities/easy_netcdf.F90) supporting both classic NetCDF3 and
NetCDF4/HDF5 files.  scipy's pure-python reader only handles classic files,
so this module provides the native-library path: it binds libnetcdf.so
directly and reads any format the system library supports (including
NetCDF4/HDF5), plus writes NetCDF4 when requested (the reference's
is_hdf5_file output option, radsurf_save.F90:28,83-84).

Used automatically by utils.netcdf_io when available; falls back to scipy.

A copy of spartacus_surface_tpu/utils/netcdf_c.py (numpy and ctypes, no JAX): the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

NC_NOWRITE = 0
NC_CLOBBER = 0
NC_NETCDF4 = 0x1000
NC_GLOBAL = -1

# NetCDF external data types
NC_BYTE, NC_CHAR, NC_SHORT, NC_INT, NC_FLOAT, NC_DOUBLE = 1, 2, 3, 4, 5, 6
NC_UBYTE, NC_USHORT, NC_UINT, NC_INT64, NC_UINT64, NC_STRING = (
    7, 8, 9, 10, 11, 12)

_DTYPES = {
    NC_BYTE: np.int8, NC_CHAR: np.uint8, NC_SHORT: np.int16,
    NC_INT: np.int32, NC_FLOAT: np.float32, NC_DOUBLE: np.float64,
    NC_UBYTE: np.uint8, NC_USHORT: np.uint16, NC_UINT: np.uint32,
    NC_INT64: np.int64, NC_UINT64: np.uint64,
}
_NC_TYPE_FOR = {
    np.dtype(np.float64): NC_DOUBLE, np.dtype(np.float32): NC_FLOAT,
    np.dtype(np.int32): NC_INT, np.dtype(np.int16): NC_SHORT,
    np.dtype(np.int64): NC_INT64, np.dtype(np.int8): NC_BYTE,
}

_lib: Optional[ctypes.CDLL] = None


def load_library() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    for name in ("libnetcdf.so", "libnetcdf.so.19", "libnetcdf.so.18",
                 "libnetcdf.so.15", ctypes.util.find_library("netcdf")):
        if not name:
            continue
        try:
            _lib = ctypes.CDLL(name)
            _lib.nc_strerror.restype = ctypes.c_char_p
            return _lib
        except OSError:
            continue
    return None


def available() -> bool:
    return load_library() is not None


class NetCDFError(RuntimeError):
    pass


def _check(status: int):
    if status != 0:
        lib = load_library()
        raise NetCDFError(lib.nc_strerror(status).decode())


class NativeFile:
    """Minimal read/write handle over the C library."""

    def __init__(self, path: str, mode: str = "r", netcdf4: bool = False):
        lib = load_library()
        if lib is None:
            raise NetCDFError("libnetcdf not found")
        self._lib = lib
        self._ncid = ctypes.c_int()
        if mode == "r":
            _check(lib.nc_open(path.encode(), NC_NOWRITE,
                               ctypes.byref(self._ncid)))
        elif mode == "w":
            cmode = NC_CLOBBER | (NC_NETCDF4 if netcdf4 else 0)
            _check(lib.nc_create(path.encode(), cmode,
                                 ctypes.byref(self._ncid)))
        else:
            raise ValueError(mode)
        self._defined = mode == "r"
        self._dimids: dict[str, int] = {}
        self._varids: dict[str, int] = {}
        self._vartypes: dict[str, int] = {}

    # ---------------- read ----------------

    def variables(self) -> list[str]:
        nvars = ctypes.c_int()
        _check(self._lib.nc_inq_nvars(self._ncid, ctypes.byref(nvars)))
        names = []
        buf = ctypes.create_string_buffer(256)
        for varid in range(nvars.value):
            _check(self._lib.nc_inq_varname(self._ncid, varid, buf))
            names.append(buf.value.decode())
        return names

    def dimensions(self) -> dict[str, int]:
        ndims = ctypes.c_int()
        _check(self._lib.nc_inq_ndims(self._ncid, ctypes.byref(ndims)))
        out = {}
        buf = ctypes.create_string_buffer(256)
        size = ctypes.c_size_t()
        for dimid in range(ndims.value):
            _check(self._lib.nc_inq_dim(self._ncid, dimid, buf,
                                        ctypes.byref(size)))
            out[buf.value.decode()] = size.value
        return out

    def _varid(self, name: str) -> int:
        varid = ctypes.c_int()
        _check(self._lib.nc_inq_varid(self._ncid, name.encode(),
                                      ctypes.byref(varid)))
        return varid.value

    def exists(self, name: str) -> bool:
        varid = ctypes.c_int()
        return self._lib.nc_inq_varid(
            self._ncid, name.encode(), ctypes.byref(varid)
        ) == 0

    def var_info(self, name: str):
        varid = self._varid(name)
        xtype = ctypes.c_int()
        ndims = ctypes.c_int()
        dimids = (ctypes.c_int * 32)()
        _check(self._lib.nc_inq_var(self._ncid, varid, None,
                                    ctypes.byref(xtype),
                                    ctypes.byref(ndims), dimids, None))
        shape = []
        size = ctypes.c_size_t()
        buf = ctypes.create_string_buffer(256)
        dims = []
        for i in range(ndims.value):
            _check(self._lib.nc_inq_dim(self._ncid, dimids[i], buf,
                                        ctypes.byref(size)))
            shape.append(size.value)
            dims.append(buf.value.decode())
        return varid, xtype.value, tuple(shape), tuple(dims)

    def attributes(self, varname: Optional[str] = None) -> dict:
        """Attributes of a variable (or global when varname is None)."""
        natts = ctypes.c_int()
        if varname is None:
            varid = NC_GLOBAL
            _check(self._lib.nc_inq_natts(self._ncid, ctypes.byref(natts)))
        else:
            varid = self._varid(varname)
            _check(self._lib.nc_inq_varnatts(self._ncid, varid,
                                             ctypes.byref(natts)))
        out = {}
        buf = ctypes.create_string_buffer(256)
        for i in range(natts.value):
            _check(self._lib.nc_inq_attname(self._ncid, varid, i, buf))
            name = buf.value.decode()
            xtype = ctypes.c_int()
            alen = ctypes.c_size_t()
            _check(self._lib.nc_inq_att(self._ncid, varid, name.encode(),
                                        ctypes.byref(xtype),
                                        ctypes.byref(alen)))
            if xtype.value == NC_CHAR:
                sbuf = ctypes.create_string_buffer(alen.value + 1)
                _check(self._lib.nc_get_att_text(
                    self._ncid, varid, name.encode(), sbuf))
                out[name] = sbuf.raw[: alen.value].decode(errors="replace")
            elif xtype.value == NC_STRING:
                # Variable-length strings: nc_get_att_string fills an
                # array of library-owned char* (freed via nc_free_string)
                # — nc_get_att_text on these would return pointer bytes.
                ptrs = (ctypes.c_char_p * alen.value)()
                _check(self._lib.nc_get_att_string(
                    self._ncid, varid, name.encode(), ptrs))
                vals = [
                    (p or b"").decode(errors="replace")
                    for p in ptrs
                ]
                self._lib.nc_free_string(alen.value, ptrs)
                out[name] = vals[0] if alen.value == 1 else vals
            elif np.issubdtype(_DTYPES.get(xtype.value, np.float64),
                               np.integer):
                # Integer-typed attributes keep integer identity so a
                # merge re-writes them with the same type.
                arr = np.empty(alen.value, np.int64)
                _check(self._lib.nc_get_att_longlong(
                    self._ncid, varid, name.encode(),
                    arr.ctypes.data_as(ctypes.c_void_p)))
                out[name] = arr if arr.size > 1 else int(arr[0])
            else:
                arr = np.empty(alen.value, np.float64)
                _check(self._lib.nc_get_att_double(
                    self._ncid, varid, name.encode(),
                    arr.ctypes.data_as(ctypes.c_void_p)))
                out[name] = arr if arr.size > 1 else float(arr[0])
        return out

    def get(self, name: str, dtype=np.float64) -> np.ndarray:
        varid, xtype, shape, _ = self.var_info(name)
        np_type = _DTYPES.get(xtype)
        if np_type is None:
            raise NetCDFError(f"unsupported NetCDF type {xtype} for {name}")
        out = np.empty(shape, np_type)
        getter = {
            np.float64: self._lib.nc_get_var_double,
            np.float32: self._lib.nc_get_var_float,
            np.int32: self._lib.nc_get_var_int,
            np.int16: self._lib.nc_get_var_short,
            np.int64: self._lib.nc_get_var_longlong,
            np.int8: self._lib.nc_get_var_schar,
            np.uint8: self._lib.nc_get_var_ubyte,
            np.uint16: self._lib.nc_get_var_ushort,
            np.uint32: self._lib.nc_get_var_uint,
            np.uint64: self._lib.nc_get_var_ulonglong,
        }[np_type]
        _check(getter(self._ncid, varid,
                      out.ctypes.data_as(ctypes.c_void_p)))
        return out.astype(dtype)

    # ---------------- write ----------------

    def define_dimension(self, name: str, size: int):
        dimid = ctypes.c_int()
        _check(self._lib.nc_def_dim(self._ncid, name.encode(), size,
                                    ctypes.byref(dimid)))
        self._dimids[name] = dimid.value

    def define_variable(self, name: str, dims, dtype=np.float64, **attrs):
        nc_type = _NC_TYPE_FOR[np.dtype(dtype)]
        dimids = (ctypes.c_int * len(dims))(
            *[self._dimids[d] for d in dims]
        )
        varid = ctypes.c_int()
        _check(self._lib.nc_def_var(self._ncid, name.encode(), nc_type,
                                    len(dims), dimids, ctypes.byref(varid)))
        self._varids[name] = varid.value
        self._vartypes[name] = nc_type
        for key, val in attrs.items():
            self.put_attribute(name, key, val)

    def put_attribute(self, varname, key, val):
        varid = NC_GLOBAL if varname is None else self._varids[varname]
        if isinstance(val, str):
            data = val.encode()
            _check(self._lib.nc_put_att_text(self._ncid, varid, key.encode(),
                                             len(data), data))
            return
        arr = np.atleast_1d(np.asarray(val))
        if (key == "_FillValue"
                and self._vartypes.get(varname) == NC_FLOAT):
            # libnetcdf (NetCDF4 mode) REQUIRES _FillValue to have the
            # variable's own type; a double fill on a float variable is
            # rejected with 'Not a valid data type or _FillValue type
            # mismatch'.
            farr = np.ascontiguousarray(arr, np.float32)
            _check(self._lib.nc_put_att_float(
                self._ncid, varid, key.encode(), NC_FLOAT, farr.size,
                farr.ctypes.data_as(ctypes.c_void_p)))
            return
        if np.issubdtype(arr.dtype, np.integer) and np.all(
            (arr >= np.iinfo(np.int32).min) & (arr <= np.iinfo(np.int32).max)
        ):
            # Keep integer attributes integer (classic-format-safe NC_INT).
            iarr = np.ascontiguousarray(arr, np.int32)
            _check(self._lib.nc_put_att_int(
                self._ncid, varid, key.encode(), NC_INT, iarr.size,
                iarr.ctypes.data_as(ctypes.c_void_p)))
            return
        farr = np.ascontiguousarray(arr, np.float64)
        _check(self._lib.nc_put_att_double(
            self._ncid, varid, key.encode(), NC_DOUBLE, farr.size,
            farr.ctypes.data_as(ctypes.c_void_p)))

    def end_define(self):
        if not self._defined:
            self._lib.nc_enddef(self._ncid)
            self._defined = True

    def put(self, name: str, data):
        self.end_define()
        data = np.ascontiguousarray(data)
        varid = self._varids[name]
        putter = {
            np.dtype(np.float64): self._lib.nc_put_var_double,
            np.dtype(np.float32): self._lib.nc_put_var_float,
            np.dtype(np.int32): self._lib.nc_put_var_int,
            np.dtype(np.int16): self._lib.nc_put_var_short,
            np.dtype(np.int64): self._lib.nc_put_var_longlong,
        }[data.dtype]
        _check(putter(self._ncid, varid,
                      data.ctypes.data_as(ctypes.c_void_p)))

    def close(self):
        if self._ncid.value >= 0:
            self._lib.nc_close(self._ncid)
            self._ncid = ctypes.c_int(-1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
