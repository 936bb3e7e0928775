"""Merge per-process output shards into the single output file.

The reference driver always produces exactly one output NetCDF
(driver/spartacus_surface_driver.F90:295-296, radsurf/radsurf_save.F90:26).
Multi-process runs of this driver write one OUTPUT.pNN shard per process
(each holding that process's contiguous column slice); this module
reassembles them into the single OUTPUT the reference contract promises:
column-axis variables are concatenated in process order, every other
variable must be bit-identical across shards, and layer-type dimensions
(which can differ between shards when the deepest canopy of each slice
differs) are padded to the merged maximum with each variable's own fill
value.

Used automatically by the CLI driver (process 0 merges after a cross-
process barrier) and available standalone:

    python -m spartacus_surface_tpu_torch.driver.merge out.nc [--np N] [--keep]

Port of spartacus_surface_tpu/driver/merge.py (numpy, scipy and the port's
own utils/netcdf_io and utils/netcdf_c); it matches each shard's variables
by name, where the JAX package's matches them by position.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

import numpy as np
from scipy.io import netcdf_file

from ..utils import netcdf_c
from ..utils.netcdf_io import OutputFile, _is_classic

COLUMN_DIM = "column"
# Dimensions sized by the deepest canopy in the shard: pad to the merged
# maximum (radsurf_save.F90 sizes them from maxval(nlay)).
_LAYER_DIMS = ("layer", "layer_interface")

_TYPECODES = {"d": np.float64, "f": np.float32, "h": np.int16,
              "i": np.int32, "b": np.int8, "l": np.int64}
_CODE_FOR = {np.dtype(v): k for k, v in _TYPECODES.items()}


def _read_shard(path):
    """-> (dims, global_attrs, [(name, dims, typecode, attrs, data), ...]).

    Classic files via scipy, NetCDF4/HDF5 via the native libnetcdf
    binding; both return numpy data in file variable order.
    """
    if _is_classic(path):
        f = netcdf_file(path, "r", mmap=False)
        dims = {k: v for k, v in f.dimensions.items()}
        gattrs = {
            k: (v.decode() if isinstance(v, bytes) else v)
            for k, v in f._attributes.items()
        }
        out = []
        for name, v in f.variables.items():
            attrs = {
                k: (val.decode() if isinstance(val, bytes) else val)
                for k, val in v._attributes.items()
            }
            out.append((name, tuple(v.dimensions), v.typecode(),
                        attrs, np.array(v[:])))
        f.close()
        return dims, gattrs, out
    if not netcdf_c.available():
        raise RuntimeError(
            f"{path} is not classic NetCDF and libnetcdf is unavailable"
        )
    with netcdf_c.NativeFile(path, "r") as f:
        dims = f.dimensions()
        gattrs = f.attributes(None)
        out = []
        for name in f.variables():
            _, xtype, _, vdims = f.var_info(name)
            np_type = netcdf_c._DTYPES[xtype]
            code = _CODE_FOR[np.dtype(np_type)]
            out.append((name, vdims, code, f.attributes(name),
                        f.get(name, np_type)))
    return dims, gattrs, out


def _pad_layer_axes(data, vdims, dims_merged, fill):
    """Pad any layer-type axis of one shard's variable to the merged size."""
    for ax, dname in enumerate(vdims):
        if dname in _LAYER_DIMS and data.shape[ax] < dims_merged[dname]:
            widths = [(0, 0)] * data.ndim
            widths[ax] = (0, dims_merged[dname] - data.shape[ax])
            data = np.pad(data, widths, constant_values=fill)
    return data


def find_shards(output: str, n_processes: int | None = None) -> list[str]:
    """The ordered .pNN shard paths for `output` (validated contiguous)."""
    if n_processes is not None:
        paths = [f"{output}.p{pid:02d}" for pid in range(n_processes)]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(f"missing shards: {missing}")
        return paths
    # Numeric sort on the rank: the CLI writes p{pid:02d}, which grows
    # to three+ digits at >= 100 processes, so neither a fixed-width glob
    # nor a lexical sort is safe.
    candidates = [
        (int(m.group(1)), p)
        for p in glob.glob(glob.escape(output) + ".p[0-9]*")
        if (m := re.search(r"\.p(\d+)$", p))
    ]
    if not candidates:
        raise FileNotFoundError(f"no {output}.pNN shards found")
    candidates.sort()
    pids = [pid for pid, _ in candidates]
    if pids != list(range(len(pids))):
        raise FileNotFoundError(
            f"shard ranks are not contiguous from 0: {pids}"
        )
    return [p for _, p in candidates]


def merge_shards(output: str, n_processes: int | None = None,
                 delete: bool = True, is_hdf5_file: bool = False) -> str:
    """Concatenate OUTPUT.pNN shards into the single OUTPUT file.

    Column-dimension variables concatenate along axis 0 in rank order;
    non-column variables must be identical in every shard (verified);
    per-shard layer dimensions pad up to the merged maximum with each
    variable's _FillValue.  Returns the merged path.
    """
    paths = find_shards(output, n_processes)
    shards = [_read_shard(p) for p in paths]
    dims0, gattrs, vars0 = shards[0]

    dims_merged = dict(dims0)
    for dims_p, _, _ in shards[1:]:
        if set(dims_p) != set(dims0):
            raise ValueError(
                f"shard dimensions differ: {sorted(dims_p)} vs"
                f" {sorted(dims0)}"
            )
        for name, size in dims_p.items():
            if name == COLUMN_DIM:
                dims_merged[name] += size
            elif name in _LAYER_DIMS:
                dims_merged[name] = max(dims_merged[name], size)
            elif size != dims0[name]:
                raise ValueError(
                    f"non-column dimension {name!r} differs between"
                    f" shards: {size} vs {dims0[name]}"
                )

    # Variables are matched by name: a classic file lists them in an order
    # that follows its dimension sizes (scipy writes them sorted by
    # shape), so shards of different layer depth list them differently.
    by_name = [{v[0]: v for v in vars_p} for _, _, vars_p in shards]
    names0 = [v[0] for v in vars0]
    for k, named in enumerate(by_name[1:], start=1):
        if set(named) != set(names0):
            raise ValueError(
                f"shard variables differ between shard 0 and shard {k}:"
                f" {sorted(set(named) ^ set(names0))}"
            )
    merged = []
    for name, vdims, code, attrs, first in vars0:
        pieces = []
        for named in by_name:
            _, vdims_p, _, _, data_p = named[name]
            if vdims_p != vdims:
                raise ValueError(
                    f"shard variable mismatch: {name}{vdims_p} vs {name}{vdims}"
                )
            pieces.append(data_p)
        if vdims and vdims[0] == COLUMN_DIM:
            fill = attrs.get("_FillValue", 0)
            pieces = [
                _pad_layer_axes(p, vdims, dims_merged, fill) for p in pieces
            ]
            data = np.concatenate(pieces, axis=0)
        else:
            for k, p in enumerate(pieces[1:], start=1):
                if not np.array_equal(p, first):
                    raise ValueError(
                        f"non-column variable {name!r} differs between"
                        f" shard 0 and shard {k}"
                    )
            data = first
        merged.append((name, vdims, code, attrs, data))

    with OutputFile(output, is_hdf5_file=is_hdf5_file) as out:
        for name, size in dims_merged.items():
            out.define_dimension(name, size)
        out.put_global_attributes(**gattrs)
        for name, vdims, code, attrs, _ in merged:
            out.define_variable(name, vdims, dtype=code, **attrs)
        for name, _, _, _, data in merged:
            out.put(name, data)

    if delete:
        for p in paths:
            os.remove(p)
    return output


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m spartacus_surface_tpu_torch.driver.merge",
        description="Merge multi-process OUTPUT.pNN shards into OUTPUT",
    )
    p.add_argument("output", help="Merged output path (shards: OUTPUT.pNN)")
    p.add_argument("--np", type=int, default=None, metavar="N",
                   help="Expected shard count (default: autodiscover)")
    p.add_argument("--keep", action="store_true",
                   help="Keep the .pNN shards after merging")
    p.add_argument("--netcdf4", action="store_true",
                   help="Write the merged file as NetCDF4/HDF5")
    args = p.parse_args(argv)
    try:
        merge_shards(args.output, n_processes=args.np,
                     delete=not args.keep, is_hdf5_file=args.netcdf4)
    except (FileNotFoundError, ValueError, RuntimeError) as exc:
        print(f"*** Error merging shards: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
