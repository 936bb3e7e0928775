"""Debug printing utilities.

Parity: utilities/print_matrix.F90 (print_matrix / print_vector, used by
the reference's PRINT_ARRAYS debug path, e.g. radsurf_forest_sw.F90:
389-403, and its eyeball-comparison kernel tests driver/test_sw.F90:60-76).
Port of spartacus_surface_tpu/utils/debug.py.

Setting the environment variable SPARTACUS_DEBUG_ARRAYS=1 makes run_radsurf
print the geometry and the assembled Gamma matrices of the first column and
band of each shortwave group (solver.debug_dump_sw, the PRINT_ARRAYS
equivalent).
"""

from __future__ import annotations

import os

import numpy as np


def debug_arrays_enabled() -> bool:
    return os.environ.get("SPARTACUS_DEBUG_ARRAYS", "0") not in ("0", "")


def print_vector(name: str, vec, printer=print):
    """Parity: print_vector, utilities/print_matrix.F90."""
    vals = " ".join(f"{v:10.6f}" for v in np.asarray(vec).ravel())
    printer(f"{name} = {vals}")


def print_matrix(name: str, mat, printer=print):
    """Parity: print_matrix, utilities/print_matrix.F90."""
    mat = np.asarray(mat)
    printer(f"{name} =")
    for row in np.atleast_2d(mat):
        printer("  " + " ".join(f"{v:10.6f}" for v in row))


def maybe_dump(tag: str, arrays: dict):
    """Print the first-column / first-band slices of named arrays (numpy
    arrays or tensors, on any device) when SPARTACUS_DEBUG_ARRAYS is set;
    tensors reach the host only then."""
    if not debug_arrays_enabled():
        return
    print(f"--- DEBUG ARRAYS: {tag} ---")
    for name, arr in arrays.items():
        a = np.asarray(arr.detach().cpu() if hasattr(arr, "detach") else arr)
        while a.ndim > 2:
            a = a[0]
        if a.ndim <= 1:
            print_vector(name, a)
        else:
            print_matrix(name, a)
