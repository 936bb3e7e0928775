"""Debug printing utilities.

Parity: utilities/print_matrix.F90 (print_matrix / print_vector, used by
the reference's eyeball-comparison kernel tests driver/test_sw.F90:60-76).
Port of print_matrix and print_vector of spartacus_surface_tpu/utils/
debug.py; they take numpy arrays or CPU tensors.
"""

from __future__ import annotations

import numpy as np


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
