"""Batched small-matrix algebra on tensors shaped [..., n, m].

Port of spartacus_surface_tpu/ops/matrix.py.  ``solve`` follows the JAX
package's CPU route (Cramer for n = 2, a LAPACK-style pivoted solve above),
which is what the port's plain path is held against; the pivot-free
Doolittle LU of the reference (radtool_matrix.F90:982-1055) is kept as
``_lu_factor_nopiv`` / ``_lu_solve_nopiv``, and is what the CUDA kernels
run.
"""

from __future__ import annotations

import torch


def matmul(a, b):
    """Batched matrix product: [..., n, k] @ [..., k, m]."""
    return torch.matmul(a, b)


def matvec(a, x):
    """Batched matrix-vector product: [..., n, k] @ [..., k]."""
    return torch.matmul(a, x[..., None])[..., 0]


def _lu_factor_nopiv(a):
    """Doolittle LU without pivoting; returns the combined LU matrix (unit
    lower triangle implicit).  Parity: radtool_matrix.F90:982-1015."""
    a = a.clone()
    n = a.shape[-1]
    for k in range(n - 1):
        col = a[..., k + 1:, k] / a[..., k, k][..., None]
        a[..., k + 1:, k] = col
        a[..., k + 1:, k + 1:] -= col[..., :, None] * a[..., k:k + 1, k + 1:]
    return a


def _lu_solve_nopiv(lu, b):
    """Solve with a factored LU; b is [..., n, m].
    Parity: radtool_matrix.F90:1024-1055."""
    b = b.clone()
    n = lu.shape[-1]
    for i in range(1, n):
        b[..., i, :] -= torch.einsum("...k,...km->...m", lu[..., i, :i],
                                     b[..., :i, :])
    b[..., n - 1, :] /= lu[..., n - 1, n - 1][..., None]
    for i in range(n - 2, -1, -1):
        rhs = b[..., i, :] - torch.einsum(
            "...k,...km->...m", lu[..., i, i + 1:], b[..., i + 1:, :])
        b[..., i, :] = rhs / lu[..., i, i][..., None]
    return b


def _solve2(a, b):
    """Cramer 2x2 solve (parity: radtool_matrix.F90:779-825)."""
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    inv_det = (1.0 / det)[..., None]
    x0 = a[..., 1, 1][..., None] * b[..., 0, :] - a[..., 0, 1][..., None] * b[..., 1, :]
    x1 = a[..., 0, 0][..., None] * b[..., 1, :] - a[..., 1, 0][..., None] * b[..., 0, :]
    return torch.stack([x0 * inv_det, x1 * inv_det], dim=-2)


def solve(a, b):
    """Batched solve a @ x = b; b is [..., n, m] or [..., n] (vector RHS).
    Parity: solve_mat/solve_vec, radtool_matrix.F90:1119-1199."""
    vector = b.ndim == a.ndim - 1
    if vector:
        b = b[..., None]
    if a.shape[-1] == 1:
        x = b / a[..., :, :1]
    elif a.shape[-1] == 2:
        x = _solve2(a, b)
    else:
        # No singularity check (as LAPACK under jnp.linalg.solve): a padding
        # layer's zero Gamma gives non-finite integrals that multiply a zero
        # flux convergence and never reach a real layer.
        x = torch.linalg.solve_ex(a, b)[0]
    return x[..., 0] if vector else x


def inv(a):
    """Batched inverse (radtool_matrix.F90:1057-1116)."""
    return solve(a, identity_like(a))


def identity_like(a):
    n = a.shape[-1]
    return torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)


# Diagonal Pade [7/7] numerator coefficients (cf. radtool_matrix.F90:1246-1344)
PADE7_B = (17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0,
           56.0, 1.0)


def expm_pade7(a):
    """Batched matrix exponential, diagonal Pade [7/7], no scaling and
    squaring: the caller pre-scales so that ||a|| is small."""
    b = PADE7_B
    eye = identity_like(a)
    a2 = matmul(a, a)
    a4 = matmul(a2, a2)
    a6 = matmul(a2, a4)
    u = matmul(a, b[7] * a6 + b[5] * a4 + b[3] * a2 + b[1] * eye)
    v = b[6] * a6 + b[4] * a4 + b[2] * a2 + b[0] * eye
    return solve(v - u, v + u)
