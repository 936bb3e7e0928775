"""[Frozen copy of spartacus_surface_tpu_torch/ops/matrix.py, the plain
route's small-matrix algebra, with every matrix product routed through
``matmul`` / ``einsum`` so that the benchmark's control can round their
operands to TF32 (``tf32_products``).]

Batched small-matrix algebra on tensors shaped [..., n, m].  ``solve`` is
Cramer for n = 2 and a LAPACK-style pivoted solve above.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

# operand rounding of every matrix product (None: none; "tf32": to the
# 10-bit mantissa of TF32), set by tf32_products
_rounding = {"mode": None}


def _tf32(x):
    """float32 x rounded to nearest (ties away) at TF32's 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def tf32_products():
    """Within: the operands of every matrix product and contraction of
    this package are rounded to TF32, as a GPU's tensor cores take float32
    operands with TF32 on (accumulation stays float32)."""
    prev = _rounding["mode"]
    _rounding["mode"] = "tf32"
    try:
        yield
    finally:
        _rounding["mode"] = prev


def _round(x):
    if _rounding["mode"] == "tf32" and x.dtype == torch.float32:
        return _tf32(x)
    return x


def constant(x, device, dtype=None) -> torch.Tensor:
    """The numpy constant x as a tensor of dtype on device."""
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def matmul(a, b):
    """Batched matrix product: [..., n, k] @ [..., k, m]."""
    return torch.matmul(_round(a), _round(b))


def einsum(spec, *xs):
    """torch.einsum with the product rounding of matmul."""
    return torch.einsum(spec, *(_round(x) for x in xs))


def matvec(a, x):
    """Batched matrix-vector product: [..., n, k] @ [..., k]."""
    return matmul(a, x[..., None])[..., 0]


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
