"""[Frozen copy of spartacus_surface_tpu_torch/ops/layer_matrices.py.]

Per-layer reflectance/transmittance/source factory: the plain version of
kernel K1 (ops/layer_kernel.py, csrc/layer_factory.cu).

Port of spartacus_surface_tpu/ops/layer_matrices.py.  Per batch element:
assemble the two-point boundary-value matrix

    Gamma = [ -g1  -g2  -g3 ]
            [ +g2  +g1  +g3 ]
            [   0    0   g0 ]

(radtool_calc_matrices_sw_eig.F90:62-66), take F = expm(Gamma dz 2^-K) by a
diagonal Pade-7 approximant with K = ceil(log2(||Gamma dz||_inf / theta))
capped at n_double, extract the thin-layer R, T, E, Sup, Sdn, run K
adding-doubling steps (each element its own K), and form the block-Schur
Gamma-inverse absorption integrals (radtool_schur.F90:32-53).  The longwave
runs the same factory with the emission as a unit pseudo-beam
(``lw_layer_matrices``).
"""

from __future__ import annotations

import torch

from .matrix import expm_pade7, inv, matmul, matvec, solve

# Per-precision Pade-7 scaling threshold (see the JAX module): every path of
# one precision picks the same K per element.
PADE7_THETA_F32 = 3.9
PADE7_THETA_F64 = 2.0


def pade7_theta(dtype) -> float:
    """Scaling threshold for the given working dtype."""
    return PADE7_THETA_F32 if dtype == torch.float32 else PADE7_THETA_F64


def combine_layers(top: dict, bot: dict) -> dict:
    """Adding method: stack layer `top` above layer `bot` (R, T [..., nd, nd];
    E [..., ndir, ndir]; Sup, Sdn [..., nd, ndir])."""
    R1, T1, E1, S1u, S1d = top["R"], top["T"], top["E"], top["Sup"], top["Sdn"]
    R2, T2, E2, S2u, S2d = bot["R"], bot["T"], bot["E"], bot["Sup"], bot["Sdn"]
    nd = R1.shape[-1]
    eye = torch.eye(nd, dtype=R1.dtype, device=R1.device)

    s2u_e1 = matmul(S2u, E1)
    s_mid = S1d + matmul(R1, s2u_e1)
    vt_vs = solve(eye - matmul(R1, R2), torch.cat([T1, s_mid], dim=-1))
    vt = vt_vs[..., :nd]
    vs = vt_vs[..., nd:]
    return {
        "R": R1 + matmul(T1, matmul(R2, vt)),
        "T": matmul(T2, vt),
        "E": matmul(E2, E1),
        "Sup": S1u + matmul(T1, matmul(R2, vs) + s2u_e1),
        "Sdn": matmul(T2, vs) + matmul(S2d, E1),
    }


def doubling_steps(g_dz, n_double: int):
    """The doubling steps K of each element of Gamma dz [..., n, n]:
    ceil(log2(||Gamma dz||_inf / theta)), clamped to [0, n_double]."""
    theta = pade7_theta(g_dz.dtype)
    nrm = g_dz.abs().sum(-1).amax(-1)
    return torch.clamp(torch.ceil(torch.log2(nrm.clamp_min(1e-30) / theta)),
                       0, n_double)


def layer_matrices(gamma0, gamma1, gamma2, gamma3, dz, *,
                   n_double: int = 30, int_direct: bool = True) -> dict:
    """Per-layer operators for a batch of layers (the JAX function with
    with_int on).

    gamma0 [..., ndir, ndir], gamma1/gamma2 [..., nd, nd],
    gamma3 [..., nd, ndir], dz [...] (0 gives the exact identity layer).
    Returns R, T, E, Sup, Sdn, int_diff and, with int_direct, int_dir and
    int_dir_diff (False for the longwave, where gamma0 = 0 is singular).
    """
    nd = gamma1.shape[-1]
    ndir = gamma0.shape[-1]
    dz = torch.as_tensor(dz, dtype=gamma1.dtype, device=gamma1.device)
    batch = torch.broadcast_shapes(gamma0.shape[:-2], gamma1.shape[:-2],
                                   gamma3.shape[:-2], dz.shape)
    ex = lambda g: g.expand(batch + g.shape[-2:])
    gamma0, gamma1, gamma2, gamma3 = map(ex, (gamma0, gamma1, gamma2, gamma3))

    z_dir = gamma1.new_zeros(batch + (ndir, 2 * nd))
    g_dz = torch.cat([
        torch.cat([-gamma1, -gamma2, -gamma3], dim=-1),
        torch.cat([gamma2, gamma1, gamma3], dim=-1),
        torch.cat([z_dir, gamma0], dim=-1),
    ], dim=-2) * dz[..., None, None]

    n_k = doubling_steps(g_dz, n_double)
    f = expm_pade7(g_dz * torch.exp2(-n_k)[..., None, None])
    f11 = f[..., :nd, :nd]
    f21 = f[..., nd:2 * nd, :nd]
    x = solve(f11, f[..., :nd, nd:])
    x1, x2 = x[..., :nd], x[..., nd:]
    lay = {
        "R": -x1,
        "T": f[..., nd:2 * nd, nd:2 * nd] - matmul(f21, x1),
        "E": f[..., 2 * nd:, 2 * nd:],
        "Sup": -x2,
        "Sdn": f[..., nd:2 * nd, 2 * nd:] - matmul(f21, x2),
    }
    # n_k doubling steps per element: a step past an element's own K leaves
    # it unchanged (the masked commit of the JAX fori_loop).
    for j in range(int(n_k.max().item()) if n_k.numel() else 0):
        new = combine_layers(lay, lay)
        m = (j < n_k)[..., None, None]
        lay = {key: torch.where(m, new[key], lay[key]) for key in lay}

    # Block-Schur inverse of the unscaled Gamma (radtool_schur.F90:45-51)
    g1i = inv(gamma1 - matmul(gamma2, solve(gamma1, gamma2)))
    g2i = matmul(g1i, matmul(gamma2, inv(gamma1)))
    lay["int_diff"] = g2i - g1i
    if int_direct:
        g0i = inv(gamma0)
        lay["int_dir"] = -g0i
        lay["int_dir_diff"] = 2.0 * matmul(g1i - g2i, matmul(gamma3, g0i))
    return lay


def _chunked(fn, operands, chunk, **kw):
    """fn over a flat batch (operands [N, ...]) in chunks of `chunk`
    elements (0: all at once), which bounds the expm working set."""
    n = operands[-1].shape[0]
    step = max(1, min(chunk, n)) if chunk else n
    parts = [fn(*(x[i:i + step] for x in operands), **kw)
             for i in range(0, n, step)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def layer_matrices_chunked(gamma0, gamma1, gamma2, gamma3, dz, *, n_double,
                           chunk, int_direct=True):
    """layer_matrices over a flat batch (operands [N, n, m], dz [N]) in
    chunks of `chunk` elements."""
    return _chunked(layer_matrices, (gamma0, gamma1, gamma2, gamma3, dz),
                    chunk, n_double=n_double, int_direct=int_direct)


def lw_layer_matrices_chunked(gamma1, gamma2, emiss_rate, dz, *, n_double,
                              chunk):
    """lw_layer_matrices over a flat batch (gamma [N, nd, nd], emiss_rate
    [N, nd], dz [N]) in chunks of `chunk` elements."""
    return _chunked(lw_layer_matrices, (gamma1, gamma2, emiss_rate, dz),
                    chunk, n_double=n_double)


def lw_layer_matrices(gamma1, gamma2, emiss_rate, dz, *,
                      n_double: int = 30) -> dict:
    """Longwave operators: the emission rate b [..., nd] ("b" of Eq. 32 of
    Hogan 2019) as a unit pseudo-beam (ndir = 1, gamma0 = 0, gamma3 = b).

    Returns R, T, the source p = (Sup + Sdn) / 2 [..., nd] (equal
    analytically; the mean symmetrizes rounding), int_diff and the emission
    part of the integrated flux int_source = 2 int_diff b dz [..., nd].
    """
    gamma0 = gamma1.new_zeros(gamma1.shape[:-2] + (1, 1))
    lay = layer_matrices(gamma0, gamma1, gamma2, emiss_rate[..., None], dz,
                         n_double=n_double, int_direct=False)
    dz = torch.as_tensor(dz, dtype=gamma1.dtype, device=gamma1.device)
    return {"R": lay["R"], "T": lay["T"],
            "p": 0.5 * (lay["Sup"][..., 0] + lay["Sdn"][..., 0]),
            "int_diff": lay["int_diff"],
            "int_source": 2.0 * matvec(lay["int_diff"], emiss_rate) * dz[..., None]}
