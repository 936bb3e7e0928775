"""Kernel demonstration programs: the test_sw / test_lw equivalents.

Port of spartacus_surface_tpu/driver/test_kernels.py.  The reference ships
two micro test programs (driver/test_sw.F90, driver/test_lw.F90) that run
the layer-matrix factories on hardcoded Gamma matrices (1 stream per
hemisphere, 2 regions) and print the resulting R/T/E/sources for eyeball
comparison, plus the Legendre-Gauss quadrature table for n=1..8.  Here the
shortwave operators come from ``layer_factory`` (nd = ndir = 2: the dense
factory K1d on a CUDA device) and the longwave ones from
``lw_layer_factory`` (nd = 2, ndir = 1: the structured factory K1); on the
CPU both run their plain versions.  Self-check: the Schur-based
absorption-integral matrices against a brute-force inverse of the
assembled Gamma, in float64 (the check test_sw.F90:53-58 performs by
printing both).

Usage: python -m spartacus_surface_tpu_torch.driver.test_kernels
           [sw|lw|lg|all] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.layer_kernel import layer_factory, lw_layer_factory
from ..ops.legendre_gauss import LegendreGauss
from ..utils.debug import print_matrix, print_vector

DZ = 2.0
LW_EMISSION_RATE = np.array([2.0, 5.0])


def _hardcoded_gammas():
    """A 1-stream, 2-region Gamma set comparable to test_sw.F90:19-37."""
    lg = LegendreGauss(1)
    ns, nreg = 1, 2
    ext = np.array([0.05, 0.6])
    ssa = np.array([0.6, 0.4])
    f_ex = np.array([[0.0, 0.3], [0.15, 0.0]])
    mu0 = 0.6
    tan0 = np.sqrt(1 - mu0**2) / mu0
    nd = ns * nreg
    g0 = np.zeros((nreg, nreg))
    g1 = np.zeros((nd, nd))
    g2 = np.zeros((nd, nd))
    g3 = np.zeros((nd, nreg))
    for fr in range(nreg):
        for to in range(nreg):
            if fr != to:
                g0[fr, fr] -= tan0 * f_ex[to, fr]
                g0[to, fr] += tan0 * f_ex[to, fr]
                g1[fr, fr] -= lg.tan_ang[0] * f_ex[to, fr]
                g1[to, fr] += lg.tan_ang[0] * f_ex[to, fr]
    for r in range(nreg):
        g0[r, r] -= ext[r] / mu0
        g1[r, r] -= ext[r] / lg.mu[0]
        g2[r, r] = 0.5 * ext[r] * ssa[r] / lg.mu[0]
        g3[r, r] = 0.5 * ext[r] * ssa[r]
    return g0, g1 + g2, g2, g3


def _operand(x, device):
    """[n, m] (or [n]) numpy -> the factory's [L=1, n*m, B=1] float64."""
    return torch.as_tensor(np.asarray(x, np.float64).reshape(1, -1, 1),
                           device=device)


def _matrices(lay, shapes):
    """{name: [1, n*m, 1] tensor} -> {name: [n, m] numpy}."""
    return {k: lay[k][0, :, 0].cpu().numpy().reshape(shapes[k]) for k in shapes}


def sw_operators(device) -> dict:
    """The shortwave layer operators of the hardcoded Gammas, [n, m] numpy."""
    g0, g1, g2, g3 = _hardcoded_gammas()
    nd, ndir = g1.shape[0], g0.shape[0]
    lay = layer_factory(*(_operand(g, device) for g in (g0, g1, g2, g3)),
                        _operand(DZ, device).reshape(1, 1), nd=nd, ndir=ndir)
    sq, rect, dd = (nd, nd), (nd, ndir), (ndir, ndir)
    return _matrices(lay, dict(R=sq, T=sq, E=dd, Sup=rect, Sdn=rect,
                               int_diff=sq, int_dir=dd, int_dir_diff=rect))


def lw_operators(device) -> dict:
    """The longwave layer operators (emission rate LW_EMISSION_RATE)."""
    _, g1, g2, _ = _hardcoded_gammas()
    nd = g1.shape[0]
    lay = lw_layer_factory(_operand(g1, device), _operand(g2, device),
                           _operand(LW_EMISSION_RATE, device),
                           _operand(DZ, device).reshape(1, 1), nd=nd)
    return _matrices(lay, dict(R=(nd, nd), T=(nd, nd), p=(nd,),
                               int_diff=(nd, nd), int_source=(nd,)))


def demo_sw(device="cuda"):
    """Print the SW operators on `device` (cuda: the kernels, cpu: their
    plain versions) and run the Schur self-check; True if it passes."""
    g0, g1, g2, g3 = _hardcoded_gammas()
    lay = sw_operators(device)
    print("Shortwave layer operators (2-region, 1 stream/hemisphere,"
          f" dz={DZ}):")
    for key in ("R", "T", "E", "Sup", "Sdn"):
        print_matrix(key, lay[key])
    print_matrix("int_diff", lay["int_diff"])
    print_matrix("int_dir", lay["int_dir"])
    print_matrix("int_dir_diff", lay["int_dir_diff"])
    # Self-check: Schur-based Gamma inverse vs brute-force inverse of the
    # assembled full Gamma (cf. test_sw.F90:53-58); int_diff = g2i - g1i
    # with the inverse blocks of radtool_schur.F90:27-30
    nd, ndir = g1.shape[0], g0.shape[0]
    G = np.block([
        [-g1, -g2, -g3],
        [g2, g1, g3],
        [np.zeros((ndir, 2 * nd)), g0],
    ])
    Gi = np.linalg.inv(G)
    g1i_bf = Gi[nd:2 * nd, nd:2 * nd]
    g2i_bf = Gi[nd:2 * nd, :nd]
    err = np.abs(lay["int_diff"] - (g2i_bf - g1i_bf)).max()
    print(f"\nSchur vs brute-force Gamma inverse: max |diff| = {err:.3e}")
    ok = err < 1e-10
    print("SELF-CHECK", "PASSED" if ok else "FAILED")
    return ok


def demo_lw(device="cuda"):
    """Print the LW operators on `device` (cuda: the kernels, cpu: their
    plain versions)."""
    lay = lw_operators(device)
    print(f"Longwave layer operators (dz={DZ}, b={LW_EMISSION_RATE}):")
    for key in ("R", "T"):
        print_matrix(key, lay[key])
    print_vector("source p", lay["p"])
    print_matrix("int_diff", lay["int_diff"])
    print_vector("int_source", lay["int_source"])
    return True


def demo_lg():
    """Quadrature table for n=1..8 (cf. test_lw.F90:59-66)."""
    for n in range(1, 9):
        lg = LegendreGauss(n)
        print(f"n = {n}")
        print_vector("  mu     ", lg.mu)
        print_vector("  weight ", lg.weight)
        print_vector("  hweight", lg.hweight)
        print_vector("  vweight", lg.vweight)
    return True


def main(argv=None):
    p = argparse.ArgumentParser(prog="test_kernels", description=__doc__.split("\n")[0])
    p.add_argument("which", nargs="?", default="all", choices=("sw", "lw", "lg", "all"))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the default; fails without CUDA) launches the"
                        " factory kernels, cpu runs their plain versions")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("*** Error: --device cuda but torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    device = torch.device(args.device)
    ok = True
    if args.which in ("sw", "all"):
        ok &= demo_sw(device)
    if args.which in ("lw", "all"):
        print()
        ok &= demo_lw(device)
    if args.which in ("lg", "all"):
        print()
        ok &= demo_lg()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
