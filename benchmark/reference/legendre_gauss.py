"""[Frozen copy of spartacus_surface_tpu_torch/ops/legendre_gauss.py.]

Legendre-Gauss quadrature over zenith angle for the diffuse streams.

Port of spartacus_surface_tpu/ops/legendre_gauss.py (NumPy only, importable
without JAX).  Parity: radtool/radtool_legendre_gauss.F90.  Nodes and weights
on [0, 1] in ascending mu, with the derived per-stream quantities (sin_ang,
tan_ang, hweight, vweight, vadjustment, vadjustment2).
"""

from __future__ import annotations

import numpy as np

from .constants import Pi


class LegendreGauss:
    """Quadrature constants for one stream count (host-side, static)."""

    def __init__(self, nstream: int):
        if nstream < 1:
            raise ValueError("nstream must be >= 1")
        self.nstream = int(nstream)
        y, w = np.polynomial.legendre.leggauss(self.nstream)
        mu = 0.5 * (y + 1.0)
        weight = 0.5 * w
        order = np.argsort(mu)
        self.mu = mu[order]
        self.weight = weight[order]
        self.sin_ang = np.sqrt(1.0 - self.mu * self.mu)
        self.tan_ang = self.sin_ang / self.mu
        hweight = self.weight * self.mu
        vweight = self.weight * self.sin_ang
        self.hweight = hweight / hweight.sum()
        self.vweight = vweight / vweight.sum()
        self.vadjustment = 1.0
        self.vadjustment2 = (Pi / 4.0) / float((self.weight * self.sin_ang).sum())

    def __repr__(self):
        return f"LegendreGauss(nstream={self.nstream})"
