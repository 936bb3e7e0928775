"""The algorithm's work: operations and bytes of each stage of a layered
solve, counted from the reference formulation (benchmark/reference) at
textbook rates, whatever implements it.

Rates: a product of [n, k] and [k, m] matrices is 2 n k m operations; a
solve of an n x n system with m right-hand sides is an LU factorization
(2/3 n^3) and its substitutions (2 n^2 m); an inverse is a solve with
the identity.  Each call of the reference's formulation is counted where
it stands: a solve that factors a matrix the step factored before counts
its factorization again.  Elementwise work is left out.  The layer
factory runs each element's own doubling steps K, which the reference
decides from ||Gamma dz|| (reference.layer_matrices.doubling_steps); the
count takes their sum over the elements, not the most any could need.
Bytes: each input of a stage read once and each output written once, in
words of the working precision.

Stages (``STAGES``): ``factory_sw`` and ``factory_lw`` (the per-layer
operators from the Gamma matrices: K1 / K1d), ``sweeps_sw`` (the adding
up-sweep and the direct and diffuse flux down-sweeps: K2 + K3) and
``sweeps_lw`` (K4 + K5).  ``Dims`` holds what a count needs of a group's
solve: nreg, streams, columns, layers, bands, urban or not, and the
word size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .reference import dispatch as RD
from .reference import solver as RS
from .reference.layer_matrices import doubling_steps
from .reference.legendre_gauss import LegendreGauss


def mm(n, k, m):
    """Operations of an [n, k] @ [k, m] product."""
    return 2 * n * k * m


def solve(n, m):
    """Operations of an n x n solve with m right-hand sides."""
    return 2 * n**3 / 3 + 2 * n * n * m


@dataclass(frozen=True)
class Dims:
    nreg: int
    nstream: int
    columns: int
    layers: int
    bands: int
    do_urban: bool
    itemsize: int

    @property
    def nd(self):
        return self.nreg * self.nstream

    @property
    def elements(self):
        """Factory elements: columns x layers x bands."""
        return self.columns * self.layers * self.bands


def factory_element_ops(nd: int, ndir: int, int_direct: bool) -> float:
    """Operations of one element's factory without its doubling steps:
    the Pade-7 exponential of the (2 nd + ndir) Gamma dz, the thin-layer
    extraction and the block-Schur integrals (reference
    layer_matrices.layer_matrices)."""
    n = 2 * nd + ndir
    expm = 4 * mm(n, n, n) + solve(n, n)
    extract = solve(nd, nd + ndir) + mm(nd, nd, nd) + mm(nd, nd, ndir)
    schur = (solve(nd, nd) + mm(nd, nd, nd) + 2 * solve(nd, nd)
             + 2 * mm(nd, nd, nd))
    if int_direct:
        schur += solve(ndir, ndir) + mm(nd, ndir, ndir) + mm(nd, nd, ndir)
    return expm + extract + schur


def doubling_step_ops(nd: int, ndir: int) -> float:
    """Operations of one adding-doubling step (reference combine_layers)."""
    return (2 * mm(nd, ndir, ndir) + 4 * mm(nd, nd, ndir) + 4 * mm(nd, nd, nd)
            + solve(nd, nd + ndir) + mm(ndir, ndir, ndir))


def factory(d: Dims, lw: bool, doublings: int):
    """(operations, bytes) of a group's factory (SW, or LW with the
    emission as a unit pseudo-beam); doublings: the sum of the elements'
    doubling steps."""
    nd, E = d.nd, d.elements
    ndir = 1 if lw else d.nreg
    ops = E * factory_element_ops(nd, ndir, not lw) + doublings * doubling_step_ops(nd, ndir)
    if lw:
        ops += E * mm(nd, nd, 1)  # int_source
        words_in = 2 * nd * nd + nd + 1  # gamma1, gamma2, b, dz
        words_out = 3 * nd * nd + 2 * nd  # R, T, int_diff, p, int_source
    else:
        words_in = ndir * ndir + 2 * nd * nd + nd * ndir + 1
        words_out = 3 * nd * nd + 2 * ndir * ndir + 3 * nd * ndir
    return ops, E * (words_in + words_out) * d.itemsize


def _overlap_mat(nreg, ns):
    """(u (x) I) A (v (x) I) of an [nd2, nd2] A, contracted region by
    region (the reference's einsum)."""
    return 2 * nreg * (nreg + 1) * ns * ns * (2 * nreg + 1)


def sweeps(d: Dims, lw: bool):
    """(operations, bytes) of a group's up-sweep and its two down-sweeps
    (SW: direct and diffuse; LW: with and without the emission)."""
    nreg, ns, nd = d.nreg, d.nstream, d.nd
    nd2 = nd + ns  # with the exposed-roof streams
    veg, wall = 2 * (nreg > 1), 2 * d.do_urban  # a down-sweep's optional outputs
    if lw:
        up = (3 * mm(nd, nd, nd) + solve(nd, nd) + 2 * mm(nd, nd, 1) + solve(nd, 1)
              + _overlap_mat(nreg, ns) + 2 * nreg * (nreg + 1) * ns)
        down_one = (2 * (nreg + 1) * nreg * ns + mm(nd2, nd2, 1) + 3 * mm(nd, nd, 1)
                    + solve(nd, 1))
        down = 2 * down_one + mm(nd, nd, 1)  # R source_above with the emission
        words_in = 3 * nd * nd + 2 * nd + 6  # R, T, int_diff, p, int_source, facets
        layer_out, column_out = 2 * (3 + veg + wall), 12
    else:
        up = (3 * mm(nd, nd, nd) + solve(nd, nd) + mm(nd, nreg, nreg)
              + 2 * mm(nd, nd, nreg) + solve(nd, nreg) + _overlap_mat(nreg, ns)
              + 2 * nreg * (nreg + 1) * ns * (2 * nreg + 1))
        diffuse = (2 * (nreg + 1) * nreg * ns + mm(nd2, nd2, 1) + 2 * mm(nd, nd, 1)
                   + solve(nd, 1) + mm(nd, nd, 1))
        direct = (diffuse + 2 * (nreg + 1) * nreg + mm(nd2, nreg + 1, 1)
                  + mm(nreg, nreg, 1) + 3 * mm(nd, nreg, 1) + mm(nd, nd, 1)
                  + mm(nreg, nreg, 1))
        down = diffuse + direct
        words_in = 3 * nd * nd + 2 * nreg * nreg + 3 * nd * nreg + 5
        # direct: roof in, in_dir, net, clear air, (veg air, veg, veg_dir),
        # (wall in, in_dir, net); diffuse: the same less the _dir fields
        layer_out = (4 + 3 * (nreg > 1) + 3 * d.do_urban) + (3 + veg + wall)
        column_out = 15
    E = d.elements
    # per column and layer, not per band: the overlap matrices in; the
    # sunlit fractions out (SW)
    words_cl = 4 * nreg * (nreg + 1) + (0 if lw else 1 + (nreg > 1) + d.do_urban)
    nbytes = (E * (words_in + layer_out) + d.columns * d.bands * column_out
              + d.columns * d.layers * words_cl) * d.itemsize
    return E * (up + down), nbytes


STAGES = ("factory_sw", "factory_lw", "sweeps_sw", "sweeps_lw")


def bound_seconds(ops: float, nbytes: float, flops: float, bandwidth: float) -> float:
    """The least time a chip of the given peaks takes: the larger of
    operations over the FMA peak and bytes over the memory bandwidth."""
    return max(ops / flops, nbytes / bandwidth)


BLOCK_ELEMENTS = 65536  # layer-bands of the front end worked out at once


def _gamma_dz(g0, g1, g2, g3, dz):
    """The reference factory's [[-g1, -g2, -g3], [g2, g1, g3], [0, g0]] dz."""
    z = g1.new_zeros(g1.shape[:-2] + (g0.shape[-1], 2 * g1.shape[-1]))
    return torch.cat([torch.cat([-g1, -g2, -g3], -1), torch.cat([g2, g1, g3], -1),
                      torch.cat([z, g0], -1)], -2) * dz[..., None, None]


def call_work(radsurf: dict, arrays: dict, dtype, device, block: int | None = None) -> dict:
    """{stage: (operations, bytes)} of one run_radsurf call on `arrays` in
    `dtype`, over its layered tile groups.  The doubling steps are the
    reference's for these inputs in this dtype (the Gamma matrices of its
    front end, ``block`` columns at a time; by default as many as hold
    BLOCK_ELEMENTS layer-bands)."""
    s = RD.settings(radsurf)
    rep = np.asarray(arrays["i_representation"])
    L = np.asarray(arrays["dz"]).shape[1]
    itemsize = torch.finfo(dtype).bits // 8
    total = {k: (0.0, 0.0) for k in STAGES}
    add = lambda k, w: total.__setitem__(k, tuple(a + b for a, b in zip(total[k], w)))
    for code, (opt_kw, ns_sw, ns_lw) in RD.solver_groups(radsurf).items():
        idx = np.nonzero(rep == code)[0]
        if not idx.size:
            continue
        for lw, ns, S, on in ((False, ns_sw, s["nsw"], s["do_sw"]),
                              (True, ns_lw, s["nlw"], s["do_lw"])):
            if not on:
                continue
            opt = RS.SolverOptions(nstream=ns, **opt_kw)
            lg = LegendreGauss(ns)
            keys = RD.LW_KEYS if lw else {**RD.SW_KEYS, "ground_albedo_dir": "ground_albedo"}
            steps, b = 0, block or max(1, BLOCK_ELEMENTS // (L * S))
            for i in range(0, idx.size, b):
                cols = idx[i:i + b]
                inp = RS._coerce_dtype(RS._sanitize_forest(RS.CanopyInputs(**{
                    f: torch.as_tensor(np.asarray(arrays[k])[cols], dtype=dtype, device=device)
                    for f, k in keys.items()}), opt))
                Cb = cols.size
                dz = inp.dz[:, :, None].expand(Cb, L, S)
                if lw:
                    _, _, (g1, g2), em = RS._lw_front(inp, opt, lg)
                    g0 = g1.new_zeros(g1.shape[:-2] + (1, 1))
                    g3 = em["emiss_rate"][..., None]
                else:
                    g0, g1, g2, g3 = RS._sw_front(inp, opt, lg)[-1]
                steps += int(doubling_steps(_gamma_dz(g0, g1, g2, g3, dz), opt.n_double)
                             .sum().item())
            d = Dims(opt.nreg, ns, idx.size, L, S, opt.do_urban, itemsize)
            band = "lw" if lw else "sw"
            add(f"factory_{band}", factory(d, lw, steps))
            add(f"sweeps_{band}", sweeps(d, lw))
    return total
