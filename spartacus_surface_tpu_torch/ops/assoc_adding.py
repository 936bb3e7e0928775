"""Log-depth (associative-scan) adding method for deep canopies.

Port of spartacus_surface_tpu/ops/assoc_adding.py.  The sequential upward
adding recurrence (radsurf_urban_sw.F90:604-654, radsurf_urban_lw.F90:
567-614) and the downward flux recurrence (radsurf_urban_sw.F90:676-1001)
both have O(nlay) dependency depth; for very deep profiles at small batch
the layer chain becomes the critical path.  This module gives O(log nlay)
depth equivalents, selected by SolverOptions.associative_sweeps:

* The upward interface-operator build is a prefix composition under the
  Redheffer star product: each (layer + its top-interface overlap) is a
  two-sided scattering element (Rd, Td, Ru, Tu, E, Su, Sd), and composing
  vertically adjacent slabs is associative.  The sequential carry is
  recovered exactly: a_above = Rd(prefix), d_above / source_above =
  Su(prefix).
* The downward flux recurrence is affine in its carry: each layer is a
  block-lower-triangular map (dn_dir, dn_diff) -> (A dn_dir, B dn_dir +
  C dn_diff), and the suffix composition of (A, B, C) triples is again
  associative.  The LW emission constant rides in the B slot with a frozen
  width-1 "direct" channel pinned at 1.

PyTorch has no associative scan, so ``associative_scan`` writes the one
jax.lax.associative_scan uses, in plain torch over the leading (layer)
axis: a work-efficient odd-even recursion of the Blelloch kind.  Each level
combines adjacent pairs (one batched combine over every pair), recurses on
the half-length result, then combines the odd prefixes with the remaining
even elements (a second batched combine): 2 ceil(log2 L) rounds of
batched combines at most and fewer than 2 L combines in all, in the
combine order of the JAX package's route.  One star combine costs ~3 sequential adding
steps, so the route trades ~4-6x the FLOPs for L / log2(L) less depth.

Element conventions (layer axis leads: [L, C, S, ...]).  For a slab with
downwelling d_top incident on its top face, upwelling u_bot incident on its
bottom face, and direct beam e_top at its top:

    u_top = Rd d_top + Tu u_bot + Su e_top
    d_bot = Td d_top + Ru u_bot + Sd e_top
    e_bot = E  e_top

Each layer element folds in its TOP-interface region overlap (u_ov
[L, C, nreg, nreg+1] below -> above, v_ov [L, C, nreg+1, nreg] above ->
below; radsurf_overlap.F90 conventions) and the exposed-roof rows, so
adjacent elements meet in matching region bases and compose directly.
"""

from __future__ import annotations

import torch

from .matrix import matmul, matvec, solve

_KEYS = ("Rd", "Td", "Ru", "Tu", "E", "Su", "Sd")


def _interleave(even, odd):
    """[e0, o0, e1, o1, ...] along axis 0 (len(even) - len(odd) in {0, 1})."""
    n = odd.shape[0]
    pairs = torch.stack([even[:n], odd], dim=1).reshape((2 * n,) + odd.shape[1:])
    return torch.cat([pairs, even[n:]]) if even.shape[0] > n else pairs


def associative_scan(fn, elems: dict) -> dict:
    """Inclusive scan of the associative `fn` over axis 0 of a dict of
    tensors: out[i] = fn(... fn(fn(e[0], e[1]), e[2]) ..., e[i]), where
    fn(a, b) composes the earlier a with the later b and takes and returns
    dicts of tensors batched over their leading axis.  The odd-even
    recursion of jax.lax.associative_scan (see the module docstring)."""
    n = next(iter(elems.values())).shape[0]
    if n < 2:
        return elems
    take = lambda d, s: {k: v[s] for k, v in d.items()}
    odd = associative_scan(fn, fn(take(elems, slice(0, -1, 2)),
                                  take(elems, slice(1, None, 2))))
    even = fn(odd if n % 2 else take(odd, slice(None, -1)),
              take(elems, slice(2, None, 2)))
    return {k: _interleave(torch.cat([elems[k][:1], even[k]]), odd[k])
            for k in elems}


def star_combine(lo, hi):
    """Compose slab `hi` stacked on top of slab `lo` (Redheffer star).

    Both are dicts with keys Rd/Td/Ru/Tu ([..., n, n]), E ([..., p, p]) and
    Su/Sd ([..., n, p]); the direct/source channel width p is arbitrary
    (nreg for SW, 1 for LW emission).  One solve serves all three
    right-hand sides.  Associative by construction.
    """
    Rd_a, Td_a, Ru_a, Tu_a, E_a, Su_a, Sd_a = (hi[k] for k in _KEYS)
    Rd_b, Td_b, Ru_b, Tu_b, E_b, Su_b, Sd_b = (lo[k] for k in _KEYS)
    n = Rd_a.shape[-1]
    eye = torch.eye(n, dtype=Rd_a.dtype, device=Rd_a.device)
    M = eye - matmul(Ru_a, Rd_b)
    SuE = matmul(Su_b, E_a)
    s = Sd_a + matmul(Ru_a, SuE)
    sol = solve(M, torch.cat([Td_a, Ru_a, s], dim=-1))
    X = sol[..., :n]          # M^-1 Td_a
    W = sol[..., n:2 * n]     # M^-1 Ru_a
    sm = sol[..., 2 * n:]     # M^-1 s
    WTu_b = matmul(W, Tu_b)
    return {
        "Rd": Rd_a + matmul(Tu_a, matmul(Rd_b, X)),
        "Td": matmul(Td_b, X),
        "Ru": Ru_b + matmul(Td_b, WTu_b),
        "Tu": matmul(Tu_a, Tu_b + matmul(Rd_b, WTu_b)),
        "E": matmul(E_b, E_a),
        "Su": Su_a + matmul(Tu_a, SuE + matmul(Rd_b, sm)),
        "Sd": matmul(Sd_b, E_a) + matmul(Td_b, sm),
    }


def ground_star_element(a_ground, d_ground, p):
    """Absorbing lower-boundary element: reflects with a_ground, responds to
    the direct/source channel with d_ground ([..., nd, p]); transmits
    nothing (Td/Ru/Tu/E/Sd = 0)."""
    z_nn = torch.zeros_like(a_ground)
    return {"Rd": a_ground, "Td": z_nn, "Ru": z_nn, "Tu": z_nn,
            "E": a_ground.new_zeros(a_ground.shape[:-2] + (p, p)),
            "Su": d_ground, "Sd": torch.zeros_like(d_ground)}


def star_prefix(elements, ground):
    """All ground-up prefix compositions in O(log L) combine rounds.

    elements: dict of [L, ...] per-layer star elements (bottom layer
    first); ground: element without the layer axis.  Returns a dict of
    [L+1, ...]: prefix[i] = layers 0..i-1 composed over the ground — the
    sequential carry ENTERING layer i — and prefix[L] is the full
    top-of-canopy composite.
    """
    elems = {k: torch.cat([ground[k][None], elements[k]]) for k in _KEYS}
    return associative_scan(star_combine, elems)


def _compose(a, b):
    """b o a for the downward affine maps: a is applied first (nearer the
    canopy top).  Associative: compose(compose(a, b), c) = c o b o a."""
    return {"A": matmul(b["A"], a["A"]),
            "B": matmul(b["B"], a["A"]) + matmul(b["C"], a["B"]),
            "C": matmul(b["C"], a["C"])}


def affine_down_carries(A, B, C, dn_dir0, dn_diff0):
    """Per-interface carries of the downward affine recurrence, log-depth.

    The sequential sweep runs top-down (layer L-1 first) with
    dn_dir' = A_l dn_dir and dn_diff' = B_l dn_dir + C_l dn_diff.  Suffix
    composites are built by associative_scan on flipped arrays and applied
    to the top-of-canopy carry.  Returns ((dn_dir_in, dn_diff_in)
    [L, ...] carry-ins per layer, (dn_dir_fin, dn_diff_fin) at the
    ground).
    """
    flip = lambda d: {k: torch.flip(v, [0]) for k, v in d.items()}
    suffix = flip(associative_scan(_compose, flip({"A": A, "B": B, "C": C})))
    # Carry-OUT at the base of each layer = inclusive suffix applied to the
    # top carry; carry-IN = the layer above's carry-out (top layer: init).
    dn_dir_out = matvec(suffix["A"], dn_dir0)
    dn_diff_out = matvec(suffix["B"], dn_dir0) + matvec(suffix["C"], dn_diff0)
    dn_dir_in = torch.cat([dn_dir_out[1:],
                           dn_dir0.expand(dn_dir_out.shape[1:])[None]])
    dn_diff_in = torch.cat([dn_diff_out[1:],
                            dn_diff0.expand(dn_diff_out.shape[1:])[None]])
    return (dn_dir_in, dn_diff_in), (dn_dir_out[0], dn_diff_out[0])


def scalar_suffix_carries(c, init):
    """Carry-ins of a scalar multiplicative top-down recurrence.

    c: [L, C] per-layer factors (bottom layer first), init: [C].  Returns
    (carry_in [L, C], final [C]) matching a reverse sequential loop whose
    carry is multiplied by c each step.
    """
    cp = torch.flip(torch.cumprod(torch.flip(c, [0]), 0), [0])  # inclusive suffix
    out = cp * init[None]
    carry_in = torch.cat([out[1:], init.expand(out.shape[1:])[None]])
    return carry_in, out[0]


# ----------------------------------------------------------------------
# Element construction
# ----------------------------------------------------------------------

def _wrap_operators(R, T, u_ov, v_ov, a_roof, nreg, ns):
    """Fold the top-interface overlap + roof block into the layer's
    two-sided operators: Rd = (u (x) I)[blockdiag(R, a_roof)](v (x) I),
    Td = T (v_reg (x) I), Tu = (u_reg (x) I) T, Ru = R."""
    Lx, Cx, Sx = R.shape[:3]
    nd = nreg * ns
    u_reg = u_ov[..., :, :nreg]       # [L,C,q(above),r(below)]
    u_roof = u_ov[..., :, nreg]       # [L,C,q]
    v_reg = v_ov[..., :nreg, :]       # [L,C,r(below),q(above)]
    v_roof = v_ov[..., nreg, :]       # [L,C,q]
    R6 = R.reshape(Lx, Cx, Sx, nreg, ns, nreg, ns)
    T_rows = T.reshape(Lx, Cx, Sx, nreg, ns, nd)
    T_cols = T.reshape(Lx, Cx, Sx, nd, nreg, ns)
    Td = torch.einsum("lcsirn,lcrq->lcsiqn", T_cols, v_reg).reshape(
        Lx, Cx, Sx, nd, nd)
    Tu = torch.einsum("lcqr,lcsrnj->lcsqnj", u_reg, T_rows).reshape(
        Lx, Cx, Sx, nd, nd)
    Rd = (torch.einsum("lcqr,lcsrnpm,lcpw->lcsqnwm", u_reg, R6, v_reg)
          + torch.einsum("lcq,lcsnm,lcw->lcsqnwm", u_roof, a_roof, v_roof)
          ).reshape(Lx, Cx, Sx, nd, nd)
    return Rd, Td, R, Tu


def sw_layer_star_elements(R, T, E, Sup, Sdn, u_ov, v_ov, a_roof, d_roof,
                           nreg, ns):
    """SW star elements: direct channel width p = nreg in the ABOVE basis.

    The direct beam crosses the interface first (v_ov redistributes it, the
    roof row reflecting d_roof), then the layer (E transmits, Sup/Sdn
    scatter into diffuse), matching the sequential up-step's
    d' = (u (x) I)[Sup + T(I-aR)^-1(dE + a Sdn) | d_roof] v_ov exactly.
    a_roof: [L,C,S,ns,ns]; d_roof: [L,C,S,ns].
    """
    Lx, Cx, Sx = R.shape[:3]
    nd = nreg * ns
    Rd, Td, Ru, Tu = _wrap_operators(R, T, u_ov, v_ov, a_roof, nreg, ns)
    u_reg, u_roof = u_ov[..., :, :nreg], u_ov[..., :, nreg]
    v_reg, v_roof = v_ov[..., :nreg, :], v_ov[..., nreg, :]
    Sup6 = Sup.reshape(Lx, Cx, Sx, nreg, ns, nreg)
    Su = (torch.einsum("lcqr,lcsrnp,lcpw->lcsqnw", u_reg, Sup6, v_reg)
          + torch.einsum("lcq,lcsn,lcw->lcsqnw", u_roof, d_roof, v_roof)
          ).reshape(Lx, Cx, Sx, nd, nreg)
    Sd = torch.einsum("lcsip,lcpw->lcsiw", Sdn, v_reg)
    E_el = torch.einsum("lcspr,lcrw->lcspw", E, v_reg)
    return {"Rd": Rd, "Td": Td, "Ru": Ru, "Tu": Tu, "E": E_el,
            "Su": Su, "Sd": Sd}


def lw_layer_star_elements(R, T, p_src, u_ov, v_ov, a_roof, source_roof,
                           nreg, ns):
    """LW star elements: source channel width 1 (emission column), E = 1.

    p_src [L,C,S,nd] is the layer's symmetric emission (up at its top, down
    at its base); source_roof [L,C,S,ns] the exposed-roof emission row,
    matching the sequential LW up-step (radsurf_urban_lw.F90:567-614).
    """
    Lx, Cx, Sx = R.shape[:3]
    nd = nreg * ns
    Rd, Td, Ru, Tu = _wrap_operators(R, T, u_ov, v_ov, a_roof, nreg, ns)
    u_reg, u_roof = u_ov[..., :, :nreg], u_ov[..., :, nreg]
    p6 = p_src.reshape(Lx, Cx, Sx, nreg, ns)
    Su = (torch.einsum("lcqr,lcsrn->lcsqn", u_reg, p6)
          + torch.einsum("lcq,lcsn->lcsqn", u_roof, source_roof)
          ).reshape(Lx, Cx, Sx, nd, 1)
    return {"Rd": Rd, "Td": Td, "Ru": Ru, "Tu": Tu,
            "E": R.new_ones((Lx, Cx, Sx, 1, 1)), "Su": Su, "Sd": p_src[..., None]}
