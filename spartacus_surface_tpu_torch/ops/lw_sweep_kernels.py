"""Kernels K4 and K5: the longwave adding up-sweep with emission sources and
the fused longwave flux down-sweep, in the struct-of-arrays layout.

Replaces the TPU kernels ``lw_up_sweep`` (``_lw_up_kernel``) and
``_lw_down_call`` with modes (internal, incoming) (``_lw_down_kernel`` /
``_lw_down_mode``) of spartacus_surface_tpu/ops/pallas_sweep.py:430, 533,
552.  CUDA source: csrc/lw_sweeps.cu.  Plain versions: ``lw_up_sweep_plain``
and ``lw_down_sweep_plain`` on the same operands.

Layout as for K2/K3 (ops/sweep_kernels.py): per-layer operands [L, rows, B]
(B = columns x bands, b = c*S + s), per-column overlap matrices [L, rows, C].
The up-sweep writes, per layer, the stack [a_above | source_above |
inv(I - a_above R) | a_below | source_below] (rows per ``lw_stack_rows``),
so the down-sweep needs matvecs only.  K4 has K2's design on the H100 (see
ops/sweep_kernels.py): a team of TS lanes per element, its carry and solve
workspace in a shared-memory slab, the next layer's operands copied ahead
(read from device memory only where the slabs must be global); what bounds it
is the latency of each layer's chain of small products and one solve with
2 nd + 1 right-hand sides.  K5 has K3's design (ops/sweep_kernels.py):
teams of lanes walking the layers from the top down, the carry in shared
memory, both source modes side by side in each layer step, the next
layer's operands copied ahead block-wide in whole sectors, nothing
allocated but its outputs.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .matrix import matvec, solve
from .sweep_kernels import (_check_sizes, _cols, _ground_blocks, _mats, down_config,
                            up_config)

# the C signatures of the launchers (csrc/lw_sweeps.cu); each takes its
# launch configuration (cuda_build.team_config) before the stream
UP_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
               + [ctypes.c_longlong] + [ctypes.c_void_p] * 2)
DOWN_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2)


def lw_stack_rows(nd: int, ns: int, nreg: int) -> int:
    nd2 = (nreg + 1) * ns
    return 2 * nd * nd + nd + nd2 * nd2 + nd2


def lw_out_rows(do_urban, nreg, with_profiles):
    """Names of the per-layer output rows of one down-sweep mode, in order."""
    rows = ["roof_in", "roof_net", "clear_air_abs"]
    if nreg > 1:
        rows += ["veg_air_abs", "veg_abs"]
    if do_urban:
        rows += ["wall_in", "wall_net"]
    if with_profiles:
        rows += ["flux_dn_layer_top", "flux_up_layer_top",
                 "flux_dn_layer_base", "flux_up_layer_base"]
    return tuple(rows)


# ----------------------------------------------------------------------
# K4: up-sweep (radsurf_urban_lw.F90:551-637)
# ----------------------------------------------------------------------

def lw_up_sweep_plain(R, T, p, uov, vov, reps, remit, exposed, grd, hw, *,
                      nd, ns, nreg):
    """Plain PyTorch version of K4; see lw_up_sweep."""
    L, _, B = R.shape
    S = B // uov.shape[-1]
    nregp, nd2 = nreg + 1, (nreg + 1) * ns
    geps, gemit = grd[0], grd[1]
    blk, _ = _ground_blocks(hw, nreg, ns)
    AA = (1.0 - geps)[:, None, None] * blk
    SRC = gemit[:, None] * (grd[2:].t()[:, :, None] * hw).reshape(B, nd)
    eye = torch.eye(nd, dtype=R.dtype, device=R.device)
    stacks = R.new_empty((L, lw_stack_rows(nd, ns, nreg), B))
    for l in range(L):
        Rl, Tl, pl = _mats(R, l, nd, nd), _mats(T, l, nd, nd), p[l].t()
        X = solve(eye - AA @ Rl, torch.cat([
            AA @ Tl, (SRC + matvec(AA, pl))[..., None],
            eye.expand(B, nd, nd)], dim=-1))
        a_below = R.new_zeros((B, nd2, nd2))
        a_below[:, :nd, :nd] = Rl + Tl @ X[..., :nd]
        a_below[:, nd:, nd:] = (1.0 - reps[l])[:, None, None] * hw[:, None]
        s_below = torch.cat([pl + matvec(Tl, X[..., nd]),
                             (remit[l] * exposed[l])[:, None] * hw], dim=1)
        stacks[l] = torch.cat([AA.reshape(B, -1), SRC, X[..., nd + 1:].reshape(B, -1),
                               a_below.reshape(B, -1), s_below], dim=1).t()
        # overlap to just above the interface (radsurf_urban_lw.F90:620-627)
        u = _cols(uov, l, nreg, nregp, S)
        v = _cols(vov, l, nregp, nreg, S)
        AA = torch.einsum("btq,bqurv,brf->btufv", u,
                          a_below.reshape(B, nregp, ns, nregp, ns), v
                          ).reshape(B, nd, nd)
        SRC = torch.einsum("btq,bqu->btu", u, s_below.reshape(B, nregp, ns)
                           ).reshape(B, nd)
    top = torch.cat([AA.reshape(B, -1), SRC], dim=1).t().contiguous()
    return stacks, top


def lw_up_sweep(R, T, p, uov, vov, reps, remit, exposed, grd, hw, *, nd, ns,
                nreg):
    """K4: LW adding from the ground up, with emission sources.

    R, T [L, nd^2, B]; p (layer emission source) [L, nd, B]; uov
    [L, nreg*(nreg+1), C]; vov [L, (nreg+1)*nreg, C]; reps, remit (roof
    emissivity and emission) and exposed (exposed-roof fraction, the same
    for every band of a column) [L, B]; grd [2 + nreg, B] = [ground
    emissivity, ground emission, frac0 (lowest-layer region fractions)]; hw
    [ns].  Returns (stacks [L, lw_stack_rows, B], top [nd^2 + nd, B] =
    [a_above | source_above] at the canopy top).  CUDA tensors launch
    csrc/lw_sweeps.cu; CPU tensors take lw_up_sweep_plain.
    """
    L, _, B = R.shape
    C = uov.shape[-1]
    nregp = nreg + 1
    dev = cuda_build.validate("lw_up_sweep", {
        "R": (R, (L, nd * nd, B)), "T": (T, (L, nd * nd, B)),
        "p": (p, (L, nd, B)), "uov": (uov, (L, nreg * nregp, C)),
        "vov": (vov, (L, nregp * nreg, C)), "reps": (reps, (L, B)),
        "remit": (remit, (L, B)), "exposed": (exposed, (L, B)),
        "grd": (grd, (2 + nreg, B)), "hw": (hw, (ns,))})
    _check_sizes("lw_up_sweep", B, C, nd, ns, nreg)
    if dev.type == "cpu":
        return lw_up_sweep_plain(R, T, p, uov, vov, reps, remit, exposed, grd,
                                 hw, nd=nd, ns=ns, nreg=nreg)
    with torch.cuda.device(dev):
        return launch_up(cuda_build.load("lw_sweeps"), R, T, p, uov, vov, reps,
                         remit, exposed, grd, hw, nd=nd, ns=ns, nreg=nreg,
                         stream=cuda_build.stream(dev))


def launch_up(lib, R, T, p, uov, vov, reps, remit, exposed, grd, hw, *, nd,
              ns, nreg, stream):
    """Allocate the outputs (and, only where a slab and its copy-ahead
    buffers exceed a block's shared memory, the scratch of the global
    slabs) and launch lib's lw_up_sweep_f32/f64 as up_config says; counts the launch."""
    L, _, B = R.shape
    fn = cuda_build.bind(lib, "lw_up_sweep_f32" if R.dtype == torch.float32
                         else "lw_up_sweep_f64", UP_ARGTYPES)
    cfg = up_config(lib, "lw_up_sweep", nd, ns, nreg, B, R.dtype)
    stacks = R.new_empty((L, lw_stack_rows(nd, ns, nreg), B))
    top = R.new_empty((nd * nd + nd, B))
    ws = R.new_empty((cfg["scratch_elements"],)) if cfg["scratch_elements"] else None
    err = fn(*map(cuda_build.ptr, (R, T, p, uov, vov, reps, remit, exposed,
                                   grd, hw, stacks, top)),
             ws if ws is None else cuda_build.ptr(ws),
             nd, ns, nreg, L, B // uov.shape[-1], B,
             cuda_build.team_info(cfg), stream)
    cuda_build.check(err, "lw_up_sweep")
    lw_up_sweep.launches += 1
    return stacks, top


lw_up_sweep.launches = 0


# ----------------------------------------------------------------------
# K5: fused internal-emission + incoming down-sweep
# (radsurf_urban_lw.F90:639-805)
# ----------------------------------------------------------------------

MODES = (True, False)  # internal emission (with sources), then incoming


def lw_down_sweep_plain(R, T, p, idif, isrc, stacks, vov, aux, hw, rmu, rtan,
                        *, nd, ns, nreg, do_urban, with_profiles):
    """Plain PyTorch version of K5; see lw_down_sweep_both."""
    L, _, B = R.shape
    S = B // vov.shape[-1]
    nregp, nd2 = nreg + 1, (nreg + 1) * ns
    nod = max(nreg - 1, 1)
    s_sa = nd * nd
    s_inv = s_sa + nd
    s_ab = s_inv + nd * nd
    s_sb = s_ab + nd2 * nd2
    names = lw_out_rows(do_urban, nreg, with_profiles)
    outs = R.new_empty((L, 2 * len(names), B))
    dn = {True: R.new_zeros((B, nd)), False: R.new_zeros((B, nd))}
    dn[False][:, :ns] = hw  # radsurf_urban_lw.F90:639-651
    for l in range(L - 1, -1, -1):
        st = stacks[l].t()
        a_above = st[:, :s_sa].reshape(B, nd, nd)
        s_above = st[:, s_sa:s_inv]
        inv_den = st[:, s_inv:s_ab].reshape(B, nd, nd)
        a_below = st[:, s_ab:s_sb].reshape(B, nd2, nd2)
        s_below = st[:, s_sb:]
        v = _cols(vov, l, nregp, nreg, S)
        Rl, Tl, pl = _mats(R, l, nd, nd), _mats(T, l, nd, nd), p[l].t()
        a = aux[l].t()
        fw, od = a[:, :nreg], a[:, nreg:nreg + nod]
        ab, vb, weps, sub_air, sub_vegair, sub_veg, sub_wall = a[:, nreg + nod:].t()
        row = 0
        for src in MODES:
            # translate across the interface at layer top (:656-660)
            dbf = torch.einsum("bqr,brn->bqn", v, dn[src].reshape(B, nreg, ns)
                               ).reshape(B, nd2)
            upb = matvec(a_below, dbf)
            if src:
                upb = upb + s_below
            r = {"roof_in": dbf[:, nd:].sum(-1)}
            r["roof_net"] = r["roof_in"] - upb[:, nd:].sum(-1)
            # fluxes at layer base (:676-690)
            wrk = matvec(Tl, dbf[:, :nd])
            if src:
                wrk = wrk + matvec(Rl, s_above) + pl
            dnn = matvec(inv_den, wrk)
            upa = matvec(a_above, dnn)
            if src:
                upa = upa + s_above
            # integrated fluxes (:706-712)
            ifl = matvec(_mats(idif, l, nd, nd), dbf[:, :nd] - dnn - upb[:, :nd] + upa)
            if src:
                ifl = ifl + isrc[l].t()
            ifl = ifl.reshape(B, nreg, ns)
            if_mu, if_tan = ifl @ rmu, ifl @ rtan
            # absorption minus emission (:714-757) and walls (:759-771)
            r["clear_air_abs"] = ab * if_mu[:, 0] - (sub_air if src else 0.0)
            if nreg > 1:
                r["veg_air_abs"] = ab * if_mu[:, 1:].sum(-1) - (sub_vegair if src else 0.0)
                r["veg_abs"] = vb * (if_mu[:, 1:] * od).sum(-1) - (sub_veg if src else 0.0)
            if do_urban:
                r["wall_in"] = (fw * if_tan).sum(-1)
                r["wall_net"] = r["wall_in"] * weps - (sub_wall if src else 0.0)
            if with_profiles:
                r["flux_dn_layer_top"] = dbf[:, :nd].sum(-1)
                r["flux_up_layer_top"] = upb[:, :nd].sum(-1)
                r["flux_dn_layer_base"] = dnn.sum(-1)
                r["flux_up_layer_base"] = upa.sum(-1)
            for name in names:
                outs[l, row] = r[name]
                row += 1
            dn[src] = dnn
    return outs, torch.cat([dn[True], dn[False]], dim=1).t().contiguous()


def lw_down_sweep_both(R, T, p, idif, isrc, stacks, vov, aux, hw, rmu, rtan, *,
                       nd, ns, nreg, do_urban, with_profiles):
    """K5: LW fluxes from the canopy top down, the internal-emission and the
    unit-incoming modes in one pass.

    Layer operators as the LW factory writes them (R, T, idif [L, nd^2, B];
    p, isrc [L, nd, B]); stacks from lw_up_sweep; vov [L, (nreg+1)*nreg, C];
    aux [L, nreg + max(nreg-1, 1) + 7, B] = [f_wall (nreg) | od | air abs
    coef | veg abs coef | wall emissivity | air, veg-air, veg and wall
    emission per layer]; hw, rmu (1/mu), rtan (tan) [ns] quadrature.
    Returns (outs [L, 2 * len(lw_out_rows), B], the rows of lw_out_rows for
    the internal mode then for the incoming mode; fin [2*nd, B], the
    downwelling below the lowest layer of each mode).  CUDA tensors launch
    csrc/lw_sweeps.cu; CPU tensors take lw_down_sweep_plain.
    """
    L, _, B = R.shape
    C = vov.shape[-1]
    nregp = nreg + 1
    n_aux = nreg + max(nreg - 1, 1) + 7
    dev = cuda_build.validate("lw_down_sweep_both", {
        "R": (R, (L, nd * nd, B)), "T": (T, (L, nd * nd, B)),
        "p": (p, (L, nd, B)), "idif": (idif, (L, nd * nd, B)),
        "isrc": (isrc, (L, nd, B)),
        "stacks": (stacks, (L, lw_stack_rows(nd, ns, nreg), B)),
        "vov": (vov, (L, nregp * nreg, C)), "aux": (aux, (L, n_aux, B)),
        "hw": (hw, (ns,)), "rmu": (rmu, (ns,)), "rtan": (rtan, (ns,))})
    _check_sizes("lw_down_sweep_both", B, C, nd, ns, nreg)
    kw = dict(nd=nd, ns=ns, nreg=nreg, do_urban=do_urban,
              with_profiles=with_profiles)
    if dev.type == "cpu":
        return lw_down_sweep_plain(R, T, p, idif, isrc, stacks, vov, aux, hw,
                                   rmu, rtan, **kw)
    with torch.cuda.device(dev):
        return launch_down(cuda_build.load("lw_sweeps"), R, T, p, idif, isrc,
                           stacks, vov, aux, hw, rmu, rtan,
                           stream=cuda_build.stream(dev), **kw)


def launch_down(lib, R, T, p, idif, isrc, stacks, vov, aux, hw, rmu, rtan, *,
                nd, ns, nreg, do_urban, with_profiles, stream):
    """Allocate the outputs (nothing else) and launch lib's
    lw_down_sweep_f32/f64 as down_config says; counts the launch."""
    L, _, B = R.shape
    fn = cuda_build.bind(lib, "lw_down_sweep_f32" if R.dtype == torch.float32
                         else "lw_down_sweep_f64", DOWN_ARGTYPES)
    cfg = down_config(lib, "lw_down_sweep", nd, ns, nreg, do_urban, with_profiles, B,
                      R.dtype)
    outs = R.new_empty((L, 2 * len(lw_out_rows(do_urban, nreg, with_profiles)), B))
    fin = R.new_empty((2 * nd, B))
    err = fn(*map(cuda_build.ptr, (R, T, p, idif, isrc, stacks, vov, aux, hw,
                                   rmu, rtan, outs, fin)),
             nd, ns, nreg, L, B // vov.shape[-1], int(do_urban),
             int(with_profiles), B, cuda_build.team_info(cfg), stream)
    cuda_build.check(err, "lw_down_sweep_both")
    lw_down_sweep_both.launches += 1
    return outs, fin


lw_down_sweep_both.launches = 0
