"""Kernels K2 and K3: the shortwave adding up-sweep and the fused
direct + diffuse flux down-sweep, in the struct-of-arrays layout.

Replaces the TPU kernels ``sw_up_sweep`` (``_sw_up_kernel``) and
``_sw_down_call`` with modes (True, False) (``_sw_down_kernel`` /
``_sw_down_mode``) of spartacus_surface_tpu/ops/pallas_sweep.py:109, 233,
260.  CUDA source: csrc/sw_sweeps.cu.  Plain versions: ``sw_up_sweep_plain``
and ``sw_down_sweep_plain`` on the same operands.

Layout: per-layer operands [L, rows, B] as the factory writes them (B =
columns x bands, b = c*S + s); per-column overlap matrices [L, rows, C],
read by element b at column b // S.  The up-sweep writes, per layer, the
stack [a_above | d_above | inv(I - a_above R) | a_below | d_below] (rows per
``sw_stack_rows``), so the down-sweep needs matvecs only, no solves.

The TPU kernels carry the recurrence in VMEM across a sequential (tile,
layer) grid; on the H100 a loop over the layers inside the kernel takes
that grid's place.  K2 gives each element a team of TS lanes of one warp
(TS the power of two >= nd, 2 to 32), its carry and solve workspace in a
shared-memory slab (csrc/common.cuh ``up_slab``), and allocates nothing but
its outputs.  What bounds it: the latency of each layer's chain of small
products and one pivot-free solve, with few elements (14,336 at the rami5
shape) to hide it; the team splits the rows, so the card runs 16x more
lanes than elements.  Each warp copies the next layer's operands of its
elements into shared memory (cp.async) while it computes the current one
(1.5-2.6x faster than reading them from device memory, PERF.md).  Only
where a slab and its copy-ahead buffers exceed a block's shared memory (nd
above ~57 in float64) does the kernel keep its slabs in a scratch of one
slab per resident team, allocated here, and read its operands from device
memory.  ``up_config`` reports the launch shape, computed once per shape
(cuda_build.team_config).

K3 has the same teams, E of them a block on E consecutive elements,
walking the layers from the top down with the carry (both normalizations'
down fluxes) and each layer step's vectors in the team's shared-memory slab;
it runs both normalizations side by side in each step, so each layer's
operators and stack are read once, and allocates nothing but its outputs.
Its operands are read once (under one FMA a byte), so latency hidden it is
bound by bytes: while a block computes one layer, all its threads copy the
next layer's operands of its elements into shared memory, neighbouring
threads on neighbouring elements of one row (whole 32-byte sectors from 8
f32 / 4 f64 elements a block), and the output rows go out the same way.
Only where those copies exceed a block's shared memory (nd from ~40-48 on
in float64, ~56-66 in float32) does the kernel read its operands from
device memory.
``down_config`` reports its launch shape.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .matrix import matvec, solve

# the C signatures of the launchers (csrc/sw_sweeps.cu); each takes its
# launch configuration (cuda_build.team_config) before the stream
UP_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
               + [ctypes.c_longlong] + [ctypes.c_void_p] * 2)
DOWN_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
                 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2)


def sw_stack_rows(nd: int, ns: int, nreg: int) -> int:
    nd2 = (nreg + 1) * ns
    return 2 * nd * nd + nd * nreg + nd2 * nd2 + nd2 * (nreg + 1)


def sw_out_rows(with_direct, do_urban, nreg, with_profiles):
    """Names of the per-layer output rows of one down-sweep mode, in order."""
    rows = ["roof_in", "roof_net"]
    if with_direct:
        rows.append("roof_in_dir")
    rows.append("clear_air_abs")
    if nreg > 1:
        rows += ["veg_air_abs", "veg_abs"]
        if with_direct:
            rows.append("veg_abs_dir")
    if do_urban:
        if with_direct:
            rows.append("wall_in_dir")
        rows += ["wall_in", "wall_net"]
    if with_profiles:
        if with_direct:
            rows += ["flux_dn_dir_layer_top", "flux_dn_dir_layer_base"]
        rows += ["flux_dn_layer_top", "flux_up_layer_top",
                 "flux_dn_layer_base", "flux_up_layer_base"]
    return tuple(rows)


def _mats(x, l, n, m):
    """Layer l of a per-element [L, n*m, B] operand as [B, n, m]."""
    return x[l].t().reshape(-1, n, m)


def _cols(x, l, n, m, S):
    """Layer l of a per-column [L, n*m, C] operand, expanded to [B, n, m]."""
    return x[l].t().reshape(-1, n, m).repeat_interleave(S, dim=0)


def _check_sizes(kernel, B, C, nd, ns, nreg):
    if C < 1 or B % C or nd != nreg * ns or not 1 <= nreg <= 3:
        raise ValueError(f"{kernel}: needs B = C * S, nd = nreg * ns and"
                         f" 1 <= nreg <= 3 (B={B}, C={C}, nd={nd}, ns={ns},"
                         f" nreg={nreg})")


def _ground_blocks(hw, nreg, ns):
    """[nd, nd] and [nd, nreg] same-region ground masks, entry hw[to-stream]
    (radsurf_urban_sw.F90:593-602)."""
    return (torch.block_diag(*[hw[:, None].expand(ns, ns)] * nreg),
            torch.block_diag(*[hw[:, None]] * nreg))


# ----------------------------------------------------------------------
# K2: up-sweep (radsurf_urban_sw.F90:590-674)
# ----------------------------------------------------------------------

def sw_up_sweep_plain(R, T, E, Sup, Sdn, uov, vov, ralb, ralbd, grd, hw, *,
                      nd, ns, nreg):
    """Plain PyTorch version of K2; see sw_up_sweep."""
    L, _, B = R.shape
    S = B // uov.shape[-1]
    nregp, nd2 = nreg + 1, (nreg + 1) * ns
    galb, galbd, zc = grd
    blk, dblk = _ground_blocks(hw, nreg, ns)
    AA = galb[:, None, None] * blk
    DA = (zc * galbd)[:, None, None] * dblk
    eye = torch.eye(nd, dtype=R.dtype, device=R.device)
    stacks = R.new_empty((L, sw_stack_rows(nd, ns, nreg), B))
    for l in range(L):
        Rl, Tl = _mats(R, l, nd, nd), _mats(T, l, nd, nd)
        El = _mats(E, l, nreg, nreg)
        X = solve(eye - AA @ Rl, torch.cat([
            AA @ Tl, DA @ El + AA @ _mats(Sdn, l, nd, nreg),
            eye.expand(B, nd, nd)], dim=-1))
        a_below = R.new_zeros((B, nd2, nd2))
        a_below[:, :nd, :nd] = Rl + Tl @ X[..., :nd]
        a_below[:, nd:, nd:] = ralb[l][:, None, None] * hw[:, None]
        d_below = R.new_zeros((B, nd2, nregp))
        d_below[:, :nd, :nreg] = _mats(Sup, l, nd, nreg) + Tl @ X[..., nd:nd + nreg]
        d_below[:, nd:, nreg] = (zc * ralbd[l])[:, None] * hw
        stacks[l] = torch.cat([AA.reshape(B, -1), DA.reshape(B, -1),
                               X[..., nd + nreg:].reshape(B, -1),
                               a_below.reshape(B, -1), d_below.reshape(B, -1)],
                              dim=1).t()
        # overlap to just above the interface (radsurf_urban_sw.F90:646-653)
        u = _cols(uov, l, nreg, nregp, S)
        v = _cols(vov, l, nregp, nreg, S)
        AA = torch.einsum("btq,bqurv,brf->btufv", u,
                          a_below.reshape(B, nregp, ns, nregp, ns), v
                          ).reshape(B, nd, nd)
        DA = torch.einsum("btq,bqur,brf->btuf", u,
                          d_below.reshape(B, nregp, ns, nregp), v
                          ).reshape(B, nd, nreg)
    top = torch.cat([AA.reshape(B, -1), DA.reshape(B, -1)], dim=1).t().contiguous()
    return stacks, top


def sw_up_sweep(R, T, E, Sup, Sdn, uov, vov, ralb, ralbd, grd, hw, *, nd, ns,
                nreg):
    """K2: SW adding from the ground up.

    R, T [L, nd^2, B]; E [L, nreg^2, B]; Sup, Sdn [L, nd*nreg, B];
    uov [L, nreg*(nreg+1), C]; vov [L, (nreg+1)*nreg, C]; ralb, ralbd
    (roof albedos) [L, B]; grd [3, B] = [ground albedo, ground direct
    albedo, cos_sza]; hw [ns] (stream hweights).  Returns (stacks
    [L, sw_stack_rows, B], top [nd^2 + nd*nreg, B] = [a_above | d_above] at
    the canopy top).  CUDA tensors launch csrc/sw_sweeps.cu; CPU tensors take
    sw_up_sweep_plain.
    """
    L, _, B = R.shape
    C = uov.shape[-1]
    nregp = nreg + 1
    dev = cuda_build.validate("sw_up_sweep", {
        "R": (R, (L, nd * nd, B)), "T": (T, (L, nd * nd, B)),
        "E": (E, (L, nreg * nreg, B)), "Sup": (Sup, (L, nd * nreg, B)),
        "Sdn": (Sdn, (L, nd * nreg, B)), "uov": (uov, (L, nreg * nregp, C)),
        "vov": (vov, (L, nregp * nreg, C)), "ralb": (ralb, (L, B)),
        "ralbd": (ralbd, (L, B)), "grd": (grd, (3, B)), "hw": (hw, (ns,))})
    _check_sizes("sw_up_sweep", B, C, nd, ns, nreg)
    if dev.type == "cpu":
        return sw_up_sweep_plain(R, T, E, Sup, Sdn, uov, vov, ralb, ralbd,
                                 grd, hw, nd=nd, ns=ns, nreg=nreg)
    with torch.cuda.device(dev):
        return launch_up(cuda_build.load("sw_sweeps"), R, T, E, Sup, Sdn, uov,
                         vov, ralb, ralbd, grd, hw, nd=nd, ns=ns, nreg=nreg,
                         stream=cuda_build.stream(dev))


def up_config(lib, kernel, nd, ns, nreg, B, dtype) -> dict:
    """The launch configuration of K2 (kernel "sw_up_sweep") or K4
    ("lw_up_sweep") over B elements (cuda_build.team_config's fields)."""
    bits = "f32" if dtype == torch.float32 else "f64"
    return cuda_build.team_config(lib, f"{kernel}_config_{bits}",
                                  (nd, ns, nreg), B,
                                  4 if bits == "f32" else 8)


def launch_up(lib, R, T, E, Sup, Sdn, uov, vov, ralb, ralbd, grd, hw, *, nd,
              ns, nreg, stream):
    """Allocate the outputs (and, only where a slab and its copy-ahead
    buffers exceed a block's shared memory, the scratch of the global
    slabs) and launch lib's sw_up_sweep_f32/f64 as up_config says; counts the launch."""
    L, _, B = R.shape
    fn = cuda_build.bind(lib, "sw_up_sweep_f32" if R.dtype == torch.float32
                         else "sw_up_sweep_f64", UP_ARGTYPES)
    cfg = up_config(lib, "sw_up_sweep", nd, ns, nreg, B, R.dtype)
    stacks = R.new_empty((L, sw_stack_rows(nd, ns, nreg), B))
    top = R.new_empty((nd * nd + nd * nreg, B))
    ws = R.new_empty((cfg["scratch_elements"],)) if cfg["scratch_elements"] else None
    err = fn(*map(cuda_build.ptr, (R, T, E, Sup, Sdn, uov, vov, ralb, ralbd,
                                   grd, hw, stacks, top)),
             ws if ws is None else cuda_build.ptr(ws),
             nd, ns, nreg, L, B // uov.shape[-1], B,
             cuda_build.team_info(cfg), stream)
    cuda_build.check(err, "sw_up_sweep")
    sw_up_sweep.launches += 1
    return stacks, top


sw_up_sweep.launches = 0


# ----------------------------------------------------------------------
# K3: fused direct + diffuse down-sweep (radsurf_urban_sw.F90:676-1001,
# minus the clear-sky / sunlit bookkeeping, which stays in plain torch)
# ----------------------------------------------------------------------

MODES = (True, False)  # direct, then diffuse normalization


def sw_down_sweep_plain(R, T, E, Sdn, idir, idif, idd, stacks, vov, aux, zcos,
                        hw, rmu, rtan, *, nd, ns, nreg, do_urban,
                        with_profiles):
    """Plain PyTorch version of K3; see sw_down_sweep_both."""
    L, _, B = R.shape
    S = B // vov.shape[-1]
    nregp, nd2 = nreg + 1, (nreg + 1) * ns
    nod = max(nreg - 1, 1)
    s_da = nd * nd
    s_inv = s_da + nd * nreg
    s_ab = s_inv + nd * nd
    s_db = s_ab + nd2 * nd2
    names = [sw_out_rows(wd, do_urban, nreg, with_profiles) for wd in MODES]
    outs = R.new_empty((L, sum(map(len, names)), B))
    sin0 = torch.sqrt((1.0 - zcos * zcos).clamp_min(0.0))
    carry = {}
    for wd in MODES:
        ddir, ddif = R.new_zeros((B, nreg)), R.new_zeros((B, nd))
        if wd:
            ddir[:, 0] = 1.0 / zcos  # radsurf_urban_sw.F90:687-700
        else:
            ddif[:, :ns] = hw
        carry[wd] = (ddir, ddif)
    for l in range(L - 1, -1, -1):
        st = stacks[l].t()
        a_above = st[:, :s_da].reshape(B, nd, nd)
        d_above = st[:, s_da:s_inv].reshape(B, nd, nreg)
        inv_den = st[:, s_inv:s_ab].reshape(B, nd, nd)
        a_below = st[:, s_ab:s_db].reshape(B, nd2, nd2)
        d_below = st[:, s_db:].reshape(B, nd2, nregp)
        v = _cols(vov, l, nregp, nreg, S)
        Rl, Tl = _mats(R, l, nd, nd), _mats(T, l, nd, nd)
        El, Sdnl = _mats(E, l, nreg, nreg), _mats(Sdn, l, nd, nreg)
        a = aux[l].t()
        fw, od = a[:, :nreg], a[:, nreg:nreg + nod]
        ab, vb, wa = a[:, nreg + nod], a[:, nreg + nod + 1], a[:, nreg + nod + 2]
        row = 0
        for mode, wd in enumerate(MODES):
            ddir, ddif = carry[wd]
            # translate across the interface at layer top (:707-714)
            dbd = matvec(v, ddir)
            dbf = torch.einsum("bqr,brn->bqn", v, ddif.reshape(B, nreg, ns)
                               ).reshape(B, nd2)
            upb = matvec(a_below, dbf)
            if wd:
                upb = upb + matvec(d_below, dbd)
            r = {}
            roof_in = dbf[:, nd:].sum(-1)
            if wd:
                r["roof_in_dir"] = zcos * dbd[:, nreg]
                roof_in = roof_in + r["roof_in_dir"]
            r["roof_in"] = roof_in
            r["roof_net"] = roof_in - upb[:, nd:].sum(-1)
            # fluxes at layer base (:723-735)
            wrk = matvec(Tl, dbf[:, :nd])
            if wd:
                ddn = matvec(El, dbd[:, :nreg])
                ref = matvec(d_above, ddn)
                wrk = wrk + matvec(Rl, ref) + matvec(Sdnl, dbd[:, :nreg])
            dnn = matvec(inv_den, wrk)
            upa = matvec(a_above, dnn)
            if wd:
                upa = upa + ref
            # integrated fluxes (:753-761)
            ifd = matvec(_mats(idif, l, nd, nd),
                         dbf[:, :nd] - dnn - upb[:, :nd] + upa)
            if wd:
                conv_dir = dbd[:, :nreg] - ddn
                ifr = matvec(_mats(idir, l, nreg, nreg), conv_dir)
                ifd = ifd + matvec(_mats(idd, l, nd, nreg), conv_dir)
            else:
                ifr = R.new_zeros((B, nreg))
            # absorption (:763-788) and walls (:790-802)
            ifd_r = ifd.reshape(B, nreg, ns)
            ifd_mu = ifd_r @ rmu
            r["clear_air_abs"] = ab * (ifr[:, 0] + ifd_mu[:, 0])
            if nreg > 1:
                tot = ifr[:, 1:] + ifd_mu[:, 1:]
                r["veg_air_abs"] = ab * tot.sum(-1)
                r["veg_abs"] = vb * (tot * od).sum(-1)
                if wd:
                    r["veg_abs_dir"] = vb * (ifr[:, 1:] * od).sum(-1)
            if do_urban:
                wall_in = (fw * (ifd_r @ rtan)).sum(-1)
                if wd:
                    r["wall_in_dir"] = sin0 * (fw * ifr).sum(-1)
                    wall_in = wall_in + r["wall_in_dir"]
                r["wall_in"] = wall_in
                r["wall_net"] = wall_in * (1.0 - wa)
            if with_profiles:
                sdt, sdb = dbf[:, :nd].sum(-1), dnn.sum(-1)
                if wd:
                    r["flux_dn_dir_layer_top"] = zcos * dbd[:, :nreg].sum(-1)
                    r["flux_dn_dir_layer_base"] = zcos * ddn.sum(-1)
                    sdt = sdt + r["flux_dn_dir_layer_top"]
                    sdb = sdb + r["flux_dn_dir_layer_base"]
                r["flux_dn_layer_top"] = sdt
                r["flux_up_layer_top"] = upb[:, :nd].sum(-1)
                r["flux_dn_layer_base"] = sdb
                r["flux_up_layer_base"] = upa.sum(-1)
            for name in names[mode]:
                outs[l, row] = r[name]
                row += 1
            carry[wd] = (ddn if wd else ddir, dnn)
    fin = torch.cat([carry[True][0], carry[True][1], carry[False][1]], dim=1)
    return outs, fin.t().contiguous()


def sw_down_sweep_both(R, T, E, Sdn, idir, idif, idd, stacks, vov, aux, zcos,
                       hw, rmu, rtan, *, nd, ns, nreg, do_urban, with_profiles):
    """K3: SW fluxes from the canopy top down, direct and diffuse
    normalizations in one pass.

    Layer operators as the factory writes them ([L, rows, B]); stacks from
    sw_up_sweep; vov [L, (nreg+1)*nreg, C]; aux [L, 2*nreg + 2 (nreg=1: 5),
    B] = [f_wall (nreg) | od (max(nreg-1, 1)) | air abs coef | veg abs coef
    | wall albedo]; zcos [B]; hw, rmu (1/mu), rtan (tan) [ns] quadrature.
    Returns (outs [L, rows, B] with the rows of sw_out_rows(True, ...) then
    sw_out_rows(False, ...), fin [nreg + 2*nd, B] = [dn_dir | dn_diff] below
    the lowest layer for the direct mode, then dn_diff for the diffuse
    mode).  CUDA tensors launch csrc/sw_sweeps.cu; CPU tensors take
    sw_down_sweep_plain.
    """
    L, _, B = R.shape
    C = vov.shape[-1]
    nregp, nd2 = nreg + 1, (nreg + 1) * ns
    n_aux = nreg + max(nreg - 1, 1) + 3
    dev = cuda_build.validate("sw_down_sweep_both", {
        "R": (R, (L, nd * nd, B)), "T": (T, (L, nd * nd, B)),
        "E": (E, (L, nreg * nreg, B)), "Sdn": (Sdn, (L, nd * nreg, B)),
        "idir": (idir, (L, nreg * nreg, B)), "idif": (idif, (L, nd * nd, B)),
        "idd": (idd, (L, nd * nreg, B)),
        "stacks": (stacks, (L, sw_stack_rows(nd, ns, nreg), B)),
        "vov": (vov, (L, nregp * nreg, C)), "aux": (aux, (L, n_aux, B)),
        "zcos": (zcos, (B,)), "hw": (hw, (ns,)), "rmu": (rmu, (ns,)),
        "rtan": (rtan, (ns,))})
    _check_sizes("sw_down_sweep_both", B, C, nd, ns, nreg)
    kw = dict(nd=nd, ns=ns, nreg=nreg, do_urban=do_urban,
              with_profiles=with_profiles)
    if dev.type == "cpu":
        return sw_down_sweep_plain(R, T, E, Sdn, idir, idif, idd, stacks, vov,
                                   aux, zcos, hw, rmu, rtan, **kw)
    with torch.cuda.device(dev):
        return launch_down(cuda_build.load("sw_sweeps"), R, T, E, Sdn, idir,
                           idif, idd, stacks, vov, aux, zcos, hw, rmu, rtan,
                           stream=cuda_build.stream(dev), **kw)


def down_config(lib, kernel, nd, ns, nreg, do_urban, with_profiles, B, dtype) -> dict:
    """The launch configuration of K3 (kernel "sw_down_sweep") or K5
    ("lw_down_sweep") over B elements (cuda_build.team_config's fields)."""
    bits = "f32" if dtype == torch.float32 else "f64"
    return cuda_build.team_config(lib, f"{kernel}_config_{bits}",
                                  (nd, ns, nreg, int(do_urban), int(with_profiles)),
                                  B, 4 if bits == "f32" else 8)


def launch_down(lib, R, T, E, Sdn, idir, idif, idd, stacks, vov, aux, zcos, hw,
                rmu, rtan, *, nd, ns, nreg, do_urban, with_profiles, stream):
    """Allocate the outputs (nothing else) and launch lib's
    sw_down_sweep_f32/f64 as down_config says; counts the launch."""
    L, _, B = R.shape
    fn = cuda_build.bind(lib, "sw_down_sweep_f32" if R.dtype == torch.float32
                         else "sw_down_sweep_f64", DOWN_ARGTYPES)
    cfg = down_config(lib, "sw_down_sweep", nd, ns, nreg, do_urban, with_profiles, B,
                      R.dtype)
    n_out = sum(len(sw_out_rows(wd, do_urban, nreg, with_profiles))
                for wd in MODES)
    outs = R.new_empty((L, n_out, B))
    fin = R.new_empty((nreg + 2 * nd, B))
    err = fn(*map(cuda_build.ptr, (R, T, E, Sdn, idir, idif, idd, stacks, vov,
                                   aux, zcos, hw, rmu, rtan, outs, fin)),
             nd, ns, nreg, L, B // vov.shape[-1], int(do_urban),
             int(with_profiles), B, cuda_build.team_info(cfg), stream)
    cuda_build.check(err, "sw_down_sweep_both")
    sw_down_sweep_both.launches += 1
    return outs, fin


sw_down_sweep_both.launches = 0
