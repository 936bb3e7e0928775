"""Kernels K1 and K1d: the per-layer operator factory, in the
struct-of-arrays layout.

Replaces the TPU kernel ``pallas_layer_thin_double``
(spartacus_surface_tpu/ops/pallas_layer.py:788) in both of its branches,
chosen by the same predicate (``is_structured``, pallas_layer.py:855):
K1 is the structured branch (``_layer_kernel_structured`` +
``_extract_double`` + ``_schur_int_kernel``, :495, 350, 212), K1d the dense
one (``_layer_kernel`` :268), which every 1-stream shortwave solve and the
1-stream, 1-region longwave solve take.  Both serve the shortwave
(``layer_factory``) and the longwave emission pseudo-beam
(``lw_layer_factory``, as ``pallas_lw_layer_tiles`` :1013 calls it: ndir = 1,
gamma0 = 0, gamma3 = b, no direct-beam integrals).  CUDA source:
csrc/layer_factory.cu.  Plain versions: ``layer_factory_plain`` and
``lw_layer_factory_plain``, which run ops/layer_matrices.py on the same
operands.

Layout: every operand is [L, rows, B] (B = columns x bands, the batch
contiguous), so element (l, b) reads row r at (l*rows + r)*B + b.  The
output is exactly the sweep kernels' input.

K1 gives each (element, layer) a team of TS lanes of one warp (TS the
power of two >= nd, at most 32) and a slab of shared memory sized by the
element's live working set (csrc/layer_factory.cu ``slab_layout``: a Pade-7
expm at half size, the thin-layer extraction, the element's own K doubling
steps and the block-Schur integrals); the lanes split every matrix's rows.
One launch covers all L*B elements and allocates nothing but the outputs
(and, only where one slab exceeds a block's shared memory, nd > ~45 in
float64, a scratch of one slab per resident team).  What bounds it on the
H100: shared memory, whose slabs set how many elements an SM runs at once
(56 at the headline in float32), too few warps to hide each lane's chain
of shared-memory loads and FMAs; and the doubling counts, which differ
between the teams of a warp (the warp runs its largest).

K1d, the dense branch (pallas_layer.py:268), is built the same way: a team
of TS lanes per element (the power of two >= nd, at most 4) runs the full
N = 2 nd + ndir Pade-7 (the N x N products and the size-N solve split over
the lanes) and K1's extraction, doubling and Schur functions on a slab of
shared memory (``dense_slab_layout``: 5 N (N | 1) entries, 405 at N = 9),
in one launch over all L*B elements with no workspace.  What bounds it:
shared memory and registers per SM, which set the resident teams, and the
doubling counts that differ within a warp.  A slab above a block's shared
memory (N > ~75 in float64; the solver's N is at most 9) has no launch
configuration, and the launch raises.

``factory_config`` reports either kernel's launch shape (team size, teams
per block, shared memory, resident blocks per SM, registers), computed once
per shape and dtype (cuda_build.team_config, shared with K2-K5); the launch
takes it, so the occupancy calculator runs once per shape, not twice per
call.  ``chunk`` bounds only the plain version's steps.  Each element loops
exactly its own K doubling steps, which is the TPU kernel's masked commit
(pallas_layer.py:400) without the masking.

The order the teams take the elements in.  A block holds its slabs until
its slowest team is done, so a block that mixes a night column (its direct
beam at the clamped cosine 1e-6: ~20 doubling steps) with day columns (2-5)
keeps the day columns' slabs idle for the difference.  Every launch of K1
and K1d therefore runs the order pass first (csrc/layer_factory.cu
``factory_order_kernel``, one thread an element: each element's window of
consecutive places and its K by K1's norm, as an int32 key) and a stable
argsort of the keys, both on the card with no host sync (inside the CUDA
graph on the compiled route); the teams take the elements in that order:
window by window, each window's elements longest first, so that a block's
teams run alike counts.  A window holds the elements the card runs at once
(its resident teams, ``order_window``), so the sectors its elements share
stay in L2 while they run.  Each element reads its operands and writes its
results at its own (l, b), with its own arithmetic: the outputs are
bit-equal to any other order's.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .layer_matrices import layer_matrices_chunked, pade7_theta

OUT_NAMES = ("R", "T", "E", "Sup", "Sdn", "int_diff", "int_dir", "int_dir_diff")
LW_OUT_NAMES = ("R", "T", "p", "int_diff", "int_source")


def out_names(int_direct: bool = True) -> tuple:
    """The factory's outputs: without int_direct, no int_dir / int_dir_diff."""
    return OUT_NAMES if int_direct else OUT_NAMES[:6]


def out_rows(nd: int, ndir: int) -> dict:
    n2, nr, d2 = nd * nd, nd * ndir, ndir * ndir
    return dict(R=n2, T=n2, E=d2, Sup=nr, Sdn=nr, int_diff=n2, int_dir=d2,
                int_dir_diff=nr)


def is_structured(nd: int, ndir: int) -> bool:
    """K1 (half-size expm) needs the diffuse block to split; otherwise K1d
    (pallas_layer.py:855)."""
    return nd >= 2 * ndir and nd >= 2


def layer_factory_plain(g0, g1, g2, g3, dz, *, nd, ndir, n_double=30,
                        chunk=65536, int_direct=True):
    """Plain PyTorch version of K1 on the same [L, rows, B] operands."""
    L, _, B = g1.shape
    mat = lambda x, n, m: x.permute(0, 2, 1).reshape(L * B, n, m)
    lay = layer_matrices_chunked(
        mat(g0, ndir, ndir), mat(g1, nd, nd), mat(g2, nd, nd),
        mat(g3, nd, ndir), dz.reshape(L * B), n_double=n_double, chunk=chunk,
        int_direct=int_direct)
    return {k: lay[k].reshape(L, B, -1).permute(0, 2, 1).contiguous()
            for k in out_names(int_direct)}


def layer_factory(g0, g1, g2, g3, dz, *, nd, ndir, n_double=30, chunk=65536,
                  int_direct=True):
    """K1 / K1d: per-layer operators R, T, E, Sup, Sdn, int_diff and, with
    int_direct, int_dir and int_dir_diff, each [L, rows, B].

    g0 [L, ndir^2, B], g1/g2 [L, nd^2, B], g3 [L, nd*ndir, B], dz [L, B].
    CUDA tensors launch csrc/layer_factory.cu once over every element: K1
    where is_structured(nd, ndir), K1d otherwise.  CPU tensors take
    layer_factory_plain (`chunk` elements at a time).
    """
    L, _, B = g1.shape
    dev = cuda_build.validate("layer_factory", {
        "g0": (g0, (L, ndir * ndir, B)), "g1": (g1, (L, nd * nd, B)),
        "g2": (g2, (L, nd * nd, B)), "g3": (g3, (L, nd * ndir, B)),
        "dz": (dz, (L, B))})
    if dev.type == "cpu":
        return layer_factory_plain(g0, g1, g2, g3, dz, nd=nd, ndir=ndir,
                                   n_double=n_double, chunk=chunk,
                                   int_direct=int_direct)
    with torch.cuda.device(dev):
        return launch(cuda_build.load("layer_factory"), g0, g1, g2, g3, dz,
                      nd=nd, ndir=ndir, n_double=n_double, chunk=chunk,
                      int_direct=int_direct, stream=cuda_build.stream(dev))


# the C signatures of the launchers (csrc/layer_factory.cu): the operands
# and the order, then the launch configuration (cuda_build.team_config)
FACTORY_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                    + [ctypes.c_double] + [ctypes.c_longlong] * 2
                    + [ctypes.c_void_p] * 2)
# the order pass's (factory_order_f32/f64): the operands and the keys,
# then the elements of a window
ORDER_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_double]
                  + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])


def _kind(nd, ndir) -> str:
    """The C symbols' infix: "" for K1, "_dense" for K1d."""
    return "" if is_structured(nd, ndir) else "_dense"


def factory_config(lib, nd, ndir, n, dtype) -> dict:
    """The launch configuration of K1 (or K1d, by is_structured) for n
    elements at (nd, ndir) in dtype (cuda_build.TEAM_FIELDS and the derived
    fields of team_config; on the card, the kernel's registers and its
    resident blocks per SM from the CUDA occupancy calculator, computed once
    per (kernel, nd, ndir, dtype))."""
    bits = "f32" if dtype == torch.float32 else "f64"
    return cuda_build.team_config(lib, f"layer_factory{_kind(nd, ndir)}_config_{bits}",
                                  (nd, ndir), n, 4 if bits == "f32" else 8)


def order_window(config: dict, n: int) -> int:
    """The elements of an order window: the teams the card runs at once in
    a launch of this configuration (factory_config), at least n / 2^22 so
    that every key fits 32 bits."""
    return max(config["resident_per_sm"] * config["sms"], -(-n // 2**22))


def order_keys(lib, g0, g1, g2, g3, dz, *, nd, ndir, n_double, window, stream):
    """The order pass: [L, B] int32 sort key of each element, its window
    (flat index l*B + b over `window`) above 255 - K in the low byte, K its
    doubling count by K1's norm, theta and clamp (at most 255), from lib's
    factory_order_f32/f64, one thread an element.  Counts the launch in
    layer_factory.order_launches."""
    L, _, B = g1.shape
    bits = "f32" if g1.dtype == torch.float32 else "f64"
    keys = g1.new_empty((L, B), dtype=torch.int32)
    fn = cuda_build.bind(lib, f"factory_order_{bits}", ORDER_ARGTYPES)
    err = fn(*map(cuda_build.ptr, (g0, g1, g2, g3, dz, keys)), nd, ndir, n_double,
             pade7_theta(g1.dtype), B, L * B, window, stream)
    cuda_build.check(err, "factory_order")
    layer_factory.order_launches += 1
    return keys


def doubling_counts(keys):
    """The doubling counts in order_keys' keys."""
    return 255 - (keys & 255)


def element_order(keys):
    """The order the factory's teams take the elements in: window by
    window, each window's elements by doubling count, largest first,
    neighbours of one count kept in place (int64 flat indices l*B + b)."""
    return torch.argsort(keys.reshape(-1), stable=True)


def launch(lib, g0, g1, g2, g3, dz, *, nd, ndir, n_double, chunk, stream,
           int_direct=True):
    """K1 or K1d over every element (launch_ordered) in the order of their
    windows and doubling counts (order_keys, element_order); `chunk` is not
    used (it bounds the plain version's steps)."""
    n = g1.shape[0] * g1.shape[2]
    window = order_window(factory_config(lib, nd, ndir, n, g1.dtype), n)
    keys = order_keys(lib, g0, g1, g2, g3, dz, nd=nd, ndir=ndir, n_double=n_double,
                      window=window, stream=stream)
    return launch_ordered(lib, g0, g1, g2, g3, dz, element_order(keys), nd=nd,
                          ndir=ndir, n_double=n_double, stream=stream,
                          int_direct=int_direct)


def launch_ordered(lib, g0, g1, g2, g3, dz, order, *, nd, ndir, n_double, stream,
                   int_direct=True):
    """Allocate the outputs and launch lib's layer_factory_f32/f64 (K1) or
    layer_factory_dense_f32/f64 (K1d) once over every element, its teams
    taking them as `order` (int64, a permutation of the L*B flat indices)
    lists them, with no workspace (K1 only: a scratch where its slab
    exceeds a block's shared memory).  Counts the launch in
    layer_factory.launches (K1) or layer_factory.dense_launches (K1d) and,
    without int_direct, in the same counter of lw_layer_factory too."""
    L, _, B = g1.shape
    if (order.dtype != torch.int64 or order.shape != (L * B,) or order.device != g1.device
            or not order.is_contiguous()):
        raise ValueError(f"layer_factory: the order must be a contiguous int64 [{L * B}]"
                         f" on {g1.device}")
    kind = _kind(nd, ndir)
    bits = "f32" if g1.dtype == torch.float32 else "f64"
    fn = cuda_build.bind(lib, f"layer_factory{kind}_{bits}", FACTORY_ARGTYPES)
    rows = out_rows(nd, ndir)
    outs = {k: g1.new_empty((L, rows[k], B)) for k in out_names(int_direct)}
    cfg = factory_config(lib, nd, ndir, L * B, g1.dtype)
    scratch = (g1.new_empty((cfg["scratch_elements"],))
               if cfg["scratch_elements"] else None)
    err = fn(*map(cuda_build.ptr, (g0, g1, g2, g3, dz)),
             *(cuda_build.ptr(outs[k]) if k in outs else None for k in OUT_NAMES),
             None if scratch is None else cuda_build.ptr(scratch), cuda_build.ptr(order),
             nd, ndir, n_double, int(int_direct), pade7_theta(g1.dtype), B, L * B,
             cuda_build.team_info(cfg), stream)
    cuda_build.check(err, f"layer_factory{kind}")
    counter = "dense_launches" if kind else "launches"
    for w in (layer_factory,) + (() if int_direct else (lw_layer_factory,)):
        setattr(w, counter, getattr(w, counter) + 1)
    return outs


layer_factory.launches = 0  # K1
layer_factory.dense_launches = 0  # K1d
layer_factory.order_launches = 0  # the order pass before each of them


# ----------------------------------------------------------------------
# Longwave: the emission as a unit pseudo-beam through the same kernel
# ----------------------------------------------------------------------

def _lw_operands(g1, b):
    """gamma0 = 0 [L, 1, B] and gamma3 = b for the LW pseudo-beam."""
    L, _, B = g1.shape
    return g1.new_zeros((L, 1, B)), b


def _lw_post(lay, b, dz, nd):
    """p = (Sup + Sdn) / 2 and int_source = 2 int_diff b dz on the
    [L, rows, B] layout (lane-wise, as pallas_lw_layer_tiles does it outside
    its Pallas kernel)."""
    L, _, B = b.shape
    idiff = lay["int_diff"].reshape(L, nd, nd, B)
    return {"R": lay["R"], "T": lay["T"], "p": 0.5 * (lay["Sup"] + lay["Sdn"]),
            "int_diff": lay["int_diff"],
            "int_source": (2.0 * torch.einsum("lnkb,lkb->lnb", idiff, b)
                           * dz[:, None, :]).contiguous()}


def lw_layer_factory_plain(g1, g2, b, dz, *, nd, n_double=30, chunk=65536):
    """Plain PyTorch version of K1's LW use; see lw_layer_factory."""
    g0, g3 = _lw_operands(g1, b)
    lay = layer_factory_plain(g0, g1, g2, g3, dz, nd=nd, ndir=1,
                              n_double=n_double, chunk=chunk, int_direct=False)
    return _lw_post(lay, b, dz, nd)


def lw_layer_factory(g1, g2, b, dz, *, nd, n_double=30, chunk=65536):
    """K1 in its LW mode: R, T [L, nd^2, B], p [L, nd, B], int_diff
    [L, nd^2, B], int_source [L, nd, B] for the emission rate b [L, nd, B]
    (g1/g2 [L, nd^2, B], dz [L, B]).  K1 runs with ndir = 1, gamma0 = 0,
    gamma3 = b and int_direct off (K1d where nd = 1); CUDA tensors launch it
    (counted in the launches / dense_launches of layer_factory and of
    lw_layer_factory), CPU tensors take the plain version.  `chunk` bounds
    the elements of a plain-version step.
    """
    g0, g3 = _lw_operands(g1, b)
    lay = layer_factory(g0, g1, g2, g3, dz, nd=nd, ndir=1, n_double=n_double,
                        chunk=chunk, int_direct=False)
    return _lw_post(lay, b, dz, nd)


def launch_lw(lib, g1, g2, b, dz, *, nd, n_double, chunk, stream):
    """lw_layer_factory through lib's layer_factory_f32/f64 (see launch)."""
    g0, g3 = _lw_operands(g1, b)
    lay = launch(lib, g0, g1, g2, g3, dz, nd=nd, ndir=1, n_double=n_double,
                 chunk=chunk, stream=stream, int_direct=False)
    return _lw_post(lay, b, dz, nd)


lw_layer_factory.launches = 0
lw_layer_factory.dense_launches = 0
