"""How much device memory a solve holds, and how much the device can give.

What sizes the automatic chunks of the port (``column_chunk = -1`` in
models/solver.py, the CLI's ``--stream-chunk`` default in driver/main.py):

* ``solve_words`` / ``solve_bytes``: the working-set model of one solve
  (models/dispatch.py _working_set builds a run_radsurf call's from
  it).  The peak device memory of the kernel route, counted from the
  tensors it holds at its peak, which is the down-sweep (K3 for SW, K5 for
  LW) and the epilogue after it: the front end's Gamma matrices, the layer
  factory's outputs and the up-sweep's stacks, all [L, rows, B] (B =
  columns x bands), the down-sweep's output rows, and the solve's outputs.
  Counts are in words (one float of the working dtype) per element of a
  class: ``E`` per column, layer and band, ``CL`` per column and layer,
  ``CS`` per column and band, ``C`` per column.  On an NVIDIA H100 80GB
  HBM3 (700 W) the measured peak of a one-shot run_radsurf call was 0.97-
  1.01 of the model's (chip_smoke.py, `auto` phase).
* ``device_budget``: the bytes a device can still give, its free memory
  plus what PyTorch's caching allocator holds unallocated (and what the
  CUDA graphs hold, which they give back when it is needed), times
  ``BUDGET_SHARE``, less ``BUDGET_RESERVE``.  Off CUDA the budget is
  unbounded.

No threshold here was taken from a TPU: the model counts the port's own
tensors, and the budget reads the card.
"""

from __future__ import annotations

import math

import torch

from ..ops.layer_kernel import out_rows
from ..ops.lw_sweep_kernels import lw_out_rows, lw_stack_rows
from ..ops.sweep_kernels import sw_out_rows, sw_stack_rows
from . import graphs

# The share of a device's free memory that an automatic chunk may plan to
# fill, and a fixed reserve off it.  They cover what the model does not
# count: the caching allocator's rounding and fragmentation (it reserves
# more than it allocates, by up to a few of the largest blocks: ~80 MiB
# each at a 2,176-column float64 chunk), cuBLAS workspaces of new streams,
# lazily loaded kernels, and the small per-column tensors of the
# non-layered tiles.  A budget of a few hundred MiB with the share alone
# ran out of device memory on an NVIDIA H100 80GB HBM3 (chip_smoke.py,
# `auto` phase, squeeze).
BUDGET_SHARE = 0.85
BUDGET_RESERVE = 2**30

# A call on CUDA is captured as a CUDA graph at its second call
# (utils/graphs.py), and a capture cannot give the allocator's blocks back
# to the device: a tensor larger than every block freed so far takes new
# memory, so the graph's pool holds more than an eager call's peak.  An
# automatic chunk on CUDA plans for this multiple of a solve's transient
# bytes.  chip_smoke.py's `auto` phase (capture_footprint) measures the
# pool of a captured one-shot call against its eager peak and holds the
# ratio to it.
CAPTURE_FACTOR = 1.6


# Words of one dense flux container of run_radsurf (dispatch._empty_flux)
# with its two top-of-canopy columns (bc_out)
CONTAINER_WORDS = {"E": 16, "CL": 3, "CS": 8, "C": 1}


# The front end's smaller tensors that stay live through the down-sweep,
# counted on the CPU with every kernel emulated by its outputs: per layer
# and band the facet and absorption coefficients (and, LW, the emission
# rates by region); per column and layer the geometry (region fractions,
# overlap matrices, perimeters, exchange and wall rates) and the clear-sky
# quantities.  Rounded up a little: the model may over-predict, not under.
_FRONT_E = {False: 14, True: 14}


def _front_cl(nreg: int) -> int:
    return 4 * nreg * (nreg + 1) + nreg * nreg + 4 * nreg + 12


def solve_words(nreg: int, nstream: int, *, lw: bool, do_urban: bool = True,
                with_profiles: bool = False) -> tuple:
    """(transient, kept): the words one spartacus_sw (lw=False) or
    spartacus_lw call holds on the kernel route beyond its inputs, at its
    peak and after it returns, as {class: words per element}."""
    nd = nreg * nstream
    if not lw:
        gamma = 2 * nd * nd + nd * nreg + nreg * nreg  # Gamma1, 2, 3, 0
        factory = sum(out_rows(nd, nreg).values())  # K1's eight outputs
        stacks = sw_stack_rows(nd, nstream, nreg)  # K2
        rows = sum(len(sw_out_rows(wd, do_urban, nreg, with_profiles))
                   for wd in (True, False))  # K3's outputs
        aux = nreg + max(nreg - 1, 1) + 3  # K3's per-layer coefficients
        cols = (nd * nd + nd * nreg) + (nreg + 2 * nd)  # K2's top, K3's fin
    else:
        gamma = 2 * nd * nd + nd  # Gamma1, Gamma2, the emission rate b
        factory = 3 * nd * nd + 2 * nd  # R, T, int_diff, p, int_source
        stacks = lw_stack_rows(nd, nstream, nreg)  # K4
        rows = 2 * len(lw_out_rows(do_urban, nreg, with_profiles))  # K5
        aux = nreg + max(nreg - 1, 1) + 7
        cols = (nd * nd + nd) + 2 * nd
    transient = {"E": gamma + factory + stacks + rows + aux + _FRONT_E[lw],
                 "CL": _front_cl(nreg), "CS": cols}
    # the outputs are views of the down-sweep's rows, plus the sunlit
    # fractions and the ground and top-of-canopy fluxes
    kept = {"E": rows, "CL": 3, "CS": 8}
    return transient, kept


def class_bytes(words: dict, C: int, L: int, S: int, itemsize: int) -> int:
    """Bytes of {class: words per element} at C columns, L layers, S bands."""
    n = {"E": C * L * S, "CL": C * L, "CS": C * S, "C": C}
    return int(itemsize * sum(w * n[k] for k, w in words.items()))


def solve_bytes(ncol: int, nlay: int, nband: int, nreg: int, nstream: int,
                itemsize: int, *, lw: bool = False, do_urban: bool = True,
                with_profiles: bool = False) -> tuple:
    """(transient, kept) bytes of one kernel-route solve of ncol columns
    (see solve_words); itemsize: 4 (float32) or 8 (float64)."""
    t, k = solve_words(nreg, nstream, lw=lw, do_urban=do_urban,
                       with_profiles=with_profiles)
    return (class_bytes(t, ncol, nlay, nband, itemsize),
            class_bytes(k, ncol, nlay, nband, itemsize))


def device_budget(device, *, with_graphs: bool = True) -> float:
    """Bytes an automatic chunk may plan to fill on `device`: (free memory
    + what the caching allocator has reserved but not allocated) x
    BUDGET_SHARE - BUDGET_RESERVE, at least 0.  with_graphs: also count
    what the CUDA graphs hold there (utils/graphs.py: their pool's free
    blocks and their static buffers) as available, since a replay runs in
    its own graph's memory and the cache gives the rest back before an
    eager call or a capture that needs it; False: only what eager work can
    reach now (the pool's free blocks taken).  Off CUDA there is no
    separate device memory: math.inf."""
    device = torch.device(device)
    if device.type != "cuda":
        return math.inf
    free, _ = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    pool_free, buffers = graphs.held(device)
    room = free + cached + buffers if with_graphs else free + cached - pool_free
    return max(0.0, BUDGET_SHARE * room - BUDGET_RESERVE)
