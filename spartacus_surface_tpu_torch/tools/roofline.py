"""Roofline analysis of the port on an NVIDIA H100.

Port of tools/roofline.py (the JAX package's TPU tool).  It answers "is N
columns/s fast?" with arithmetic:

  1. MEASURE the card's two ceilings with the probe kernels K6 and K7
     (ops/probe_kernels.py, csrc/roofline_probes.cu): the FMA rate outside
     the tensor cores in float32 and float64 (chained FMAs, the only
     arithmetic the port's kernels issue) and the device-memory stream
     bandwidth (o = x + 1 over 512 MB into a preallocated o, as
     torch.add(x, 1.0, out=o) writes).  CUDA events over back-to-back
     launches after a warm-up, median of 3.
  2. MODEL the work of each kernel launch as written: ``kernel_work`` counts
     the FLOPs of the CUDA bodies of K1, K1d and K2-K5 loop for loop (every
     add, subtract, multiply and divide one FLOP, an FMA two: the
     convention of the counting build csrc/host_count.cpp, which the CPU
     tests hold this model to) with each factory element's own doubling
     count K from its operands, and the compulsory bytes (each operand of
     the launch read once, each result written once; no workspace).
  3. BOUND: ``roofline`` gives the least time the card could take,
     max(flops / FMA peak, bytes / bandwidth), against the H100's published
     peaks (67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor
     cores, 3.35 TB/s) and, beside it, against the measured ceilings.

Usage (on the card):
  python -m spartacus_surface_tpu_torch.tools.roofline [--measure-only]
      [--cols-per-sec X]
It prints the card's name and power limit, the ceilings, the whole-solve
ceiling of three configurations in columns/s, and as its last line a JSON
object of the same numbers.  Without CUDA it exits nonzero: no number here
comes from a CPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from ..ops import layer_kernel as LK
from ..ops import lw_sweep_kernels as LSK
from ..ops import probe_kernels as PK
from ..ops import sweep_kernels as SK
from ..ops.layer_matrices import pade7_theta

# NVIDIA's H100 SXM data sheet (dense, 700 W): FMA units outside the tensor
# cores, and HBM3.
PUBLISHED_FMA_PEAK = {torch.float32: 67e12, torch.float64: 34e12}
PUBLISHED_HBM_BW = 3.35e12

FMA_WAVES = 8  # K6 threads per launch: 8 x (SMs x 2,048 resident threads)
FMA_B, FMA_C = 0.75, 1.0000001  # K6's step acc = fma(acc, FMA_C, FMA_B)
HBM_SHAPE = (256, 512, 8, 128)  # K7's float32 array: 512 MB, as the TPU probe

# the kernel wrappers of the main path that kernel_work models
KERNELS = ("layer_factory", "sw_up_sweep", "sw_down_sweep_both",
           "lw_layer_factory", "lw_up_sweep", "lw_down_sweep_both")
# (name, nreg, ns, layers, bands) of the TPU tool's configurations
CONFIGS = (("headline nreg=2 ns=4 L=8 S=1", 2, 4, 8, 1),
           ("nreg=3 ns=4 L=8 S=1", 3, 4, 8, 1),
           ("rami5 nreg=3 ns=4 L=62 S=14", 3, 4, 62, 14))


# ----------------------------------------------------------------------
# The probes (K6, K7) and their timing
# ----------------------------------------------------------------------

def _cuda(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the roofline probes need a CUDA device, not {dev}"
                           " (torch.cuda.is_available() is"
                           f" {torch.cuda.is_available()})")
    return dev


def fma_operands(dtype, device, seed=0):
    """K6's seeded starting values [FMA_ACC, n] in [0.5, 1.5), n = FMA_WAVES
    x the card's resident threads (SMs x 2,048)."""
    dev = _cuda(device)
    n = FMA_WAVES * torch.cuda.get_device_properties(dev).multi_processor_count * 2048
    gen = torch.Generator(dev).manual_seed(seed)
    return torch.rand((PK.FMA_ACC, n), generator=gen, dtype=dtype, device=dev) + 0.5


def hbm_operand(device, seed=0):
    """K7's seeded float32 array of HBM_SHAPE (512 MB)."""
    dev = _cuda(device)
    gen = torch.Generator(dev).manual_seed(seed)
    return torch.rand(HBM_SHAPE, generator=gen, dtype=torch.float32, device=dev)


def fma_flops(x) -> float:
    """FLOPs of one K6 launch on x: 2 per FMA."""
    return 2.0 * x.numel() * PK.FMA_INNER


def event_ms(fn, launches=20, reps=3) -> float:
    """Median over `reps` windows of the device ms per call of `launches`
    back-to-back calls of fn, timed with CUDA events after one warm-up
    window.  One untimed call goes before each window, so the window opens
    with the card busy and the first call's host work is not inside it."""
    times = []
    for rep in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        if rep:
            times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def measure_fma_peak(dtype=torch.float32, device="cuda") -> float:
    """FLOP/s of K6 (chained FMAs, FMA_ACC chains per thread) in `dtype` on
    the card; raises without CUDA."""
    x = fma_operands(dtype, device)
    return fma_flops(x) / (1e-3 * event_ms(lambda: PK.fma_chain(x, FMA_B, FMA_C)))


def measure_hbm_bw(device="cuda") -> float:
    """Bytes/s of K7 (o = x + 1 over 512 MB into a preallocated o: 2 x 512
    MB a launch) on the card; raises without CUDA."""
    x = hbm_operand(device)
    o = torch.empty_like(x)
    return 2.0 * x.nbytes / (1e-3 * event_ms(lambda: PK.copy_add(x, out=o)))


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return f"{torch.cuda.get_device_name()}, power limit not read (nvidia-smi failed)"


# ----------------------------------------------------------------------
# The work model: the CUDA bodies as written
# ----------------------------------------------------------------------

def _fma_matmul(n, p, m):
    """The JAX tool's count: n*p row-slab FMAs of width m."""
    return n * p * m


def _fma_solve(n, m):
    """The JAX tool's count of _solve_inplace: elimination
    sum_k (n-1-k)*((n-k-1) + m) + back substitution sum_i (n-1-i)*m + n*m."""
    elim = sum((n - 1 - k) * ((n - k - 1) + m) for k in range(n - 1))
    back = sum((n - 1 - i) * m for i in range(n)) + n * m
    return elim + back


def _mm(n, p, m):
    """FLOPs of common.cuh tmm: an (n x p) @ (p x m) product."""
    return 2 * n * p * m


def _mv(n, p):
    """FLOPs of an (n x p) matrix-vector product (common.cuh dot_row, one
    row at a time)."""
    return 2 * n * p


def _solve(n, m):
    """FLOPs of common.cuh tsolve: n x n, m right-hand sides."""
    elim = sum(1 + j * (1 + 2 * j + 2 * m) for j in range(1, n))
    back = sum(1 + m * (2 * j + 1) for j in range(n))
    return elim + back


def _doubling_flops(nd, ndir):
    """One adding-doubling step of extract_double (layer_factory.cu)."""
    mx = nd + ndir
    return (4 * _mm(nd, nd, nd) + 4 * _mm(nd, nd, ndir) + 2 * _mm(nd, ndir, ndir)
            + _mm(ndir, ndir, ndir) + nd * nd + _solve(nd, mx))


def _factory_fixed_flops(nd, ndir, int_direct=True):
    """Per element, everything of K1 or K1d but the doubling steps: the
    expm (K1: half-size Pade-7 and the F - I solve at 2 nd; K1d: the full
    N = 2 nd + ndir Pade-7), the thin-layer extraction and the Schur
    integrals (layer_factory.cu).  K1's and K1d's team bodies count once
    per element, whatever their team size: a product or solve split over
    the lanes does the element's arithmetic once, and the scalars each lane
    repeats (a pivot's reciprocal, the norm's max) are not counted again."""
    n2, nr, d2, N = nd * nd, nd * ndir, ndir * ndir, 2 * nd + ndir
    if LK.is_structured(nd, ndir):  # K1
        f = 8 * n2 + 4 * nr + 3 * d2 + 3 * nd + ndir + 1  # assembly, K, 2^-K
        f += 8 * _mm(nd, nd, nd) + 20 * n2 + 4 * nd  # powers, polynomials
        f += (4 * _mm(ndir, ndir, ndir) + 12 * d2 + 2 * ndir
              + _solve(ndir, ndir))  # direct block X33
        f += 7 * _mm(nd, nd, ndir) + 10 * _mm(nd, ndir, ndir) + 20 * nr  # columns
        f += 2 * n2 + nr * (2 + 6 * ndir) + _solve(2 * nd, N)  # (V - U) X = 2 U
        f += 12 * n2 + 4 * nr + 2 * nd + d2  # butterfly, + I
    else:  # K1d: assembly, the row sums of |Gamma dz|, K, 2^-K
        f = 2 * n2 + nr + d2 + 2 * N * N + 1
        f += 4 * _mm(N, N, N) + 12 * N * N + 2 * N + _solve(N, N)  # Pade-7
    f += _solve(nd, nd + ndir) + 2 * n2 * (nd + ndir)  # extraction
    f += 2 * _solve(nd, nd) + 4 * _mm(nd, nd, nd) + 2 * n2  # int_diff
    if int_direct:
        f += _solve(ndir, ndir) + _mm(nd, ndir, ndir) + nr * (3 * nd + 1)
    return f


def _sw_up_flops(nd, ns, nreg, L):
    """K2, one thread (element) over L layers (sw_sweeps.cu)."""
    nregp = nreg + 1
    layer = (3 * _mm(nd, nd, nd) + nd * nd + _mm(nd, nreg, nreg)
             + 2 * _mm(nd, nd, nreg) + _solve(nd, 2 * nd + nreg)
             + ns * ns + 2 * ns
             + (2 * nd + nreg) * nd * nregp * nregp
             + 2 * nd * nregp * (nregp + nreg))
    return nd * ns + 2 * nd + L * layer


def _sw_down_flops(nd, ns, nreg, L, do_urban, with_profiles):
    """K3, one element over L layers, both modes (sw_sweeps.cu: its team
    body counts once per element, as K1's)."""
    nregp, nd2 = nreg + 1, (nreg + 1) * ns
    mode = (2 * nreg * nd2 + _mv(nd2, nd2) + 2 * ns
            + 4 * _mv(nd, nd) + 11 * nd + 3
            + (7 * (nreg - 1) + 2 if nreg > 1 else 0)
            + (4 * nreg + 2 if do_urban else 0))
    direct = (2 * nregp * nreg + _mv(nd2, nregp) + 2 + 2 * _mv(nreg, nreg)
              + 3 * _mv(nd, nreg) + _mv(nd, nd) + nd + 3 * nreg + (nreg > 1)
              + 3 * do_urban + 6 * with_profiles)
    return 3 + L * (2 * mode + direct)


def _lw_up_flops(nd, ns, nreg, L):
    """K4, one thread over L layers (lw_sweeps.cu)."""
    nregp = nreg + 1
    layer = (3 * _mm(nd, nd, nd) + 5 * nd * nd + _solve(nd, 2 * nd + 1)
             + 2 + ns * ns + ns + (2 * nd + nreg) * nd * nregp * nregp
             + 2 * nd * nregp)
    return 2 * nd * ns + 2 * nd + L * layer


def _lw_down_flops(nd, ns, nreg, L, do_urban):
    """K5, one element over L layers, both modes (lw_sweeps.cu)."""
    nd2 = (nreg + 1) * ns
    mode = (2 * nd2 * nreg + _mv(nd2, nd2) + 2 * ns + 4 * _mv(nd, nd) + 11 * nd
            + 3 + (3 * (nreg - 1) + 4 if nreg > 1 else 0)
            + (2 * nreg + 2 if do_urban else 0))
    sources = nd2 + _mv(nd, nd) + 3 * nd
    return L * (2 * mode + sources)


def layer_flops(nd, ndir, K, int_direct=True):
    """FLOPs of one factory element (K1 or K1d by is_structured) that takes
    K doubling steps."""
    return _factory_fixed_flops(nd, ndir, int_direct) + K * _doubling_flops(nd, ndir)


def _factory_call(kernel, args, kw):
    """(g0, g1, g2, g3, dz, ndir, int_direct) of the launch behind a
    layer_factory or lw_layer_factory call (the LW pseudo-beam: gamma0 = 0,
    gamma3 = b, no direct-beam integrals)."""
    if kernel == "lw_layer_factory":
        g1, g2, b, dz = args
        return LK._lw_operands(g1, b)[0], g1, g2, b, dz, 1, False
    return (*args, kw["ndir"], kw.get("int_direct", True))


def doubling_ratio(kernel, *args, **kw):
    """[L, B] ||Gamma dz||_inf / theta of each element of a layer_factory or
    lw_layer_factory call (the norm at least 1e-30), in float64, theta of
    the operands' precision (ops/layer_matrices.py,
    csrc/layer_factory.cu)."""
    g0, g1, g2, g3, dz, ndir, _ = _factory_call(kernel, args, kw)
    nd = kw["nd"]
    L, _, B = g1.shape
    rows = lambda g, n, m: g.double().abs().reshape(L, n, m, B).sum(2)
    nrm = torch.maximum(
        (rows(g1, nd, nd) + rows(g2, nd, nd) + rows(g3, nd, ndir)).amax(1),
        rows(g0, ndir, ndir).amax(1)) * dz.double()
    return nrm.clamp_min(1e-30) / pade7_theta(g1.dtype)


def doubling_steps(kernel, *args, **kw):
    """[L, B] doubling count of each element of a layer_factory or
    lw_layer_factory call: K = ceil(log2(||Gamma dz||_inf / theta)) clipped
    to [0, n_double] (doubling_ratio)."""
    return torch.clamp(torch.ceil(torch.log2(doubling_ratio(kernel, *args, **kw))),
                       0, kw.get("n_double", 30))


def kernel_work(kernel, *args, K=None, **kw):
    """(flops, bytes) of one call of a kernel wrapper of the main path on
    these operands (args and keywords as the solver passes them): kernel
    is "layer_factory" or "lw_layer_factory" (K1 or K1d, by is_structured),
    "sw_up_sweep" (K2), "sw_down_sweep_both" (K3), "lw_up_sweep" (K4) or
    "lw_down_sweep_both" (K5).  FLOPs of the CUDA bodies as written, each
    factory element with its own doubling count from its operands (or K
    for every element, where given); bytes: every operand of the launch
    read once and every result written once, no workspace."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel_work: unknown kernel {kernel!r}")
    if kernel in ("layer_factory", "lw_layer_factory"):
        g0, g1, g2, g3, dz, ndir, int_direct = _factory_call(kernel, args, kw)
        nd = kw["nd"]
        L, _, B = g1.shape
        steps = (K * L * B if K is not None
                 else float(doubling_steps(kernel, *args, **kw).sum()))
        flops = (L * B * _factory_fixed_flops(nd, ndir, int_direct)
                 + steps * _doubling_flops(nd, ndir))
        rows = LK.out_rows(nd, ndir)
        inputs = (g0, g1, g2, g3, dz)
        out = L * B * sum(rows[k] for k in LK.out_names(int_direct))
    else:
        inputs = args
        L, _, B = args[0].shape
        nd, ns, nreg = kw["nd"], kw["ns"], kw["nreg"]
        if kernel == "sw_up_sweep":
            flops = B * _sw_up_flops(nd, ns, nreg, L)
            out = B * (L * SK.sw_stack_rows(nd, ns, nreg) + nd * nd + nd * nreg)
        elif kernel == "sw_down_sweep_both":
            urban, prof = kw["do_urban"], kw["with_profiles"]
            flops = B * _sw_down_flops(nd, ns, nreg, L, urban, prof)
            out = B * (L * sum(len(SK.sw_out_rows(wd, urban, nreg, prof))
                               for wd in SK.MODES) + nreg + 2 * nd)
        elif kernel == "lw_up_sweep":
            flops = B * _lw_up_flops(nd, ns, nreg, L)
            out = B * (L * LSK.lw_stack_rows(nd, ns, nreg) + nd * nd + nd)
        else:  # lw_down_sweep_both
            urban, prof = kw["do_urban"], kw["with_profiles"]
            flops = B * _lw_down_flops(nd, ns, nreg, L, urban)
            out = B * (2 * L * len(LSK.lw_out_rows(urban, nreg, prof)) + 2 * nd)
    nbytes = sum(t.nbytes for t in inputs) + out * inputs[0].element_size()
    return float(flops), float(nbytes)


def roofline(flops, nbytes, ms=None, dtype=torch.float32, fma_peak=None,
             hbm_bw=None) -> dict:
    """The least time the card could take for `flops` FLOPs and `nbytes`
    compulsory bytes, max(flops / FMA peak, bytes / bandwidth), in ms, with
    what sets it ("operations" or "bytes"), against the published H100 peaks
    (dtype's FMA rate) or the measured ceilings fma_peak / hbm_bw where
    given; with ms, the measured time, also share = bound / ms."""
    t_ops = 1e3 * flops / (fma_peak or PUBLISHED_FMA_PEAK[dtype])
    t_bytes = 1e3 * nbytes / (hbm_bw or PUBLISHED_HBM_BW)
    out = {"bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if ms:
        out["share"] = out["bound_ms"] / ms
    return out


def _model_operands(nreg, ns, L, dtype=torch.float32):
    """{kernel: (args, kwargs)} of one column and band (B = C = 1) of the SW
    and LW solves, as meta tensors (shapes only)."""
    nd, nregp, nd2 = nreg * ns, nreg + 1, (nreg + 1) * ns
    nod = max(nreg - 1, 1)
    t = lambda *shape: torch.empty(shape, dtype=dtype, device="meta")
    lay = lambda rows: t(L, rows, 1)
    sq, ov, q = lay(nd * nd), t(L, nreg * nregp, 1), t(ns)
    sweep = dict(nd=nd, ns=ns, nreg=nreg)
    down = dict(sweep, do_urban=True, with_profiles=False)
    return {
        "layer_factory": ((lay(nreg * nreg), sq, sq, lay(nd * nreg), t(L, 1)),
                          dict(nd=nd, ndir=nreg)),
        "sw_up_sweep": ((sq, sq, lay(nreg * nreg), lay(nd * nreg), lay(nd * nreg),
                         ov, ov, t(L, 1), t(L, 1), t(3, 1), q), sweep),
        "sw_down_sweep_both": (
            (sq, sq, lay(nreg * nreg), lay(nd * nreg), lay(nreg * nreg), sq,
             lay(nd * nreg), lay(SK.sw_stack_rows(nd, ns, nreg)), ov,
             lay(nreg + nod + 3), t(1), q, q, q), down),
        "lw_layer_factory": ((sq, sq, lay(nd), t(L, 1)), dict(nd=nd)),
        "lw_up_sweep": ((sq, sq, lay(nd), ov, ov, t(L, 1), t(L, 1), t(L, 1),
                         t(2 + nreg, 1), q), sweep),
        "lw_down_sweep_both": (
            (sq, sq, lay(nd), sq, lay(nd), lay(LSK.lw_stack_rows(nd, ns, nreg)),
             ov, lay(nreg + nod + 7), q, q, q), down),
    }


def factory_fmas(nd, ndir, K):
    """FMAs (FLOPs / 2) of one SW factory element that takes K doubling
    steps: K1, or K1d where is_structured(nd, ndir) is false."""
    return layer_flops(nd, ndir, K) / 2


def sweep_fmas(nd, ns, nreg):
    """FMAs (FLOPs / 2) per element per layer of the SW up-sweep and the
    fused down-sweep (urban, no profiles)."""
    return (_sw_up_flops(nd, ns, nreg, 1) - _sw_up_flops(nd, ns, nreg, 0)
            + _sw_down_flops(nd, ns, nreg, 1, True, False)
            - _sw_down_flops(nd, ns, nreg, 0, True, False)) / 2


def solve_work_model(nreg, ns, L, K_mean=3.0, lw=True, K_mean_lw=None):
    """(flops, bytes) per column and band of the SW (+ LW) solve in float32:
    the six kernel launches of ``kernel_work`` (K1 or K1d, K2, K3; LW: K1
    or K1d, K4, K5), every factory element taking K_mean doubling steps
    (K_mean_lw in the LW factory; default K_mean)."""
    kernels = ("layer_factory", "sw_up_sweep", "sw_down_sweep_both")
    if lw:
        kernels += ("lw_layer_factory", "lw_up_sweep", "lw_down_sweep_both")
    ops = _model_operands(nreg, ns, L)
    flops = nbytes = 0.0
    for k in kernels:
        a, kw = ops[k]
        steps = K_mean_lw if k == "lw_layer_factory" and K_mean_lw is not None else K_mean
        f, b = kernel_work(k, *a, K=steps if "factory" in k else None, **kw)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


# ----------------------------------------------------------------------
# The tool
# ----------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="roofline", description=__doc__.split("\n")[0])
    ap.add_argument("--measure-only", action="store_true",
                    help="only measure the FMA and bandwidth ceilings")
    ap.add_argument("--cols-per-sec", type=float, default=None,
                    help="measured columns/s of the headline configuration"
                         " (SW + LW, float32) on this card, for its share")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("roofline: needs an NVIDIA GPU (torch.cuda.is_available() is"
              " false); it gives no CPU numbers", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    report = {"card": card(), "fma_peak": {}, "configs": []}
    print(f"card: {report['card']}")
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        peak = report["fma_peak"][name] = measure_fma_peak(dt, dev)
        print(f"measured FMA peak {name}: {peak / 1e12:.2f} TFLOP/s"
              f" ({peak / PUBLISHED_FMA_PEAK[dt]:.3f} of the published"
              f" {PUBLISHED_FMA_PEAK[dt] / 1e12:.0f})")
    bw = report["hbm_bw"] = measure_hbm_bw(dev)
    print(f"measured HBM stream bandwidth: {bw / 1e9:.1f} GB/s"
          f" ({bw / PUBLISHED_HBM_BW:.3f} of the published"
          f" {PUBLISHED_HBM_BW / 1e12:.2f} TB/s)")
    if not args.measure_only:
        for i, (name, nreg, ns, L, S) in enumerate(CONFIGS):
            flops, nbytes = (S * x for x in solve_work_model(nreg, ns, L))
            pub = roofline(flops, nbytes)
            meas = roofline(flops, nbytes, fma_peak=report["fma_peak"]["float32"],
                            hbm_bw=bw)
            row = {"name": name, "flops_per_col": flops, "bytes_per_col": nbytes,
                   "ceiling_cols_per_sec": 1e3 / pub["bound_ms"],
                   "bound_by": pub["bound_by"],
                   "measured_ceiling_cols_per_sec": 1e3 / meas["bound_ms"]}
            line = (f"{name}: {flops / 1e6:.2f} MFLOP/col, {nbytes / 1e3:.1f}"
                    f" KB/col -> ceiling {row['ceiling_cols_per_sec']:,.0f}"
                    f" cols/s published, {row['measured_ceiling_cols_per_sec']:,.0f}"
                    f" measured (bound by {pub['bound_by']})")
            if i == 0 and args.cols_per_sec:
                row["cols_per_sec"] = args.cols_per_sec
                row["share"] = args.cols_per_sec / row["ceiling_cols_per_sec"]
                line += (f"; measured {args.cols_per_sec:,.0f} cols/s ="
                         f" {row['share']:.2%} of the published roofline")
            report["configs"].append(row)
            print(line)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
