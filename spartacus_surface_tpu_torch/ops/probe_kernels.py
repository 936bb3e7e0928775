"""Probe kernels K6 and K7: the card's FMA and memory-stream ceilings.

Replace the TPU probes of tools/roofline.py: ``measure_vpu_peak_flops``
(:39, kernel :52) and ``measure_hbm_bw`` (:83, kernel :95).  CUDA source:
csrc/roofline_probes.cu.  Plain versions: ``fma_chain_plain`` and
``copy_add_plain``, the same arithmetic in torch ops.

* K6 ``fma_chain(x, b, c)``: x [FMA_ACC, n] (float32 or float64) holds the
  starting values of FMA_ACC independent chains for each of n threads;
  each chain takes FMA_INNER steps acc = fma(acc, c, b).  FLOPs per call:
  2 * n * FMA_ACC * FMA_INNER.  Bound by operations.
* K7 ``copy_add(x, out=None)``: o = x + 1 over a float32 array, 16 bytes
  per access, into a new tensor or into ``out`` (as ``torch.add(x, 1.0,
  out=o)`` writes a preallocated one).  Bytes per call: 2 * x.nbytes.
  Bound by device-memory bytes.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.  The plain fma_chain rounds twice a step (mul, then add) where the
kernel's fma rounds once.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

FMA_ACC = 8  # independent chains per thread (csrc: SPX_FMA_ACC)
FMA_INNER = 512  # chained steps per chain (csrc: SPX_FMA_INNER)


def fma_chain_plain(x, b, c):
    """Plain PyTorch version of K6; see fma_chain."""
    acc = x.clone()
    for _ in range(FMA_INNER):
        acc = acc * c + b
    return acc


def fma_chain(x, b: float, c: float):
    """K6: FMA_INNER chained steps acc = fma(acc, c, b) from x [FMA_ACC, n]
    (float32 or float64); returns the final accumulators, x's shape."""
    dev = cuda_build.validate("fma_chain", {"x": (x, (FMA_ACC, x.shape[-1]))})
    if dev.type == "cpu":
        return fma_chain_plain(x, b, c)
    with torch.cuda.device(dev):
        return launch_fma(cuda_build.load("roofline_probes"), x, b, c,
                          stream=cuda_build.stream(dev))


# the C signatures of the launchers (csrc/roofline_probes.cu)
FMA_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_double] * 2 + [
    ctypes.c_longlong, ctypes.c_void_p]
COPY_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p]


def launch_fma(lib, x, b, c, *, stream):
    """Allocate the output and launch lib's fma_chain_f32/f64; counts the
    launch."""
    fn = cuda_build.bind(lib, "fma_chain_f32" if x.dtype == torch.float32
                         else "fma_chain_f64", FMA_ARGTYPES)
    out = torch.empty_like(x)
    err = fn(cuda_build.ptr(x), cuda_build.ptr(out), b, c, x.shape[-1], stream)
    cuda_build.check(err, "fma_chain")
    fma_chain.launches += 1
    return out


fma_chain.launches = 0


def copy_add_plain(x):
    """Plain PyTorch version of K7; see copy_add."""
    return x + 1.0


def copy_add(x, out=None):
    """K7: x + 1 for a contiguous float32 tensor x, streamed through device
    memory; returns a new tensor of x's shape, or writes `out` (x's shape
    and dtype, on its device, contiguous, 16-byte aligned on the card) and
    returns it."""
    operands = {"x": (x, tuple(x.shape))}
    if out is not None:
        operands["out"] = (out, tuple(x.shape))
    dev = cuda_build.validate("copy_add", operands)
    if x.dtype != torch.float32:
        raise TypeError(f"copy_add: dtype {x.dtype} is not float32")
    if dev.type == "cpu":
        return copy_add_plain(x) if out is None else out.copy_(copy_add_plain(x))
    for name, t in (("x", x), ("out", out)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"copy_add: {name} is not 16-byte aligned")
    with torch.cuda.device(dev):
        return launch_copy(cuda_build.load("roofline_probes"), x,
                           stream=cuda_build.stream(dev), out=out)


def launch_copy(lib, x, *, stream, out=None):
    """Launch lib's copy_add_f32 into `out` (allocated here where None);
    counts the launch."""
    fn = cuda_build.bind(lib, "copy_add_f32", COPY_ARGTYPES)
    if out is None:
        out = torch.empty_like(x)
    err = fn(cuda_build.ptr(x), cuda_build.ptr(out), x.numel(), stream)
    cuda_build.check(err, "copy_add")
    copy_add.launches += 1
    return out


copy_add.launches = 0
