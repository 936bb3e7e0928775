"""Carry solver inputs into the port.

The solver has no weights: what crosses from the JAX package is its input.
``to_canopy_inputs`` turns a JAX ``CanopyInputs`` (or any object with the
same array fields, numpy or JAX arrays) into this package's
``CanopyInputs`` on a given device and dtype, without importing JAX.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from ..models.solver import CanopyInputs


def torch_dtype(np_dtype) -> torch.dtype:
    """float32 / float64 numpy dtype -> torch dtype (others raise KeyError)."""
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(np_dtype)]


def to_canopy_inputs(src, device, dtype=None) -> CanopyInputs:
    """Port CanopyInputs from `src`'s array fields (None stays None).

    dtype defaults to that of src.air_ext.  A CUDA device on a machine
    without CUDA raises; nothing moves to the CPU instead.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    if dtype is None:
        dtype = torch_dtype(np.asarray(src.air_ext).dtype)
    kw = {}
    for f in fields(CanopyInputs):
        x = getattr(src, f.name, None)
        if x is not None:
            # a copy: a [C, 1] view may be "contiguous" with a negative
            # stride, which torch refuses
            kw[f.name] = torch.as_tensor(np.array(x, order="C"), dtype=dtype,
                                         device=device)
    return CanopyInputs(**kw)
