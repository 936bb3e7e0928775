"""spartacus_surface_tpu_torch: the PyTorch / CUDA port of spartacus_surface_tpu.

The JAX package beside it is the reference this port is checked against.
This package imports ``torch`` and never ``jax`` (nor the JAX package), so it
runs on a GPU machine that has no JAX installed.

Slice covered so far: the shortwave solve (``run_radsurf`` with
``do_lw = False``) for every tile type.  On CUDA tensors the layered
SPARTACUS solve runs on three hand-written CUDA kernels (layer factory, SW
up-sweep, fused SW down-sweep, ``csrc/``); on CPU tensors the same route runs
their plain PyTorch versions.
"""

__version__ = "0.1.0"
