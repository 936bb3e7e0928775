"""spartacus_surface_tpu_torch: the PyTorch / CUDA port of spartacus_surface_tpu.

The JAX package beside it is the reference this port is checked against.
This package imports ``torch`` and never ``jax`` (nor the JAX package), so it
runs on a GPU machine that has no JAX installed.

Every module of the JAX package has its counterpart: ``run_radsurf`` with
the shortwave and the longwave solve for every tile type (differentiable,
with the associative route), the offline CLI (``driver/main.py``: namelist,
NetCDF read and save) with the kernel demo (``driver/test_kernels.py``),
and the streamed, meshed and multi-process runs (``parallel/``,
``driver/merge.py``).
On CUDA tensors the layered SPARTACUS solves run on six hand-written CUDA
kernels (``csrc/``: the layer factory, structured and dense, each in its SW
and its LW pseudo-beam mode; the SW up-sweep and fused down-sweep; the LW
up-sweep and fused down-sweep); on CPU tensors the same routes run their
plain PyTorch versions.
"""

__version__ = "0.1.0"
