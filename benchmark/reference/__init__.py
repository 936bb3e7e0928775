"""The benchmark's plain reference: a frozen copy of the port's plain route
(the scan-route solver, the layer factory, the sweeps, geometry, Gamma
assembly, the flat and simple-urban tiles and the tile grouping), in plain
PyTorch.  It imports nothing of the program or of JAX, and works out
everything from the inputs the benchmark hands it."""

from .dispatch import TILE_CODES, run_radsurf, settings, solver_groups
from .matrix import tf32_products

__all__ = ["TILE_CODES", "run_radsurf", "settings", "solver_groups", "tf32_products"]
