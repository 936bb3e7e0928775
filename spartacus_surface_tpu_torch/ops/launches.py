"""The launch counters of the solve's kernel wrappers, by label.

Each wrapper adds one to its counter where it launches its kernel, and
nowhere else (a CPU tensor takes the plain version and counts nothing).
"""

from __future__ import annotations

from . import layer_kernel as LK
from . import lw_sweep_kernels as LSK
from . import sweep_kernels as SK

# {label: (wrapper, counter attribute)}; K1 and K1d count their LW-mode
# launches in the counters of both factory wrappers; "K1 order" counts the
# order pass that runs before every K1 and K1d launch
COUNTERS = {
    "K1": (LK.layer_factory, "launches"),
    "K2": (SK.sw_up_sweep, "launches"),
    "K3": (SK.sw_down_sweep_both, "launches"),
    "K4": (LSK.lw_up_sweep, "launches"),
    "K5": (LSK.lw_down_sweep_both, "launches"),
    "K1d": (LK.layer_factory, "dense_launches"),
    "K1 LW mode": (LK.lw_layer_factory, "launches"),
    "K1d LW mode": (LK.lw_layer_factory, "dense_launches"),
    "K1 order": (LK.layer_factory, "order_launches"),
}
# the kernels an SW + LW solve with 2 or more streams launches
PATH_4 = ("K1", "K2", "K3", "K4", "K5", "K1 LW mode")


def counts() -> dict:
    """{label: launches counted since the last reset}."""
    return {k: getattr(w, a) for k, (w, a) in COUNTERS.items()}


def reset():
    for w, a in COUNTERS.values():
        setattr(w, a, 0)


def add(delta: dict):
    """Add {label: launches} to the counters (utils/graphs.py: a replay
    adds the launches its capture counted)."""
    for k, n in delta.items():
        w, a = COUNTERS[k]
        setattr(w, a, getattr(w, a) + n)
