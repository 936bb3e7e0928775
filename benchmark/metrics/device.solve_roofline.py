"""device.solve_roofline: the call's whole algorithmic least time (factory
and sweeps, SW and LW, each stage the larger of operations over the FMA
peak and bytes over the memory bandwidth; benchmark/work.py) over the
device's busy time, in %."""

STAGES = ("factory_sw", "factory_lw", "sweeps_sw", "sweeps_lw")


def read(t):
    busy, bound = t.busy_ms(), t.bound_ms(STAGES)
    if not busy or bound is None:
        return None
    return 100.0 * bound / busy
