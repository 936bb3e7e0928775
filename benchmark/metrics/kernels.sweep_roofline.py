"""kernels.sweep_roofline: the four sweeps' least time on the card's
published peaks (benchmark/work.py, stages STAGES) over the device time of
K2-K5, in %."""

KERNELS = ("sw_up_kernel", "sw_down_kernel", "lw_up_kernel", "lw_down_kernel")
STAGES = ("sweeps_sw", "sweeps_lw")


def read(t):
    ms, bound = t.device_ms(KERNELS), t.bound_ms(STAGES)
    if not ms or bound is None:
        return None
    return 100.0 * bound / ms
