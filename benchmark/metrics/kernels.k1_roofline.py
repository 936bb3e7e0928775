"""kernels.k1_roofline: the layer factory's least time on the card's
published peaks (benchmark/work.py, stages STAGES) over the device time of
the kernels that compute it (K1 and K1d, SW and LW mode), in %."""

KERNELS = ("layer_factory_kernel", "layer_factory_dense_kernel")
STAGES = ("factory_sw", "factory_lw")


def read(t):
    ms, bound = t.device_ms(KERNELS), t.bound_ms(STAGES)
    if not ms or bound is None:
        return None
    return 100.0 * bound / ms
