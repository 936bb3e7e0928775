"""kernels.k1d_roofline: the SW layer factory's least time on the card's
published peaks (benchmark/work.py, stage ``factory_sw``) over the device
time of the dense layer factory K1d, in %.  Read where K1d computes the
whole SW factory (a 1-stream solve: nd < 2 ndir) and K1 the LW one, as
at rami5_ns1; None where the trace holds no K1d event."""

KERNELS = ("layer_factory_dense_kernel",)
STAGES = ("factory_sw",)


def read(t):
    ms, bound = t.device_ms(KERNELS), t.bound_ms(STAGES)
    if not ms or bound is None:
        return None
    return 100.0 * bound / ms
