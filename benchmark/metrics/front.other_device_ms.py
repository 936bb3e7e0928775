"""front.other_device_ms: device ms of one run_radsurf call outside the
factory and sweep kernels (the front end's geometry and Gamma assembly,
dispatch's scatter, copies), the mean over the traced calls."""

KERNELS = ("layer_factory_kernel", "layer_factory_dense_kernel", "sw_up_kernel",
           "sw_down_kernel", "lw_up_kernel", "lw_down_kernel")


def read(t):
    if not t.has_device():
        return None
    return t.device_ms(exclude=KERNELS) / t.n
