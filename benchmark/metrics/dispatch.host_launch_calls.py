"""dispatch.host_launch_calls: the kernel, copy, set and graph launch calls
the host issues in one run_radsurf call (a CUDA graph's replay is one),
the mean over the traced calls.  Layer: dispatch and compiled programs."""


def read(t):
    return t.launches() / t.n if t.n else None
