"""dispatch.h2d_mb: MB (1e6 bytes) that a load of run_radsurf's host inputs
moves from the host to the device (utils/graphs.py stats(): h2d_bytes over
h2d_loads, every load of the run counted; a call of a cell's key makes one
load).  None where the program counts no such load."""


def read(t):
    from spartacus_surface_tpu_torch.utils import graphs

    counted = graphs.stats()
    if not counted.get("h2d_loads"):
        return None
    return counted["h2d_bytes"] / counted["h2d_loads"] / 1e6
