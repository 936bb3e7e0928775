"""device.idle_share: the share of a traced call's span in which the
device ran nothing, 1 - busy / span over the traced calls, in %."""


def read(t):
    if not t.has_device():
        return None
    return 100.0 * (1.0 - t.busy_ms() / t.span_ms())
