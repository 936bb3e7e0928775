"""setup_s: from the start of the process to the first timed call: import,
the input sets, the first (eager) call, the capture, a replay of every
input set, and in a checkout's first run the kernels' build."""


def read(w):
    return w.setup_s
