"""columns_per_s: the columns of every call completed in the timed window
over the window's seconds (from its start to the end of its last call)."""


def read(w):
    return w.columns * len(w.walls) / w.seconds if w.walls else None
