"""Streamed solve over column chunks: the host-device copies overlap the solve.

Port of spartacus_surface_tpu/parallel/streaming.py.  For inputs larger
than device memory the column axis is processed in chunks, with a bounded
number of chunks in flight, so device memory stays at a few chunks'
working sets.  Host memory is not bounded: the inputs are resident host
arrays and the outputs are gathered into host arrays.

On a CUDA device the chunks go through three streams in a pipeline.
Chunk i+1's float fields are staged in pinned host buffers (depth + 1 sets,
reused) before chunk i's solve is issued; just after it, chunk i-1's
outputs are copied back into pinned buffers on one copy stream and chunk
i+1's fields to the device on another, so that both travel while the card
works through the queue of chunk i's kernels.  (Issued before the solve,
they would run while the card waits for its first launches.)  The compute
stream (the current stream, on which the kernels launch) waits on an event
of a chunk's copy in before its solve; a copy out waits on an event of its
chunk's solve.  Once chunk i is issued, chunk i - depth is finished: the
host waits for its copy back and takes it into the result.  Nothing here
synchronizes the device, and as long as `solve` issues its work without a
sync either, the host runs ahead of the card.
Integer fields (i_representation, nlay) stay host numpy: run_radsurf plans
its tile groups on the host.  On the CPU the same loop runs without streams
or pinned memory.

The reference has no analogue (an in-core OpenMP loop,
driver/spartacus_surface_driver.F90:199-234).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .mesh import tree_leaves, tree_map


def stream_columns(solve, arrays: dict, chunk: int, depth: int = 2,
                   device="cuda"):
    """Run `solve` over column chunks of `arrays`, the copies overlapping
    the solve.

    solve: dict of [c, ...] fields -> pytree (nested dicts, lists, tuples) of
        tensors with a leading column axis, e.g.
        lambda a: run_radsurf(config, a, device).  It gets each chunk's float
        fields as tensors on `device` and its other fields as host numpy.
    arrays: dict of host numpy arrays, every one with the column axis
        leading.
    chunk: columns per chunk (the last chunk may be smaller); chunk <= 0 or
        chunk >= ncol runs the whole axis as one chunk.
    depth: chunk i is finished (its outputs taken to the host) once chunk
        i + depth is issued (at least 1; 2: the outputs of one chunk travel
        back while the next one computes).
    device: the device of the solve (CUDA unless the caller asks for the
        CPU; without CUDA a CUDA device raises).

    Returns the outputs of `solve` as host numpy arrays over all columns, in
    the same pytree.
    """
    ncol = len(next(iter(arrays.values())))
    bad = {k: np.shape(v) for k, v in arrays.items()
           if np.ndim(v) == 0 or len(v) != ncol}
    if bad:
        raise ValueError(
            "stream_columns slices every input on axis 0; these arrays do"
            f" not have a leading column axis of length {ncol}: {bad}")
    if depth < 1:
        raise ValueError(f"depth must be at least 1, got {depth}")
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    if chunk <= 0 or chunk >= ncol:
        chunk = ncol
    host = {k: np.asarray(v) for k, v in arrays.items()}
    floats = [k for k, v in host.items() if v.dtype.kind == "f"]
    columns = [slice(a, min(a + chunk, ncol)) for a in range(0, ncol, chunk)]
    slots = [{} for _ in range(min(depth + 1, len(columns)))]
    if cuda:
        compute = torch.cuda.current_stream(device)
        h2d, d2h = torch.cuda.Stream(device), torch.cuda.Stream(device)

    def stage(i):
        """Chunk i's fields: the float ones copied into its pinned slot (on
        a CUDA device; CPU tensors else), the others as host numpy."""
        sl, slot = columns[i], slots[i % len(slots)]
        n = sl.stop - sl.start
        fields = {k: v[sl] for k, v in host.items() if k not in floats}
        if not cuda:
            fields.update({k: torch.from_numpy(np.ascontiguousarray(host[k][sl]))
                           for k in floats})
            return fields
        if "copied" in slot:  # the slot's last copy in has run
            slot["copied"].synchronize()
        for k in floats:
            src = torch.from_numpy(host[k][sl])
            if k not in slot:
                slot[k] = torch.empty((chunk,) + src.shape[1:], dtype=src.dtype,
                                      pin_memory=True)
            slot[k][:n].copy_(src)
            fields[k] = slot[k][:n]
        return fields

    def send(i, fields):
        """Start the copy of staged chunk i's float fields to the device."""
        if not cuda:
            return fields
        slot = slots[i % len(slots)]
        with torch.cuda.stream(h2d):
            fields = {k: v.to(device, non_blocking=True) if k in floats else v
                      for k, v in fields.items()}
            slot["copied"] = torch.cuda.Event()
            slot["copied"].record(h2d)
        return fields

    def run(i, fields):
        """Issue chunk i's solve: (i, its outputs, their event or None)."""
        if not cuda:
            return i, solve(fields), None
        compute.wait_event(slots[i % len(slots)]["copied"])
        for k in floats:  # freed only after the solve's use of them
            fields[k].record_stream(compute)
        res = solve(fields)
        solved = torch.cuda.Event()
        solved.record(compute)
        return i, res, solved

    def copy_out(item):
        """Start a solved chunk's copy to the host: (i, the copy's event or
        None, its host outputs to be, the outputs' pytree with 0 for each
        leaf)."""
        i, res, solved = item
        leaves, shape = tree_leaves(res), tree_map(lambda _: 0, res)
        if not cuda:
            return i, None, [t.detach() if isinstance(t, torch.Tensor) else t
                             for t in leaves], shape
        n = columns[i].stop - columns[i].start
        out = slots[i % len(slots)].setdefault("out", [None] * len(leaves))
        d2h.wait_event(solved)
        with torch.cuda.stream(d2h):
            for j, t in enumerate(leaves):
                if not isinstance(t, torch.Tensor):
                    out[j] = t
                    continue
                if out[j] is None or out[j].shape[1:] != t.shape[1:]:
                    out[j] = torch.empty((chunk,) + t.shape[1:], dtype=t.dtype,
                                         pin_memory=True)
                out[j][:n].copy_(t.detach(), non_blocking=True)
                t.record_stream(d2h)  # freed only after the copy out
            fetched = torch.cuda.Event()
            fetched.record(d2h)
        return i, fetched, [o[:n] if isinstance(o, torch.Tensor) else o
                            for o in out], shape

    result = []  # host arrays over all columns, one per leaf

    def finish(item):
        i, fetched, parts, _ = item
        if fetched is not None:
            fetched.synchronize()
        parts = [p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
                 for p in parts]
        if not result:
            result.extend(np.empty((ncol,) + p.shape[1:], p.dtype) for p in parts)
        for r, p in zip(result, parts):
            r[columns[i]] = p

    fields, solved, fetching = send(0, stage(0)), None, deque()
    for i in range(len(columns)):
        staged = stage(i + 1) if i + 1 < len(columns) else None
        previous, solved = solved, run(i, fields)
        if previous is not None:  # travels while the card works on chunk i
            fetching.append(copy_out(previous))
        fields = None if staged is None else send(i + 1, staged)
        while fetching and fetching[0][0] <= i - depth:
            finish(fetching.popleft())
    fetching.append(copy_out(solved))
    shape = fetching[-1][-1]
    while fetching:
        finish(fetching.popleft())
    it = iter(result)
    return tree_map(lambda _: next(it), shape)
