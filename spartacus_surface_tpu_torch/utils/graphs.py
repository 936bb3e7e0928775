"""CUDA graphs of the port's compiled programs: the counterpart of the
executable cache behind ``jax.jit``.

The JAX package runs each solve (``spartacus_sw`` / ``spartacus_lw``, jitted
with static options) and ``run_radsurf``'s device work (``_radsurf_core``) as
one compiled program per static key.  On CUDA the counterpart is a CUDA
graph, captured once per key and replayed with one launch.  ``call`` keeps
them, keyed by what a JAX static argument or shape would key: the caller's
static part (the function, its options, the resolved column chunk), the
device it runs on, and the shape, dtype and device of every input tensor.

Inputs may lie on the device or on the host (CPU tensors for a CUDA call):
host inputs are packed into one pinned buffer a dtype and moved with one
transfer each, on a replay straight into the graph's static input buffers.
A caller may name the array that holds each host input's memory (its
owner): a replay then copies an input whose live owner the cache has loaded
before straight from the owner's pages, page-locked once (Pinned), with no
pack, and returns only once the card has read them.

* First call of a key: ``fn`` runs eagerly.  That is the warm-up a capture
  needs (kernel builds, launch configurations, cuBLAS handles, the cached
  constants of utils/transfer.py), and the call that checks may hold
  against the kernels' plain versions.
* Second call: the inputs are copied into static buffers the graph owns,
  ``fn`` is captured on a side stream, then replayed.
* Later calls: the inputs are copied into the static buffers (one launch a
  dtype, and one a caller array copied straight from its pages), the graph
  replays, and its outputs are cloned out (one launch a dtype) into fresh
  tensors, as ``jax.jit`` returns fresh arrays: a later
  replay never changes what an earlier call returned.  Because every
  replay is cloned out before the next one runs (replays are serialized on
  the calling stream), all graphs on a device share one memory pool.

The kernel wrappers count their launches in Python (ops/launches.py); a
replay calls no wrapper.  So each graph keeps the counters' growth over its
capture, takes it back (a capture launches nothing), and adds it on every
replay: the counters count the launches the card ran.

Eager, and only so: under ``disabled()`` (the counterpart of
``jax.disable_jit()``), on tensors off CUDA, and inside another capture.
The callers add inputs that need a gradient and device meshes.  A capture
or a replay that fails raises.

Memory.  What the graphs of a device hold (``held``: their pool's free
blocks, which are their working memory, and their static buffers) is
memory an eager call cannot use.  The cache gives it back when it is in
the way: an eager call that needs more than eager work can reach (``need``
bytes, from the working-set model of utils/device_memory.py, against
``device_budget(with_graphs=False)``), or a capture that needs more than
that and the pool's free blocks, which it reuses, first drops every graph
of its device (``release``: their keys are kept as seen, so each captures
again at its next call, with no eager warm-up) and empties the pool.  So utils/device_memory.device_budget counts what the
graphs hold as available: an AUTO chunk planned while graphs are held is
the one planned without them, and a replay runs in its own graph's
memory.  At most MAX_GRAPHS graphs are kept, the least recently used
evicted first.  A cap by count suffices because the pool is shared: an
evicted graph's packed outputs return to the pool, and a later capture
reuses the pool's free blocks; the pool goes back to the device at a
release or ``clear()``.  A capture cannot give blocks back to the device
as an eager call does, so its pool may hold more than the eager call's
peak: AUTO chunks plan for that (device_memory.CAPTURE_FACTOR).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import time
import weakref
from collections import OrderedDict

import torch

from ..parallel.mesh import tree_leaves, tree_map
from . import profiling

# Graphs kept at once (least recently used evicted first), and keys
# remembered as called once (eager so far)
MAX_GRAPHS = 8
MAX_SEEN = 1024

_enabled = [True]


@contextlib.contextmanager
def disabled():
    """Run every call eagerly inside the block (jax.disable_jit())."""
    prev, _enabled[0] = _enabled[0], False
    try:
        yield
    finally:
        _enabled[0] = prev


def signature(tensors) -> tuple:
    """(shape, dtype, device) of every tensor: the shape part of a key."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


def on_card(device) -> bool:
    """Whether a call on device may be captured: a CUDA device, and no
    capture under way (a call inside another capture is part of it)."""
    return device.type == "cuda" and not torch.cuda.is_current_stream_capturing()


def _device(device) -> torch.device:
    """device with its index (a CUDA device without one: the current)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _eager_room(device) -> float:
    from .device_memory import device_budget
    return device_budget(device, with_graphs=False)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# the states of a caller range (Pinned): loaded once, page-locked, refused
_SEEN, _LOCKED, _REFUSED = range(3)


class Pinned:
    """Caller arrays whose pages the card's DMA engine reads straight.

    An owner is the numpy array that holds a host input's memory (for
    run_radsurf's fields, the root of the caller's array's .base chain).
    The first load of a range of a live owner (its address and byte count)
    notes it and packs it as any other input.  When the same live owner
    brings the same range to a replay, the range is page-locked once
    (registrar.register: cudaHostRegister) and from then on copied straight
    from its pages into its slot of the graph's static buffer.  So a caller
    that keeps its field arrays and rewrites them every timestep pays the
    pack once; one that builds fresh arrays every call is packed every
    call, as is a fresh array at a freed array's address.

    A weakref.finalize on the owner unregisters its ranges before its
    memory is freed (numpy clears an array's weak references before it
    frees its data); an owner seen again over another buffer (resized in
    place) is unregistered and counts as new.  A range that overlaps one
    already locked, or that the registrar refuses, is packed from then on
    and counted (totals: registrations, registration_failures,
    registered_bytes)."""

    def __init__(self, registrar, totals):
        self.registrar, self.totals = registrar, totals
        self.owners = {}  # id(owner) -> [finalize, buffer, {range: state}]

    def sight(self, tensors, owners, device, replay) -> frozenset:
        """The positions of `tensors` to copy straight from their owners'
        pages at this load to `device`: none unless `replay`.  Notes every
        owned host range and, at a replay, locks those loaded before."""
        direct = set()
        for i, (t, owner) in enumerate(zip(tensors, owners)):
            if (owner is None or not _from_host(t, device) or not t.is_contiguous()
                    or not t.numel()):
                continue
            ranges = self._ranges(owner)
            span = (t.data_ptr(), t.numel() * t.element_size())
            state = ranges.get(span)
            if state is None:
                ranges[span] = _SEEN
            elif state == _SEEN and replay:
                state = ranges[span] = self._lock(span, owner)
            if state == _LOCKED:
                direct.add(i)
        return frozenset(direct)

    def _ranges(self, owner) -> dict:
        key, buffer = id(owner), (owner.__array_interface__["data"], owner.nbytes)
        rec = self.owners.get(key)
        alive = rec and rec[0].peek()
        if rec is not None and (not alive or alive[0] is not owner or rec[1] != buffer):
            self._drop(key)
            rec = None
        if rec is None:
            fin = weakref.finalize(owner, self._drop, key)
            fin.atexit = False  # the CUDA runtime may be gone at exit
            rec = self.owners[key] = [fin, buffer, {}]
        return rec[2]

    def _lock(self, span, owner) -> int:
        lo, hi = span[0], span[0] + span[1]
        locked = (r for rec in list(self.owners.values()) for r, st in rec[2].items()
                  if st == _LOCKED)
        if any(r[0] < hi and lo < r[0] + r[1] for r in locked) or not self.registrar.register(
                lo, span[1], read_only=owner.__array_interface__["data"][1]):
            self.totals["registration_failures"] += 1
            return _REFUSED
        self.totals["registrations"] += 1
        self.totals["registered_bytes"] += span[1]
        return _LOCKED

    def _drop(self, key):
        rec = self.owners.pop(key, None)
        if rec is None:
            return
        rec[0].detach()
        for (ptr, n), state in rec[2].items():
            if state == _LOCKED:
                self.registrar.unregister(ptr)
                self.totals["registered_bytes"] -= n

    def clear(self):
        """Unregister every range."""
        for key in list(self.owners):
            self._drop(key)


class PageLock:
    """cudaHostRegister / cudaHostUnregister through the CUDA runtime that
    PyTorch loaded (torch.cuda.cudart()), portable, read-only for a
    read-only array.  A refused call also leaves the runtime's last error
    set, which PyTorch's next kernel launch check would raise as its own:
    the runtime's cudaGetLastError (ctypes, on the library already loaded)
    clears it.  Where that function cannot be found, nothing is locked."""

    PORTABLE, READ_ONLY = 0x1, 0x8

    @functools.cached_property
    def _clear(self):
        """The runtime's cudaGetLastError, or None where it is not found."""
        major = (torch.version.cuda or "").split(".")[0]
        try:
            fn = ctypes.CDLL(f"libcudart.so.{major}", mode=os.RTLD_NOLOAD).cudaGetLastError
        except (OSError, AttributeError):
            return None
        fn.restype, fn.argtypes = ctypes.c_int, []
        return fn

    def register(self, ptr, nbytes, read_only) -> bool:
        if self._clear is None:
            return False
        flags = self.PORTABLE | (self.READ_ONLY if read_only else 0)
        if int(torch.cuda.cudart().cudaHostRegister(ptr, nbytes, flags)):
            self._clear()
            return False
        return True

    def unregister(self, ptr):
        # only a range register() locked comes here, so _clear was found
        if int(torch.cuda.cudart().cudaHostUnregister(ptr)):
            self._clear()


class Cache:
    """Graphs by key.  capture(fn, tensors, device, pool) captures a call
    and returns the callable that replays it (Graph); eligible(device) says
    where calls may be captured (on_card); room(device) is the bytes an
    eager call may plan to fill there without the graphs' memory;
    registrar page-locks caller memory (Pinned).  All four may be
    replaced, as the tests do to run the cache's logic without a card."""

    def __init__(self, capture=None, eligible=on_card, room=_eager_room,
                 max_graphs=MAX_GRAPHS, registrar=None):
        self.capture, self.eligible, self.room = capture, eligible, room
        self.max_graphs = max_graphs
        self.seen, self.graphs = OrderedDict(), OrderedDict()
        # device -> MemPool, its free bytes, the stream captures run on
        self.pools, self.pool_free, self.streams = {}, {}, {}
        self.totals = {"captures": 0, "replays": 0, "evictions": 0, "releases": 0,
                       "capture_s": 0.0, "h2d_bytes": 0, "h2d_loads": 0,
                       "h2d_direct_bytes": 0, "gather_bytes": 0, "registrations": 0,
                       "registration_failures": 0, "registered_bytes": 0}
        self.pinned = Pinned(registrar or PageLock(), self.totals)

    def call(self, key, fn, tensors, device=None, need=None, owners=None):
        """fn(*tensors on device), a pytree of tensors: eager at the first
        call of a key, captured then replayed at the second, replayed
        after.  need: the bytes fn allocates beyond its inputs (None:
        unknown), which decides whether the graphs' memory is given back
        before an eager call or a capture.  owners: per tensor, the numpy
        array that holds its memory, or None (Pinned)."""
        tensors = list(tensors)
        device = _device(tensors[0].device if device is None else device)
        if not _enabled[0] or not self.eligible(device):
            return fn(*move(tensors, device))
        key = (key, device, signature(tensors))
        graph = self.graphs.get(key)
        # a replay of a graph captured before copies the host inputs whose
        # owners it has loaded before straight from their pages
        direct = (self.pinned.sight(tensors, owners, device, replay=graph is not None)
                  if owners else frozenset())
        if graph is not None:
            self.graphs.move_to_end(key)
        elif key not in self.seen:
            self._make_room(device, need, self.room(device))
            self.seen[key] = None
            while len(self.seen) > MAX_SEEN:
                self.seen.popitem(last=False)
            return fn(*move(tensors, device))
        else:
            # a capture allocates in the pool, whose free blocks it reuses,
            # up to CAPTURE_FACTOR x what fn allocates, and holds its inputs
            from .device_memory import CAPTURE_FACTOR
            self._make_room(
                device, None if need is None else CAPTURE_FACTOR * need + _nbytes(tensors),
                self.room(device) + self.pool_free.get(device, 0))
            del self.seen[key]
            graph = self.graphs[key] = (self.capture or Graph)(
                fn, tensors, device, self._pool(device))
            self.totals["captures"] += 1
            self.totals["capture_s"] += graph.capture_s
            while len(self.graphs) > self.max_graphs:
                self.graphs.popitem(last=False)
                self.totals["evictions"] += 1
            self._measure(device)
        self.totals["replays"] += 1
        return graph(tensors, direct)

    def _make_room(self, device, need, room):
        """release(device) where its graphs hold memory and a call that
        needs `need` bytes (None: unknown) would not fit the `room` it has
        beside them."""
        if any(k[1] == device for k in self.graphs) and (need is None or need > room):
            self.release(device)

    def release(self, device):
        """Drop the graphs of device (their keys stay seen: each captures
        again at its next call) and give their pool back to the device."""
        for k in [k for k in self.graphs if k[1] == device]:
            del self.graphs[k]
            self.seen[k] = None
        self.pools.pop(device, None)
        self.pool_free.pop(device, None)
        self.totals["releases"] += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()

    def _pool(self, device):
        if device.type != "cuda":
            return None
        if device not in self.streams:
            # every capture on a device runs on one stream, since the
            # allocator hands a free block only to the stream it was taken
            # on; cuBLAS keeps a workspace per stream, taken at its first
            # product: taken in a capture, it would stay allocated in the
            # pool and keep the pool from going back to the device
            stream = self.streams[device] = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                for dt in (torch.float32, torch.float64):
                    x = torch.ones((2, 2, 2), dtype=dt, device=device)
                    torch.bmm(x, x), x[0] @ x[0]
            torch.cuda.current_stream(device).wait_stream(stream)
        if device not in self.pools:
            self.pools[device] = torch.cuda.MemPool()
        return self.pools[device], self.streams[device]

    def _measure(self, device):
        """Keep the free bytes of the graph pools on device: the segments
        of every pool but the default one ((0, 0)), less what is allocated
        in them.  They change only at a capture, an eviction or a release:
        a replay allocates nothing."""
        if device.type == "cuda":
            self.pool_free[device] = sum(
                seg["total_size"] - seg["allocated_size"]
                for seg in torch.cuda.memory_snapshot()
                if seg["device"] == device.index and tuple(seg["segment_pool_id"]) != (0, 0))

    def held(self, device) -> tuple:
        """(free bytes of the graph pool on device, bytes its graphs' static
        buffers hold)."""
        device = _device(device)
        return (self.pool_free.get(device, 0),
                sum(getattr(g, "held_bytes", 0) for k, g in self.graphs.items()
                    if k[1] == device))

    def clear(self):
        for device in {k[1] for k in self.graphs} | set(self.pools):
            self.release(device)
        self.seen.clear()
        self.pinned.clear()

    def stats(self) -> dict:
        moved = self.totals["h2d_bytes"]
        return {"graphs": len(self.graphs), "seen": len(self.seen), **self.totals,
                "h2d_direct_share": self.totals["h2d_direct_bytes"] / moved if moved else None,
                "held_bytes": sum(getattr(g, "held_bytes", 0) for g in self.graphs.values())}


_cache = Cache()


def call(key, fn, tensors, device=None, need=None, owners=None):
    """fn(*tensors), a pytree of tensors, through the process's graph cache.

    key: hashable, everything static that fn depends on besides the tensors
    (fn itself may be a new closure at every call); tensors: the inputs, on
    `device` (default: the first tensor's) or on the host; need: the bytes
    fn allocates beyond its inputs; owners: per tensor, the numpy array
    that holds a host tensor's memory (the tensor a zero-copy view of it),
    or None (Pinned).  See the module docstring for which call runs
    eagerly, which captures and which replays."""
    return _cache.call(key, fn, tensors, device, need, owners)


def stats() -> dict:
    """Graphs kept, keys seen once, and the captures, replays (the capturing
    call's included), evictions, releases and capture seconds since the
    process began; h2d_bytes and h2d_loads, the bytes moved from the host
    to the device by the loads of host inputs (_Flat.load: eager, capture
    and replay) and the number of those loads; h2d_direct_bytes, the part
    of h2d_bytes copied straight from callers' page-locked arrays (Pinned),
    and h2d_direct_share, that part's share of h2d_bytes (None before any
    load): the direct path's hit share; registrations and
    registration_failures, the ranges page-locked and refused since the
    process began, registered_bytes, the bytes page-locked now;
    gather_bytes, the bytes of the rows that run_radsurf's cores gathered
    from their whole fields (count(), on every route); held_bytes, what the
    graphs kept hold allocated (their static inputs and packed outputs)."""
    return _cache.stats()


def count(name: str, n):
    """Add n to the counter `name` of stats()."""
    _cache.totals[name] += n


def held(device) -> tuple:
    """(free bytes of the graph pool on device, bytes its graphs' static
    buffers hold): memory eager work cannot use until the graphs are
    released (utils/device_memory.device_budget)."""
    return _cache.held(device)


def clear():
    """Drop every graph, remembered key and page-locked caller range; give
    the pools' memory, and the allocator's other cached blocks, back to the
    devices."""
    _cache.clear()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _from_host(t, device) -> bool:
    return t.device.type == "cpu" and device.type == "cuda"


def _staging(n, dtype) -> torch.Tensor:
    """A pinned host buffer of n elements (the caching host allocator's)."""
    return torch.empty(n, dtype=dtype, pin_memory=True)


def _runs(items) -> list:
    """[(offset, numel)] of the runs of adjacent slots in (position,
    offset, numel) items."""
    runs = []
    for _, off, n in items:
        if runs and runs[-1][0] + runs[-1][1] == off:
            runs[-1][1] += n
        else:
            runs.append([off, n])
    return runs


class _Flat:
    """Tensors bound for `device` held as one contiguous buffer there per
    (dtype, whether the tensor comes from the host), each tensor a view
    into its buffer."""

    def __init__(self, tensors, device):
        self.device = device
        self.shapes = [tuple(t.shape) for t in tensors]
        self.groups = {}  # (dtype, from host) -> [(position, offset, numel)]
        sizes = {}
        for i, t in enumerate(tensors):
            g = (t.dtype, _from_host(t, device))
            off = sizes.get(g, 0)
            self.groups.setdefault(g, []).append((i, off, t.numel()))
            sizes[g] = off + t.numel()

    def load(self, tensors, out=None, direct=frozenset()) -> dict:
        """{group: one buffer on the device holding its tensors in order}
        (into `out`'s buffers where given).  A host group: the tensors at
        the positions `direct` (a replay's, Pinned) copied straight from
        their page-locked pages into their slots, the others packed in
        pinned memory (the span graphs.pack, which holds no device work)
        and moved with one transfer a run of adjacent slots; a device group
        with one copy.  The process's cache counts the bytes moved from the
        host, and of them those moved straight (stats())."""
        bufs, moved, straight = {}, 0, 0
        for g, items in self.groups.items():
            dst = None if out is None else out[g]
            if not g[1]:
                parts = [tensors[i].reshape(-1) for i, _, _ in items]
                bufs[g] = torch.cat(parts) if dst is None else torch.cat(parts, out=dst)
                continue
            if dst is None:
                dst = torch.empty(sum(n for _, _, n in items), dtype=g[0], device=self.device)
            packed = []
            for i, off, n in items:
                if i in direct:
                    dst[off:off + n].copy_(tensors[i].reshape(-1), non_blocking=True)
                    straight += n * dst.element_size()
                else:
                    packed.append((i, off, n))
            if packed:
                with profiling.hook("graphs.pack"):
                    staged = torch.cat([tensors[i].reshape(-1) for i, _, _ in packed],
                                       out=_staging(sum(n for _, _, n in packed), g[0]))
                at = 0
                for off, n in _runs(packed):
                    dst[off:off + n].copy_(staged[at:at + n], non_blocking=True)
                    at += n
            bufs[g] = dst
            moved += dst.numel() * dst.element_size()
        if moved:
            _cache.totals["h2d_bytes"] += moved
            _cache.totals["h2d_direct_bytes"] += straight
            _cache.totals["h2d_loads"] += 1
        return bufs

    def views(self, bufs) -> list:
        out = [None] * len(self.shapes)
        for g, items in self.groups.items():
            for i, off, n in items:
                out[i] = bufs[g][off:off + n].view(self.shapes[i])
        return out


def move(tensors, device) -> list:
    """tensors on device: those on the host moved with one transfer a dtype
    (_Flat; each a view of its dtype's buffer), the others as they are."""
    device = torch.device(device)
    host = [i for i, t in enumerate(tensors) if _from_host(t, device)]
    if not host:
        return list(tensors)
    part = [tensors[i] for i in host]
    flat = _Flat(part, device)
    out = list(tensors)
    for i, v in zip(host, flat.views(flat.load(part))):
        out[i] = v
    return out


class Graph:
    """One captured call: static input buffers, the CUDA graph, its packed
    outputs and the launch counters' growth over its capture.  pool:
    (the torch.cuda.MemPool it allocates in, the stream it is captured
    on)."""

    def __init__(self, fn, tensors, device, pool):
        from ..ops import launches

        self.device = device
        self.inputs = _Flat(tensors, device)
        mempool, stream = pool
        with torch.cuda.device(device):
            self.static_in = self.inputs.load(tensors)
            before = launches.counts()
            t0 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=mempool.id, stream=stream):
                out = fn(*self.inputs.views(self.static_in))
                leaves = tree_leaves(out)
                bad = [type(x).__name__ for x in leaves if not isinstance(x, torch.Tensor)]
                if bad:
                    raise TypeError(f"a captured call returned non-tensor leaves: {bad}")
                self.outputs = _Flat(leaves, device)
                self.static_out = self.outputs.load(leaves)
                del leaves
            self.tree = tree_map(lambda _: 0, out)
            del out
            self.capture_s = time.perf_counter() - t0
        self.held_bytes = _nbytes([*self.static_in.values(), *self.static_out.values()])
        after = launches.counts()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        launches.add({k: -n for k, n in self.launches.items()})

    def __call__(self, tensors, direct=frozenset()):
        """A replay on `tensors`; direct: the positions copied straight from
        their callers' pages (Pinned), which are read before it returns, as
        a packed input is: the host waits for those copies only after the
        graph and the clones of its outputs are queued."""
        from ..ops import launches

        with torch.cuda.device(self.device):
            self.inputs.load(tensors, out=self.static_in, direct=direct)
            read = torch.cuda.Event()
            if direct:
                read.record()
            self.graph.replay()
            fresh = {g: b.clone() for g, b in self.static_out.items()}
            if direct:
                read.synchronize()
        launches.add(self.launches)
        it = iter(self.outputs.views(fresh))
        return tree_map(lambda _: next(it), self.tree)
