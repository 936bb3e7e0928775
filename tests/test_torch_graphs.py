"""The port's compiled programs (utils/graphs.py): spartacus_sw /
spartacus_lw on the kernel route and run_radsurf's device core, each a
CUDA graph per static key, captured at the second call and replayed after.

On the CPU the cache's logic runs with its capture replaced (FakeGraph:
the call captured is run again on copies of the inputs), so the keys, the
eviction, the release of a device's graphs for a call that needs their
memory, the budget that counts that memory as available, and the split of
run_radsurf into a host plan and a device core are held here; the split run_radsurf is also held to jitted JAX
run_radsurf at 1e-9 in float64 on all six tile codes, SW + LW, flux
profiles on.  The kernel routes and the core move no numpy constant to the
device once their constants are cached (utils/transfer.constant), which is
what makes them capturable.  Host inputs copied straight from their
callers' pages (Pinned) run with the page lock stubbed (StubLock): which
load packs and which copies straight, the counters, the unregistration
when an owner dies and at clear().

Marked cuda (skipped without a GPU): on the card a replay is bit-equal to
the eager call, a call with new inputs gives the new answer and leaves an
earlier call's outputs as they were, the launch counters grow by the
captured counts at every replay, and an AUTO call on a squeezed card
after a capture picks the chunks it picks with no graph held; a replay fed
straight from the caller's pages is bit-equal to a packed one and has read
them when it returns, and a lock ends with its owner.
"""

import numpy as np
import pytest
import torch

from spartacus_surface_tpu_torch.models import dispatch
from spartacus_surface_tpu_torch.models import solver as TS
from spartacus_surface_tpu_torch.ops import launches
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss
from spartacus_surface_tpu_torch.utils import device_memory as DM
from spartacus_surface_tpu_torch.utils import graphs, transfer
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.inputs import example_arrays, example_inputs

GROUPS = ("sw_norm_dir", "sw_norm_diff", "lw_internal", "lw_norm", "bc_out")
CPU = torch.device("cpu")


class FakeGraph:
    """A capture without a card: the call is run on copies of the inputs
    at capture and again at every replay, after the new inputs are copied
    in, as a CUDA graph replays on its static inputs.  Calls made inside
    are not eligible, as inside a capture (graphs.on_card); a replay runs
    no Python at all."""

    inside = False

    def __init__(self, fn, tensors, device, pool):
        self.fn, self.capture_s, self.launches = fn, 0.0, {}
        self.static = [t.clone() for t in tensors]
        self.run()

    def run(self):
        FakeGraph.inside = True
        try:
            return self.fn(*self.static)
        finally:
            FakeGraph.inside = False

    def __call__(self, tensors, direct=frozenset()):
        self.direct = direct
        for s, t in zip(self.static, tensors):
            s.copy_(t)
        return self.run()


@pytest.fixture
def fake_cache(monkeypatch):
    """The process's graph cache replaced by one that captures CPU calls
    with FakeGraph."""
    cache = graphs.Cache(capture=FakeGraph, max_graphs=64,
                         eligible=lambda device: not FakeGraph.inside)
    monkeypatch.setattr(graphs, "_cache", cache)
    return cache


def canopy(C=12, L=3, S=2, dtype=np.float64, lw=False, seed=3):
    fields = example_inputs(C=C, L=L, S=S, dtype=dtype, seed=seed, lw=lw)
    return TS.CanopyInputs(**{k: torch.as_tensor(v) for k, v in fields.items()})


def leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    items = out.items() if isinstance(out, dict) else enumerate(out)
    return [t for _, v in sorted(items, key=lambda kv: str(kv[0])) for t in leaves(v)]


def assert_equal(ref, got):
    ref, got = leaves(ref), leaves(got)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert r.shape == g.shape and torch.equal(r, g)


# ----------------------------------------------------------------------
# the cache's logic, on the CPU
# ----------------------------------------------------------------------

def test_cache_key_distinguishes_everything_static(fake_cache):
    """One graph per options, nstream, with_profiles, dtype, shape and
    resolved column chunk; each replay equals the eager call."""
    opt = lambda **kw: TS.SolverOptions(**{"nreg": 2, "nstream": 4, "do_urban": True, **kw})
    lg4, lg2 = LegendreGauss(4), LegendreGauss(2)
    variants = {
        "base": (TS.spartacus_sw, canopy(), opt(), lg4, False),
        "options": (TS.spartacus_sw, canopy(), opt(n_double=20), lg4, False),
        "nstream": (TS.spartacus_sw, canopy(), opt(nstream=2), lg2, False),
        "profiles": (TS.spartacus_sw, canopy(), opt(), lg4, True),
        "dtype": (TS.spartacus_sw, canopy(dtype=np.float32), opt(), lg4, False),
        "shape": (TS.spartacus_sw, canopy(C=10), opt(), lg4, False),
        "chunk": (TS.spartacus_sw, canopy(), opt(column_chunk=12), lg4, False),
        "lw": (TS.spartacus_lw, canopy(lw=True), opt(), lg4, False),
    }
    for n, (solve, inp, o, lg, prof) in enumerate(variants.values(), start=1):
        with graphs.disabled():
            ref = solve(inp, o, lg, with_profiles=prof)
        for _ in range(3):  # eager, captured, replayed
            assert_equal(ref, solve(inp, o, lg, with_profiles=prof))
        assert len(fake_cache.graphs) == n
    assert fake_cache.totals["captures"] == len(variants)
    assert fake_cache.totals["replays"] == 2 * len(variants)
    # the resolved chunk keys the graph: 0 and 12 on the same 12 columns
    # are two graphs of one input signature
    (base, _, sig_base), (chunk, _, sig_chunk) = (list(fake_cache.graphs)[i] for i in (0, 6))
    assert sig_base == sig_chunk and base != chunk
    assert (base[1].column_chunk, chunk[1].column_chunk) == (0, 12)


def test_chunks_replay_one_graph_per_chunk_shape(fake_cache):
    """A chunked solve: one graph per chunk shape, the ragged last chunk
    its own; the result equals the unchunked eager solve."""
    inp = canopy(C=10)
    o = TS.SolverOptions(nreg=2, nstream=4, do_urban=True, column_chunk=4)
    with graphs.disabled():
        ref = TS.spartacus_sw(inp, TS.SolverOptions(nreg=2, nstream=4, do_urban=True),
                              LegendreGauss(4))
    for _ in range(3):
        got = TS.spartacus_sw(inp, o, LegendreGauss(4))
    for r, g in zip(leaves(ref), leaves(got)):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-13)
    sizes = sorted(sig[0][0][0] for _, _, sig in fake_cache.graphs)
    assert sizes == [2, 4]


def test_cache_bound_and_eviction():
    """At most max_graphs graphs, the least recently used evicted first; an
    evicted key starts again from an eager call."""
    cache = graphs.Cache(capture=FakeGraph, eligible=lambda device: True, max_graphs=2)
    x = torch.arange(4.0)
    fn = lambda t: {"y": t * 2.0}
    run = lambda key: cache.call(key, fn, [x], need=0)
    for key in ("a", "a", "b", "b"):
        run(key)
    assert [k for k, _, _ in cache.graphs] == ["a", "b"]
    run("a")  # a replay makes "a" the most recent
    run("c"), run("c")  # "c" captured: "b" goes
    assert [k for k, _, _ in cache.graphs] == ["a", "c"]
    assert cache.totals["evictions"] == 1
    captures = cache.totals["captures"]
    run("b")  # seen again: eager
    assert cache.totals["captures"] == captures and ("b", x.device, graphs.signature([x])) in cache.seen
    run("b")
    assert cache.totals["captures"] == captures + 1
    assert [k for k, _, _ in cache.graphs] == ["c", "b"]
    torch.testing.assert_close(run("b")["y"], x * 2.0)


def test_graphs_give_their_memory_back_to_a_call_that_needs_it():
    """An eager call that needs more than eager work can reach (room), or
    a capture that needs more than that and the pool's free blocks, first
    releases its device's graphs, whose keys then capture again at once; a
    call that fits, and a replay, release nothing."""
    room = [100]
    cache = graphs.Cache(capture=FakeGraph, eligible=lambda device: True,
                         room=lambda device: room[0])
    x = torch.arange(4.0)
    fn = lambda t: {"y": t * 2.0}
    run = lambda key, need: cache.call(key, fn, [x], need=need)
    run("a", 10), run("a", 10)  # eager, captured
    run("b", 90)  # fits beside a's graph
    assert len(cache.graphs) == 1 and cache.totals["releases"] == 0
    room[0] = 40
    run("a", 1000)  # a replay runs in its own graph's memory
    assert cache.totals["releases"] == 0
    captures = cache.totals["captures"]
    run("c", 50)  # eager and short: a's graph goes
    assert not cache.graphs and cache.totals["releases"] == 1
    assert ("a", x.device, graphs.signature([x])) in cache.seen
    torch.testing.assert_close(run("a", 10)["y"], x * 2.0)  # captured at once
    assert cache.totals["captures"] == captures + 1
    # a capture takes CAPTURE_FACTOR x what fn allocates (1.6 x 20) and
    # its inputs (16 bytes) in the pool: 48 bytes fit 40 and the pool's 10
    # free, so b's capture keeps a's graph ...
    cache.pool_free[x.device] = 10
    run("b", 20)
    assert [k for k, _, _ in cache.graphs] == ["a", "b"] and cache.totals["releases"] == 1
    # ... and do not fit 40 alone, so c's capture releases a's and b's
    cache.pool_free[x.device] = 0
    run("c", 20)
    assert [k for k, _, _ in cache.graphs] == ["c"] and cache.totals["releases"] == 2
    run("d", None)  # need unknown: released
    assert not cache.graphs and cache.totals["releases"] == 3


def test_auto_chunk_does_not_change_when_graphs_hold_memory(monkeypatch):
    """device_budget counts the graphs' pool and buffers as available (a
    replay runs in them; an eager call gets them back), so an AUTO chunk
    planned while a capture holds 6 of the card's 10 free GiB is the one
    planned before the capture.  Counted as taken, they would shrink it."""
    GiB = 2**30
    mem = {"free": 10 * GiB, "reserved": 0, "allocated": 0, "held": (0, 0)}
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (mem["free"], 80 * GiB))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: mem["reserved"])
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: mem["allocated"])
    monkeypatch.setattr(graphs, "held", lambda d: mem["held"])
    dev = torch.device("cuda", 0)
    opt = TS.SolverOptions(nreg=2, nstream=4, do_urban=True, column_chunk=-1)
    lg = LegendreGauss(4)
    C, L, S = 300_000, 8, 1
    # the working set of C columns is more than the budget: AUTO chunks
    assert DM.solve_bytes(C, L, S, 2, 4, 8)[0] > DM.device_budget(dev)

    def chunk():
        return TS._resolve_column_chunk(opt, lg, C, L, S, torch.float64, dev,
                                        lw=False, route="kernel")
    before = chunk(), DM.device_budget(dev)
    # a capture: 4 GiB of free blocks in the pool, 2 GiB of static buffers
    mem.update(free=4 * GiB, reserved=6 * GiB, allocated=2 * GiB, held=(4 * GiB, 2 * GiB))
    assert (chunk(), DM.device_budget(dev)) == before
    assert DM.device_budget(dev, with_graphs=False) == DM.BUDGET_SHARE * 4 * GiB - DM.BUDGET_RESERVE
    assert TS._resolve_column_chunk(opt, lg, C, L, S, torch.float64, dev, lw=False,
                                    route="kernel",
                                    budget=DM.device_budget(dev, with_graphs=False)) < before[0]


def test_auto_chunk_on_cuda_plans_for_the_capture():
    """On CUDA an AUTO chunk plans for CAPTURE_FACTOR x a solve's
    transient bytes (its capture cannot give blocks back to the device);
    on the CPU, which captures nothing, for the transient."""
    opt = TS.SolverOptions(nreg=2, nstream=4, do_urban=True, column_chunk=-1)
    C, L, S = 20_000, 8, 1
    transient = DM.solve_bytes(C, L, S, 2, 4, 8)[0]
    budget = transient * (1 + DM.CAPTURE_FACTOR) / 2
    chunk = {d: TS._resolve_column_chunk(opt, LegendreGauss(4), C, L, S, torch.float64,
                                         torch.device(d), lw=False, route="kernel",
                                         budget=budget) for d in ("cpu", "cuda")}
    assert chunk["cpu"] == 0 and 0 < chunk["cuda"] < C


def test_eager_under_disabled_and_off_card(monkeypatch):
    """graphs.disabled() and CPU tensors run eagerly with the process's
    cache, which captures nothing."""
    calls = []
    fn = lambda t: calls.append(1) or {"y": t + 1.0}
    x = torch.zeros(3)
    for _ in range(3):
        graphs.call(("test", "off card"), fn, [x])
    cache = graphs.Cache(capture=FakeGraph, eligible=lambda device: True)
    with graphs.disabled():
        for _ in range(3):
            cache.call("k", fn, [x])
    assert len(calls) == 6 and not cache.graphs and not cache.seen


def test_flat_buffers_round_trip():
    """_Flat packs tensors of several dtypes into one buffer a dtype (one
    copy each) and gives them back as views; packing into the buffers
    again overwrites them in place."""
    a = torch.arange(12.0, dtype=torch.float64).reshape(3, 4)
    ts = [a.t(), torch.arange(5), torch.tensor([True, False]),
          torch.ones(2, 2, dtype=torch.float32), a[1], torch.zeros(0)]
    flat = graphs._Flat(ts, torch.device("cpu"))
    bufs = flat.load(ts)
    assert {dt: b.numel() for (dt, _), b in bufs.items()} == {
        torch.float64: 16, torch.int64: 5, torch.bool: 2, torch.float32: 4}
    for t, v in zip(ts, flat.views(bufs)):
        assert torch.equal(t, v) and v.is_contiguous()
    ptrs = {g: b.data_ptr() for g, b in bufs.items()}
    new = [t + 1 if t.dtype != torch.bool else ~t for t in ts]
    again = flat.load(new, out=bufs)
    assert {g: b.data_ptr() for g, b in again.items()} == ptrs
    for t, v in zip(new, flat.views(bufs)):
        assert torch.equal(t, v)


# ----------------------------------------------------------------------
# host inputs copied straight from their callers' pages (Pinned)
# ----------------------------------------------------------------------

class StubLock:
    """A registrar without a card: the ranges it holds locked ({address:
    bytes}), and what it was asked, in order; refuses every range while
    `refuse` is set."""

    def __init__(self):
        self.locked, self.events, self.refuse = {}, [], False

    def register(self, ptr, nbytes, read_only):
        self.events.append(("register", ptr, nbytes, read_only))
        if self.refuse:
            return False
        self.locked[ptr] = nbytes
        return True

    def unregister(self, ptr):
        self.events.append(("unregister", ptr))
        del self.locked[ptr]


@pytest.fixture
def pages(monkeypatch):
    """The process's graph cache replaced by one with a StubLock (returned)
    that captures with FakeGraph; CPU tensors load as host inputs of a card
    (the CPU stands for the card, a plain buffer for the pinned one)."""
    lock = StubLock()
    cache = graphs.Cache(capture=FakeGraph, registrar=lock,
                         eligible=lambda device: not FakeGraph.inside)
    monkeypatch.setattr(graphs, "_cache", cache)
    monkeypatch.setattr(graphs, "_from_host", lambda t, device: t.device.type == "cpu")
    monkeypatch.setattr(graphs, "_staging", lambda n, dtype: torch.empty(n, dtype=dtype))
    yield lock
    cache.clear()


def owned(seed=0):
    """Two caller arrays (float64, float32) and the call's tensors: each
    array zero-copy, then an index built anew (no owner)."""
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(size=(4, 3)), rng.uniform(size=5).astype(np.float32)
    return [a, b], [torch.as_tensor(a), torch.as_tensor(b), torch.arange(3)]


def test_first_sighting_packs_and_a_replay_of_a_live_array_copies_straight(pages):
    """A key's eager call and its capture note the owners; the first replay
    locks each owned range once and copies it straight, and so does every
    replay after; the index, with no owner, is packed every time."""
    arrays, ts = owned()
    fn = lambda a, b, i: {"y": a.sum() + b.sum() + i.sum()}
    graphs.call("k", fn, ts, owners=[*arrays, None])  # eager
    graphs.call("k", fn, ts, owners=[*arrays, None])  # captured, replayed
    (graph,) = graphs._cache.graphs.values()
    assert graph.direct == frozenset() and not pages.locked
    for _ in range(2):
        got = graphs.call("k", fn, ts, owners=[*arrays, None])
        assert graph.direct == {0, 1}
    assert pages.locked == {a.ctypes.data: a.nbytes for a in arrays}
    assert [e[0] for e in pages.events] == ["register", "register"]
    assert [e[3] for e in pages.events] == [False, False]  # both writeable
    assert torch.equal(got["y"], fn(*ts)["y"])
    stats = graphs.stats()
    assert (stats["registrations"], stats["registration_failures"]) == (2, 0)
    assert stats["registered_bytes"] == sum(a.nbytes for a in arrays)


def test_straight_and_packed_loads_move_the_same_bytes(pages):
    """A load with some positions copied straight fills the same buffers
    with the same bits as a packed load, counts the same h2d_bytes, and
    counts exactly the straight positions' bytes as h2d_direct_bytes; the
    packed positions left between them are copied run by run."""
    cache = graphs._cache
    arrays, ts = owned(seed=1)
    c, d = np.arange(7.0), np.arange(3.0) - 5
    # float64 slots: c, a, d (two packed runs around a straight copy)
    ts = [torch.as_tensor(c), ts[0], torch.as_tensor(d), ts[1], ts[2]]
    flat = graphs._Flat(ts, CPU)
    before = dict(cache.totals)
    packed = flat.load(ts)
    mid = dict(cache.totals)
    out = {g: torch.full_like(b, -1) for g, b in packed.items()}
    straight = flat.load(ts, out=out, direct=frozenset({1, 3}))
    after = cache.totals
    assert mid["h2d_bytes"] - before["h2d_bytes"] == after["h2d_bytes"] - mid["h2d_bytes"] \
        == sum(t.numel() * t.element_size() for t in ts)
    assert mid["h2d_direct_bytes"] == before["h2d_direct_bytes"]
    assert after["h2d_direct_bytes"] - mid["h2d_direct_bytes"] == arrays[0].nbytes + arrays[1].nbytes
    assert after["h2d_loads"] - before["h2d_loads"] == 2
    for g in packed:
        assert torch.equal(packed[g], straight[g]) and straight[g] is out[g]
    for t, v in zip(ts, flat.views(straight)):
        assert torch.equal(t, v)
    assert graphs._runs([(1, 7, 2), (3, 9, 1), (4, 12, 3)]) == [[7, 3], [12, 3]]


def test_a_fresh_array_at_a_freed_arrays_address_packs_again(pages):
    """An owner that dies is unregistered; another array over the same
    memory is a first sighting (packed), then locked at its next replay."""
    pinned = graphs._cache.pinned
    mem = np.arange(16.0)
    t = [torch.as_tensor(mem)]
    owner = mem.view()
    for replay, direct in ((False, set()), (True, {0}), (True, {0})):
        assert pinned.sight(t, [owner], CPU, replay) == direct
    del owner
    assert not pages.locked and graphs.stats()["registered_bytes"] == 0
    owner = mem.view()  # a new array at the freed one's address
    assert pinned.sight(t, [owner], CPU, True) == frozenset()
    assert pinned.sight(t, [owner], CPU, True) == {0}
    assert graphs.stats()["registrations"] == 2


def test_the_registration_goes_before_the_owners_memory(pages):
    """The owner's weakref.finalize unregisters its range before the
    owner releases the memory it views (numpy clears weak references first)."""
    import weakref

    pinned = graphs._cache.pinned
    holder = np.arange(32.0)
    weakref.finalize(holder, pages.events.append, ("memory freed",))
    owner = np.frombuffer(holder)  # holds the only reference to holder
    t = [torch.as_tensor(owner)]
    pinned.sight(t, [owner], CPU, False), pinned.sight(t, [owner], CPU, True)
    del holder, t, owner
    assert [e[0] for e in pages.events] == ["register", "unregister", "memory freed"]
    assert not pinned.owners


def test_a_refused_registration_packs_and_is_counted(pages):
    """A range the registrar refuses, or one overlapping a locked range, is
    packed at every later load, counted once, and never asked again; a
    read-only owner asks for a read-only lock."""
    pinned = graphs._cache.pinned
    mem = np.arange(64.0)
    t = [torch.as_tensor(mem[:32])]
    mem.flags.writeable = False
    pages.refuse = True
    for _ in range(4):
        assert pinned.sight(t, [mem], CPU, True) == frozenset()
    assert [e[0] for e in pages.events] == ["register"] and pages.events[0][3] is True
    pages.refuse = False
    other = np.arange(64.0)
    u = [torch.as_tensor(other)]
    pinned.sight(u, [other], CPU, True), pinned.sight(u, [other], CPU, True)
    view = other.view()  # a second owner over locked memory: refused here
    for _ in range(3):
        assert pinned.sight(u, [view], CPU, True) == frozenset()
    stats = graphs.stats()
    assert (stats["registrations"], stats["registration_failures"]) == (1, 2)
    assert len(pages.events) == 2


def test_clear_unregisters_everything(pages):
    """graphs.clear() unregisters every range and forgets every owner; an
    owner dying after it asks for nothing."""
    arrays, ts = owned()
    pinned = graphs._cache.pinned
    for replay in (False, True):
        pinned.sight(ts, [*arrays, None], CPU, replay)
    assert len(pages.locked) == 2
    graphs.clear()
    assert not pages.locked and not pinned.owners
    assert graphs.stats()["registered_bytes"] == 0
    events = len(pages.events)
    del arrays, ts
    assert len(pages.events) == events


def test_run_radsurf_names_the_owner_of_each_zero_copy_field(pages):
    """run_radsurf's compiled call names, per tensor, the root array of a
    field passed as it is, and no owner for a cast field or the indices;
    its third call with the same arrays copies those fields straight and
    gives the same answer."""
    cfg = Config(do_lw=True, nsw=2, nlw=2).consolidate()
    arrays = example_arrays(C=18, L=3, S=2, dtype=np.float64)
    big = np.stack([arrays["veg_ext"], arrays["veg_ext"]])
    arrays["veg_ext"] = big[1]  # a view: its owner is big
    arrays["veg_scale"] = arrays["veg_scale"].astype(np.float32)  # cast at every call
    plan, payload = dispatch._plan(cfg, arrays, torch.device("cpu"), "kernel", None,
                                   host=True)
    tensors = dispatch.tree_leaves(payload)
    owners = dispatch._owners(arrays, payload["fields"], tensors)
    fields = payload["fields"]
    want = {k: (big if k == "veg_ext" else None if k == "veg_scale" else arrays[k])
            for k in fields}
    for k, t in fields.items():
        assert owners[[id(x) for x in tensors].index(id(t))] is want[k], k
    assert sum(o is not None for o in owners) == len(fields) - 1
    ref = dispatch.run_radsurf(cfg, arrays, "cpu")
    for _ in range(2):
        got = dispatch.run_radsurf(cfg, arrays, "cpu")
    (graph,) = graphs._cache.graphs.values()
    assert len(graph.direct) == len(fields) - 1
    assert_equal({g: ref[g] for g in GROUPS}, {g: got[g] for g in GROUPS})


# ----------------------------------------------------------------------
# no constant moved once cached
# ----------------------------------------------------------------------

@pytest.fixture
def numpy_moves(monkeypatch):
    """Count transfer.to_device calls and torch.as_tensor calls on numpy
    data; returns the count list."""
    moved = []
    to_device, as_tensor = transfer.to_device, torch.as_tensor

    def count_to_device(x, *a, **k):
        moved.append(("to_device", np.shape(x)))
        return to_device(x, *a, **k)

    def count_as_tensor(x, *a, **k):
        if isinstance(x, (np.ndarray, np.generic, list, tuple)):
            moved.append(("as_tensor", np.shape(x)))
        return as_tensor(x, *a, **k)

    monkeypatch.setattr(transfer, "to_device", count_to_device)
    monkeypatch.setattr(dispatch, "to_device", count_to_device)
    monkeypatch.setattr(torch, "as_tensor", count_as_tensor)
    return moved


@pytest.mark.parametrize("lw", [False, True], ids=["sw", "lw"])
def test_kernel_route_moves_no_constant(lw, numpy_moves):
    inp = canopy(lw=lw)
    opt = TS.SolverOptions(nreg=2, nstream=4, do_urban=True)
    solve = TS.spartacus_lw if lw else TS.spartacus_sw
    with graphs.disabled():
        solve(inp, opt, LegendreGauss(4), with_profiles=True)  # caches them
        numpy_moves.clear()
        solve(inp, opt, LegendreGauss(4), with_profiles=True)
    assert numpy_moves == []


def test_run_radsurf_core_moves_no_constant(numpy_moves):
    """The core moves nothing to the device; the host plan moves the fields
    and indices."""
    cfg = Config(do_lw=True, nsw=2, nlw=2, do_save_flux_profile=True).consolidate()
    arrays = example_arrays(C=12, L=3, S=2, dtype=np.float64)
    with graphs.disabled():
        dispatch.run_radsurf(cfg, arrays, "cpu")  # caches the constants
        plan, payload = dispatch._plan(cfg, arrays, torch.device("cpu"), "kernel", None)
        assert numpy_moves
        numpy_moves.clear()
        dispatch._core(plan, payload)
    assert numpy_moves == []


# ----------------------------------------------------------------------
# the split run_radsurf against jitted JAX
# ----------------------------------------------------------------------

def test_split_run_radsurf_matches_jax(fake_cache):
    """run_radsurf's host plan and device core, eager, captured and
    replayed through the cache, each equal to jitted JAX run_radsurf at
    1e-9 (float64, all six tile codes, SW + LW, flux profiles on); the
    core is one graph."""
    jdispatch = pytest.importorskip("spartacus_surface_tpu.models.dispatch")
    jconfig = pytest.importorskip("spartacus_surface_tpu.utils.config")
    arrays = example_arrays(C=18, L=3, S=2, dtype=np.float64)
    arrays["cos_sza"][[3, 4]] = -0.2  # a vegetated urban and a simple urban column at night
    assert set(arrays["i_representation"]) == set(range(6))
    kw = dict(do_lw=True, nsw=2, nlw=2, do_save_flux_profile=True)
    ref = jdispatch.run_radsurf(jconfig.Config(**kw).consolidate(), arrays)
    cfg = Config(**kw).consolidate()
    for _ in range(3):  # eager, captured, replayed
        got = dispatch.run_radsurf(cfg, arrays, "cpu")
        worst = 0.0
        for g in GROUPS:
            assert set(ref[g]) == set(got[g]), set(ref[g]) ^ set(got[g])
            for k in ref[g]:
                r, x = np.asarray(ref[g][k]), got[g][k].numpy()
                assert r.shape == x.shape and np.isfinite(x).all(), (g, k)
                worst = max(worst, np.abs(r - x).max() / max(1.0, np.abs(r).max()))
        assert worst < 1e-9
    assert [type(k) for k, _, _ in fake_cache.graphs] == [dispatch.Plan]  # nothing nested


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    graphs.clear()
    yield torch.device("cuda")
    graphs.clear()


def _calls(device):
    """(name, fn(seed) -> outputs) of the compiled programs at small
    shapes: the SW and LW kernel routes and run_radsurf on mixed tiles."""
    opt = TS.SolverOptions(nreg=2, nstream=4, do_urban=True)
    lg = LegendreGauss(4)
    cfg = Config(do_lw=True, nsw=2, nlw=2, do_save_flux_profile=True).consolidate()

    def on(seed, lw):
        inp = canopy(C=300, L=4, S=2, lw=lw, seed=seed)
        return TS.CanopyInputs(**{k: v.to(device) for k, v in inp.tensors()})
    return {
        "sw": lambda seed: TS.spartacus_sw(on(seed, False), opt, lg, with_profiles=True),
        "lw": lambda seed: TS.spartacus_lw(on(seed, True), opt, lg),
        "run_radsurf": lambda seed: dispatch.run_radsurf(
            cfg, example_arrays(C=360, L=4, S=2, dtype=np.float64, seed=seed), device),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sw", "lw", "run_radsurf"])
def test_cuda_replay_equals_eager_and_outputs_are_fresh(cuda_device, name):
    fn = _calls(cuda_device)[name]
    with graphs.disabled():
        ref1, ref2 = fn(1), fn(2)
    first = fn(1)  # eager
    assert_equal(ref1, first)
    captured = fn(1)  # captured, then replayed
    assert graphs.stats()["graphs"] == 1
    assert_equal(ref1, captured)
    kept = [t.clone() for t in leaves(captured)]
    replayed = fn(2)  # new inputs: the new answer
    assert_equal(ref2, replayed)
    assert not all(torch.equal(a, b) for a, b in zip(leaves(ref1), leaves(ref2)))
    for k, t in zip(kept, leaves(captured)):  # the earlier outputs unchanged
        assert torch.equal(k, t)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sw", "lw", "run_radsurf"])
def test_cuda_counters_grow_by_the_captured_launches(cuda_device, name):
    fn = _calls(cuda_device)[name]
    launches.reset()
    fn(1)
    eager = launches.counts()
    fn(1)  # captured and replayed once
    (graph,) = graphs._cache.graphs.values()
    assert graph.launches == {k: n for k, n in eager.items() if n}
    kernels = ("K1", "K4", "K5") if name == "lw" else (
        ("K1", "K2", "K3") if name == "sw" else launches.PATH_4)
    assert all(graph.launches.get(k, 0) > 0 for k in kernels), graph.launches
    for _ in range(3):
        before = launches.counts()
        fn(1)
        after = launches.counts()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == graph.launches


@pytest.mark.cuda
def test_cuda_squeezed_auto_call_after_a_capture(cuda_device):
    """A capture at one shape, then run_radsurf with an AUTO chunk at
    another on a card a ballast has squeezed below what the first graph
    holds: the call picks the chunks it picks with no graph held, gives
    the graph's memory back for its eager run, and equals the eager answer."""
    GiB = 2**30
    cfg = Config(do_lw=True, column_chunk=-1).consolidate()
    big = example_arrays(C=49152, L=8, S=1, dtype=np.float64)
    arrays = example_arrays(C=65536, L=8, S=1, dtype=np.float64, seed=2)
    work = dispatch.working_set_bytes(cfg, arrays["i_representation"], 8, 8)
    dispatch.run_radsurf(cfg, big, cuda_device)
    dispatch.run_radsurf(cfg, big, cuda_device)  # captured
    assert graphs.stats()["graphs"] == 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # a ballast leaves a budget of 3/4 of the call's one-shot working set,
    # the graph's memory counted as available
    target = 0.75 * work
    ballast = torch.empty(int(
        (DM.device_budget(cuda_device) - target) / DM.BUDGET_SHARE), dtype=torch.uint8,
        device=cuda_device)
    assert DM.device_budget(cuda_device) == pytest.approx(target, rel=0.02)
    assert DM.device_budget(cuda_device, with_graphs=False) < 0.5 * work

    def picked():
        chunks, resolve = [], TS._resolve_column_chunk

        def rec(*a, **k):
            chunks.append(resolve(*a, **k))
            return chunks[-1]
        TS._resolve_column_chunk = rec
        try:
            out = dispatch.run_radsurf(cfg, arrays, cuda_device)
        finally:
            TS._resolve_column_chunk = resolve
        return chunks, [t.cpu() for t in leaves({g: out[g] for g in GROUPS})]
    releases = graphs.stats()["releases"]
    held, got = picked()
    assert graphs.stats()["releases"] > releases  # the graph made room
    assert any(ck > 0 for ck in held)
    graphs.clear()
    fresh, ref = picked()
    assert held == fresh
    for r, g in zip(ref, got):
        assert torch.equal(r, g)
    del ballast


# shapes of the direct path's card tests: (tile codes, layers, bands, Config)
DIRECT_SHAPES = {
    "urban_mix": (np.repeat(np.arange(6), 2048), 8, 1, {}),
    "rami5": (np.full(512, 3), 62, 14, dict(n_vegetation_region_urban=2, n_stream_sw_urban=4,
                                            n_stream_lw_urban=4, nsw=14, nlw=14)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", list(DIRECT_SHAPES))
def test_cuda_direct_replay_is_bit_equal_to_the_packed_replay(cuda_device, shape, dtype):
    """run_radsurf's replay on arrays it has loaded before copies every
    field straight from their pages and gives the packed replay's bits;
    fresh copies of the arrays are packed again, with the same bits."""
    rep, L, S, kw = DIRECT_SHAPES[shape]
    cfg = Config(do_lw=True, **kw).consolidate()
    arrays = example_arrays(C=len(rep), L=L, S=S, dtype=dtype, i_representation=rep, seed=4)
    fresh = lambda: {k: v.copy() for k, v in arrays.items()}
    _, payload = dispatch._plan(cfg, arrays, cuda_device, "kernel", None, host=True)
    field_bytes = sum(t.numel() * t.element_size() for t in payload["fields"].values())
    del payload
    dispatch.run_radsurf(cfg, fresh(), cuda_device)  # eager
    outs, moved = [], []
    for a in (arrays, arrays, fresh()):  # captured (packed), straight, packed
        before = graphs.stats()
        outs.append(dispatch.run_radsurf(cfg, a, cuda_device))
        after = graphs.stats()
        moved.append(after["h2d_direct_bytes"] - before["h2d_direct_bytes"])
    assert moved == [0, field_bytes, 0]
    assert graphs.stats()["registered_bytes"] == field_bytes
    for out in outs[1:]:
        assert_equal({g: outs[0][g] for g in GROUPS}, {g: out[g] for g in GROUPS})


@pytest.mark.cuda
def test_cuda_callers_may_overwrite_their_arrays_when_the_call_returns(cuda_device):
    """A call fed straight from the caller's pages has read them when it
    returns: overwriting every array with NaN at once, with no sync,
    leaves its outputs as they were."""
    rep, L, S, kw = DIRECT_SHAPES["urban_mix"]
    rep = np.tile(rep, 8)
    cfg = Config(do_lw=True, **kw).consolidate()
    arrays = example_arrays(C=len(rep), L=L, S=S, dtype=np.float32, i_representation=rep)
    for _ in range(3):  # eager, captured, straight
        ref = dispatch.run_radsurf(cfg, arrays, cuda_device)
    ref = {g: {k: t.clone() for k, t in ref[g].items()} for g in GROUPS}
    direct = graphs.stats()["h2d_direct_bytes"]
    out = dispatch.run_radsurf(cfg, arrays, cuda_device)
    for k, v in arrays.items():
        if v.dtype.kind == "f":
            v[...] = np.nan
    torch.cuda.synchronize()
    assert graphs.stats()["h2d_direct_bytes"] > direct
    assert_equal(ref, {g: out[g] for g in GROUPS})


@pytest.mark.cuda
def test_cuda_a_registration_ends_with_its_owner(cuda_device):
    """An owner's range reads as page-locked while the owner lives and no
    longer once it is deleted (the memory, a tensor's, outlives it)."""
    mem = torch.rand(1 << 20)
    owner = mem.numpy()  # the root: its base is the tensor
    t = [torch.as_tensor(owner)]
    pinned = graphs._cache.pinned
    assert pinned.sight(t, [owner], cuda_device, replay=False) == frozenset()
    assert pinned.sight(t, [owner], cuda_device, replay=True) == {0}
    assert mem.is_pinned()
    del owner, t
    assert not mem.is_pinned() and graphs.stats()["registered_bytes"] == 0


@pytest.mark.cuda
def test_cuda_a_refused_registration_leaves_no_error_behind(cuda_device):
    """The runtime refuses a range locked twice; the error it leaves is
    cleared, so the next kernel launch raises nothing."""
    lock = graphs.PageLock()
    a = np.zeros(1 << 16)
    assert lock.register(a.ctypes.data, a.nbytes, read_only=False)
    try:
        assert not lock.register(a.ctypes.data, a.nbytes, read_only=False)
        assert (torch.ones(8, device=cuda_device) + 1).sum().item() == 16.0
    finally:
        lock.unregister(a.ctypes.data)
