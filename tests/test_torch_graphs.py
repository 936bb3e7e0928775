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
what makes them capturable.

Marked cuda (skipped without a GPU): on the card a replay is bit-equal to
the eager call, a call with new inputs gives the new answer and leaves an
earlier call's outputs as they were, the launch counters grow by the
captured counts at every replay, and an AUTO call on a squeezed card
after a capture picks the chunks it picks with no graph held.
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

    def __call__(self, tensors):
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
