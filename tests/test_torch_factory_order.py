"""The order in which the layer factory's teams take their elements (K1 and
K1d, csrc/layer_factory.cu): the order pass keys each element by its window
of consecutive places and its doubling count on the card, a stable argsort
of the keys orders the launch (window by window, longest first), and each
element still reads its operands and writes its results at its own (l, b)
with its own arithmetic.

* host build (csrc/host_check.cpp): the team bodies driven through a random
  permutation of the elements, and through the order pass's own order, give
  the identity order's outputs bit for bit, at every configuration the
  kernel tests cover, SW and LW mode; the order pass's counts equal
  tools.roofline.doubling_steps on a batch of night and day columns, and
  its order lists each window's elements longest first;
* cuda (marked, skipped without a GPU): the same on the card at team sizes
  4, 8, 16 and 32 and for K1d, and a replay of run_radsurf on all six tile
  types, half of the columns at night, bit-equal to its eager run with one
  order pass counted for every factory launch.
"""

import numpy as np
import pytest
import torch

from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
from spartacus_surface_tpu_torch.ops import cuda_build, launches
from spartacus_surface_tpu_torch.ops import layer_kernel as LK
from spartacus_surface_tpu_torch.tools import roofline as RL
from spartacus_surface_tpu_torch.utils import graphs
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.inputs import example_arrays
from test_torch_kernels import (ENTRY_CONFIGS, LARGE_CONFIGS, ONE_STREAM_CONFIGS,
                                build_host, capture)

FACTORIES = ("layer_factory", "lw_layer_factory")


@pytest.fixture(scope="module")
def host_lib():
    return build_host("host_check.cpp")


def factory_operands(calls, name):
    """[g0, g1, g2, g3, dz] and the launch keywords of the factory launch
    behind a captured layer_factory or lw_layer_factory call (LW mode: the
    pseudo-beam, gamma0 = 0, gamma3 = b, no direct-beam integrals)."""
    a, k, _ = calls[name]
    *ops, ndir, int_direct = RL._factory_call(name, a, k)
    return ops, dict(nd=k["nd"], ndir=ndir, n_double=k["n_double"], int_direct=int_direct)


def assert_same(ref, got):
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def leaves(out):
    """The tensors of a nested dict / sequence of results, in key order."""
    if isinstance(out, torch.Tensor):
        return [out]
    items = out.items() if isinstance(out, dict) else enumerate(out)
    return [t for _, v in sorted(items, key=lambda kv: str(kv[0])) for t in leaves(v)]


def assert_ordered(steps, window, order):
    """order lists every element once, window by window (`window`
    consecutive flat indices), each window's elements by count, largest
    first, the elements of one count in their place order."""
    steps, order = steps.reshape(-1).cpu(), order.cpu()
    assert torch.equal(order.sort().values, torch.arange(steps.numel()))
    w, k = order // window, steps[order]
    assert (w[1:] >= w[:-1]).all()
    same = w[1:] == w[:-1]
    assert (k[1:][same] <= k[:-1][same]).all()
    ties = same & (k[1:] == k[:-1])
    assert (order[1:][ties] > order[:-1][ties]).all()


def check_keys(lib, calls, name, stream, windows):
    """The order pass's counts against tools.roofline.doubling_steps, and
    element_order on its keys, at each window; returns the counts."""
    ops, kw = factory_operands(calls, name)
    a, k, _ = calls[name]
    steps = RL.doubling_steps(name, *a, **k).long().cpu()
    for window in windows:
        keys = LK.order_keys(lib, *ops, nd=kw["nd"], ndir=kw["ndir"],
                             n_double=kw["n_double"], window=window, stream=stream)
        assert keys.dtype == torch.int32 and keys.shape == steps.shape
        counts = LK.doubling_counts(keys).long().cpu()
        assert torch.equal(counts, steps), name
        assert_ordered(counts, window, LK.element_order(keys))
    return counts


# ----------------------------------------------------------------------
# host build
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nreg,ns", ENTRY_CONFIGS + ONE_STREAM_CONFIGS + LARGE_CONFIGS)
def test_host_built_factory_any_order_is_bit_equal(host_lib, monkeypatch, nreg, ns, dtype):
    calls = capture(monkeypatch, nreg, ns, dtype, "cpu", night=True)
    for name in FACTORIES:
        ops, kw = factory_operands(calls, name)
        L, _, B = ops[1].shape
        ident = LK.launch_ordered(host_lib, *ops, torch.arange(L * B), stream=None, **kw)
        perm = torch.as_tensor(np.random.default_rng(L * B).permutation(L * B))
        assert_same(ident, LK.launch_ordered(host_lib, *ops, perm, stream=None, **kw))
        n = LK.layer_factory.order_launches
        assert_same(ident, LK.launch(host_lib, *ops, chunk=5, stream=None, **kw))
        assert LK.layer_factory.order_launches == n + 1


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nreg,ns", [(2, 4), (3, 1), (1, 1)])
def test_host_built_order_pass_counts_the_doubling_steps(host_lib, monkeypatch, nreg, ns,
                                                         dtype):
    """K1 (2, 4), K1d in SW and K1 in LW mode at nd 3 (3, 1), K1d in both
    modes (1, 1): the counts equal doubling_steps, the order lists every
    window's elements (one place, 7, 64, or all 240) longest first, and the
    night columns' direct beam (cos_sza clamped to 1e-6) takes many more
    steps than the day columns'."""
    calls = capture(monkeypatch, nreg, ns, dtype, "cpu", C=40, L=3, S=2, night=True)
    for name in FACTORIES:
        counts = check_keys(host_lib, calls, name, None, (1, 7, 64, 240))
        if name == "layer_factory":
            by_column = counts.reshape(3, 40, 2)  # [L, columns, bands]
            night, day = by_column[:, ::2], by_column[:, 1::2]
            assert night.min() >= day.max() + 5, (night, day)


def test_order_window_is_the_resident_teams():
    """A window holds the teams the card runs at once, and at least n / 2^22
    elements, so that no window index overflows its 23 bits of the key."""
    config = {"resident_per_sm": 56, "sms": 132}
    assert LK.order_window(config, 699_056) == 56 * 132
    assert LK.order_window(config, 2**40) == 2**18
    assert LK.order_window({"resident_per_sm": 1, "sms": 1}, 5) == 1


def test_ordered_launch_checks_its_order(host_lib, monkeypatch):
    calls = capture(monkeypatch, 2, 4, np.float64, "cpu")
    ops, kw = factory_operands(calls, "layer_factory")
    L, _, B = ops[1].shape
    for bad in (torch.arange(L * B, dtype=torch.int32), torch.arange(L * B - 1),
                torch.arange(2 * L * B)[::2]):
        with pytest.raises(ValueError, match="order"):
            LK.launch_ordered(host_lib, *ops, bad, stream=None, **kw)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nreg,ns,ts", [(1, 4, 4), (2, 4, 8), (3, 4, 16), (3, 8, 32),
                                        (3, 1, 4)])
def test_cuda_ordered_factory_is_bit_equal(cuda_device, monkeypatch, nreg, ns, ts, dtype):
    """K1 at team sizes 4-32 and K1d ((3, 1) in SW mode, a team of 4) on
    night and day columns: the order pass's counts equal doubling_steps,
    the order lists each window's elements longest first (the launch's own
    window, the card's resident teams, and the whole launch as one), and
    the wrappers' ordered launch equals the identity order's and a random
    order's bit for bit, one order pass a launch."""
    calls = capture(monkeypatch, nreg, ns, dtype, cuda_device, C=300, L=4, S=2, night=True)
    lib = cuda_build.load("layer_factory")
    stream = cuda_build.stream(cuda_device)
    for name in FACTORIES:
        ops, kw = factory_operands(calls, name)
        L, _, B = ops[1].shape
        c = LK.factory_config(lib, kw["nd"], kw["ndir"], L * B, ops[1].dtype)
        assert c["team_size"] == (ts if name == "layer_factory" else
                                  min(32, 1 << (kw["nd"] - 1).bit_length())), c
        check_keys(lib, calls, name, stream, (LK.order_window(c, L * B), L * B))
        ident = LK.launch_ordered(lib, *ops, torch.arange(L * B, device=cuda_device),
                                  stream=stream, **kw)
        perm = torch.randperm(L * B, generator=torch.Generator().manual_seed(L * B))
        rand = LK.launch_ordered(lib, *ops, perm.to(cuda_device), stream=stream, **kw)
        n = LK.layer_factory.order_launches
        a, k, _ = calls[name]
        got = getattr(LK, name)(*a, **k)
        torch.cuda.synchronize()
        assert LK.layer_factory.order_launches == n + 1
        assert_same(ident, rand)
        if name == "layer_factory":
            assert_same(ident, got)
        else:  # the LW wrapper's outputs: R, T, p, int_diff, int_source
            assert_same(LK._lw_post(ident, a[2], a[3], kw["nd"]), got)


@pytest.mark.cuda
def test_cuda_run_radsurf_replay_orders_every_factory_launch(cuda_device):
    """run_radsurf on all six tile types, half of the columns at night: a
    replay of its graph is bit-equal to the eager call under
    graphs.disabled() (an InfiniteStreet column at night has a NaN direct
    albedo in both), and counts one order pass for every K1 and K1d
    launch."""
    cfg = Config(do_lw=True, nsw=2, nlw=2, do_save_flux_profile=True).consolidate()
    arrays = example_arrays(C=360, L=4, S=2, dtype=np.float32, seed=19)
    arrays["cos_sza"][np.random.default_rng(19).permutation(360)[:180]] = 0.0
    graphs.clear()
    try:
        with graphs.disabled():
            ref = run_radsurf(cfg, arrays, cuda_device)
        run_radsurf(cfg, arrays, cuda_device)  # eager
        run_radsurf(cfg, arrays, cuda_device)  # captured
        assert graphs.stats()["graphs"] == 1
        before = launches.counts()
        got = run_radsurf(cfg, arrays, cuda_device)
        after = launches.counts()
        delta = {k: after[k] - before[k] for k in after}
        assert delta["K1"] + delta["K1d"] > 0, delta
        assert delta["K1 order"] == delta["K1"] + delta["K1d"], delta
        ref, got = leaves(ref), leaves(got)
        assert len(ref) == len(got)
        for r, g in zip(ref, got):  # bit-equal, NaN where the eager call's is
            torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)
    finally:
        graphs.clear()
