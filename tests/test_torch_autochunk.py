"""The port's automatic chunks, on the CPU: AUTO column_chunk (-1), the
CLI's automatic stream chunk, and the working-set model that sizes both
(utils/device_memory.py).

* the twins of tests/test_solver_conservation.py::
  test_auto_column_chunk_resolution and tests/test_round5_units.py::
  test_auto_stream_chunk, with the budget passed in: explicit values pass
  through, a batch that fits gives 0, the chunks come out even (and divide
  ncol where they can), a prime ncol takes a ceiling split, the stream
  budget scales with the devices;
* column_chunk = -1 on every entry point (it used to raise IndexError):
  spartacus_sw / spartacus_lw against the JAX package's -1 at 1e-9, and,
  with a budget small enough to chunk, spartacus_sw / spartacus_lw,
  run_radsurf and a gradient against the whole batch's;
* the CLI with no --stream-chunk against --stream-chunk 0 (the CPU's
  budget is unbounded), and, under a small budget, streaming by itself;
* the model: monotone in columns, layers, bands, streams, regions and
  dtype; the whole fields and each section's gathered rows counted to the
  byte on a mixed layout, SW only, LW only and both; the plan's need under
  AUTO chunks counted by hand; and within 3 % of the bytes of the tensors the
  kernel route holds at its peak, counted here with every kernel emulated
  by its outputs (a CUDA wrapper allocates its outputs and nothing else).
"""

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from spartacus_surface_tpu.models import solver as JS
from spartacus_surface_tpu.ops.legendre_gauss import LegendreGauss as JLG
from spartacus_surface_tpu_torch.driver import main as TMAIN
from spartacus_surface_tpu_torch.models import dispatch as TD
from spartacus_surface_tpu_torch.models import solver as TS
from spartacus_surface_tpu_torch.models.dispatch import run_radsurf, working_set_bytes
from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss as TLG
from spartacus_surface_tpu_torch.utils import device_memory as DM
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.convert import to_canopy_inputs
from spartacus_surface_tpu_torch.utils.inputs import example_arrays, write_example_input
from tests.test_solver_conservation import add_lw, make_inputs
from tests.test_torch_cli import TILES, namelist, read_nc, run_port
from tests.test_torch_lw import rr_err
from tests.test_torch_solver import field_err

TOL = 1e-9


def resolve(C, budget, L=8, S=1, lw=False, route="kernel", **kw):
    opt = TS.SolverOptions(**{"nreg": 2, "nstream": 4, "do_urban": True, **kw})
    return TS._resolve_column_chunk(opt, TLG(opt.nstream), C, L, S,
                                    torch.float32, "cpu", lw=lw, route=route,
                                    budget=budget)


def need(C, L=8, S=1, nreg=2, ns=4, lw=False):
    """(transient, kept) bytes of one float32 solve (device_memory)."""
    return DM.solve_bytes(C, L, S, nreg, ns, 4, lw=lw)


def test_auto_column_chunk_resolution():
    """The twin of the JAX test, with the budget passed in."""
    t, k = need(16384)
    # explicit values pass through, whatever the budget
    assert resolve(10**6, 1.0, column_chunk=0) == 0
    assert resolve(10**6, 1.0, column_chunk=4096) == 4096
    # AUTO off the kernel route: no chunking
    assert resolve(16384, t / 8, route="scan", column_chunk=-1) == 0
    assert resolve(16384, t / 8, associative_sweeps=True, column_chunk=-1) == 0
    # AUTO on the CPU (budget None: unbounded): no chunking
    assert resolve(10**6, None, column_chunk=-1) == 0
    # a batch that fits: the whole batch
    assert resolve(16384, t, column_chunk=-1) == 0
    # the fewest equal chunks that fit: every chunk fits, one chunk fewer
    # would not
    for C, budget in ((16384, t / 8 + 2 * k), (5000, need(5000)[0] / 3 + 2 * k),
                      (16384, t / 7.5 + 2 * k)):
        ck = resolve(C, budget, column_chunk=-1)
        n = -(-C // ck)
        assert 0 < ck < C and ck == -(-C // n)
        assert need(ck)[0] + 2 * need(C)[1] <= budget
        assert need(-(-C // (n - 1)))[0] + 2 * need(C)[1] > budget
    assert resolve(16384, t / 8 + 2 * k, column_chunk=-1) == 2048
    # multiband: the same rule on C x S batch elements
    t14 = need(1024, S=14)[0]
    ck = resolve(1024, t14 / 2 + 2 * need(1024, S=14)[1], S=14, column_chunk=-1)
    assert ck == 512
    # not one column fits: refused before the solve
    with pytest.raises(RuntimeError, match="not one column fits"):
        resolve(16384, 2 * k, column_chunk=-1)


def stream_arrays(ncol, L=40, S=14):
    return example_arrays(C=ncol, L=L, S=S, dtype=np.float64,
                          i_representation=np.full(ncol, 1))


def test_auto_stream_chunk():
    """The twin of the JAX test, with the budget passed in."""
    cfg = Config(do_lw=False, nsw=14, nlw=1, n_vegetation_region_forest=2).consolidate()
    small = stream_arrays(16)
    one_shot = working_set_bytes(cfg, small["i_representation"], 40, 8)
    # fits: no streaming
    assert TMAIN.auto_stream_chunk(cfg, small, 16, 1, one_shot) == 0
    assert TMAIN.auto_stream_chunk(cfg, small, 16) == 0  # unbounded (CPU)
    # 48 columns in a budget of ~1/5 of one shot: streams, the chunk divides
    # ncol, and a slice with its stream buffers fits
    a48 = stream_arrays(48)
    budget = working_set_bytes(cfg, a48["i_representation"], 40, 8) / 5
    ck = TMAIN.auto_stream_chunk(cfg, a48, 48, 1, budget)
    assert 0 < ck < 48 and 48 % ck == 0
    assert working_set_bytes(cfg, np.full(ck, 1), 40, 8) <= budget
    # prime ncol: a ceiling split
    a47 = stream_arrays(47)
    ck = TMAIN.auto_stream_chunk(cfg, a47, 47, 1, budget)
    n = -(-47 // ck)
    assert 0 < ck < 47 and ck == -(-47 // n) and 47 % ck
    # the budget is per device: two devices of half the budget each stream
    # as one of the whole
    assert (TMAIN.auto_stream_chunk(cfg, a48, 48, 2, budget / 2)
            == TMAIN.auto_stream_chunk(cfg, a48, 48, 1, budget))
    # the working precision sets the words
    assert (TMAIN.auto_stream_chunk(cfg, a48, 48, 1, budget, itemsize=4)
            >= TMAIN.auto_stream_chunk(cfg, a48, 48, 1, budget))


# ----------------------------------------------------------------------
# column_chunk = -1 on every entry point
# ----------------------------------------------------------------------

def solver_inputs(lw):
    rng = np.random.default_rng(11)
    inp = make_inputs(rng, C=9, L=3, S=2, urban=True)
    return add_lw(inp, rng) if lw else inp


@pytest.mark.parametrize("route", ["kernel", "scan"])
@pytest.mark.parametrize("lw", [False, True], ids=["sw", "lw"])
def test_auto_matches_jax_auto(lw, route):
    """spartacus_sw / spartacus_lw at column_chunk = -1 on the CPU against
    the JAX package's -1."""
    inp = solver_inputs(lw)
    jf, tf = (JS.spartacus_lw, TS.spartacus_lw) if lw else (JS.spartacus_sw, TS.spartacus_sw)
    ref = jf(inp, JS.SolverOptions(nreg=2, nstream=4, do_urban=True,
                                   column_chunk=-1), JLG(4))
    got = tf(to_canopy_inputs(inp, "cpu"), TS.SolverOptions(
        nreg=2, nstream=4, do_urban=True, column_chunk=-1), TLG(4), route=route)
    assert field_err(ref, got) < TOL


@pytest.fixture
def small_budget(monkeypatch):
    """device_budget as if the device held 1/3 of the transient of a
    9-column solve of solver_inputs (AUTO then takes chunks of 3-4
    columns); returns the chunks AUTO picks."""
    t, k = DM.solve_bytes(9, 3, 2, 2, 4, 8)
    monkeypatch.setattr(DM, "device_budget", lambda device: t / 3 + 2 * k + 1)
    picked = []
    resolve_chunk = TS._resolve_column_chunk

    def record(*a, **kw):
        picked.append(resolve_chunk(*a, **kw))
        return picked[-1]

    monkeypatch.setattr(TS, "_resolve_column_chunk", record)
    return picked


@pytest.mark.parametrize("lw", [False, True], ids=["sw", "lw"])
def test_auto_chunks_under_a_small_budget(small_budget, lw):
    """Under a budget that cannot hold the batch, AUTO chunks and the
    result equals the whole batch's."""
    inp = to_canopy_inputs(solver_inputs(lw), "cpu")
    solve = TS.spartacus_lw if lw else TS.spartacus_sw
    opt = lambda ck: TS.SolverOptions(nreg=2, nstream=4, do_urban=True, column_chunk=ck)
    got = solve(inp, opt(-1), TLG(4))
    assert len(small_budget) == 1 and 0 < small_budget[0] < 9
    assert field_err(solve(inp, opt(0), TLG(4)), got) < 1e-13


def test_auto_run_radsurf_and_gradient(small_budget):
    """run_radsurf with the Config default (-1) under the small budget:
    the layered groups chunk, the outputs and the gradient equal the
    whole batch's (column_chunk = 0)."""
    arrays = example_arrays(C=24, L=3, S=2, dtype=np.float64)
    results = []
    for ck in (-1, 0):
        veg_ext = torch.as_tensor(arrays["veg_ext"]).requires_grad_(True)
        cfg = Config(do_lw=True, nsw=2, nlw=2, column_chunk=ck).consolidate()
        out = run_radsurf(cfg, {**arrays, "veg_ext": veg_ext}, "cpu")
        (out["sw_norm_dir"]["ground_net"].sum()
         + out["lw_internal"]["top_net"].sum()).backward()
        results.append((out, veg_ext.grad.numpy()))
    assert Config().column_chunk == -1
    assert any(ck > 0 for ck in small_budget)
    (auto, g_auto), (whole, g_whole) = results
    detach = lambda out: {g: {k: v.detach() for k, v in d.items()}
                          for g, d in out.items()}
    assert rr_err(detach(whole), detach(auto)) < 1e-13
    np.testing.assert_allclose(g_auto, g_whole, rtol=1e-12, atol=1e-14)


def test_cli_without_stream_chunk(tmp_path, monkeypatch):
    """No --stream-chunk on the CPU: one shot, the file of --stream-chunk
    0.  Under a budget of ~1/3 of the one-shot working set the CLI streams
    by itself, says so, and writes the same file."""
    write_example_input(tmp_path / "in.nc", TILES, L=3, S=1, seed=7)
    nam = namelist(tmp_path / "ns4.nam", "ns4")
    outs = {}
    for name, extra in (("auto", ()), ("zero", ("--stream-chunk", "0"))):
        outs[name] = tmp_path / f"{name}.nc"
        rc, stdout, err = run_port(nam, tmp_path / "in.nc", outs[name],
                                   "--device", "cpu", *extra)
        assert rc == 0, err
        assert "Streaming" not in stdout
    cfg = Config.from_namelist(nam).consolidate()
    one_shot = working_set_bytes(cfg, TILES, 3, 8)
    monkeypatch.setattr(TMAIN, "device_budget", lambda device: one_shot / 3)
    outs["squeezed"] = tmp_path / "squeezed.nc"
    rc, stdout, err = run_port(nam, tmp_path / "in.nc", outs["squeezed"],
                               "--device", "cpu")
    assert rc == 0, err
    assert "-column chunks (host pipeline; see --stream-chunk)" in stdout
    ref = read_nc(outs["zero"])
    for name in ("auto", "squeezed"):
        got = read_nc(outs[name])
        assert ref[0] == got[0] and set(ref[2]) == set(got[2])
        for k, (_, _, v) in ref[2].items():
            np.testing.assert_allclose(got[2][k][2], v, rtol=1e-12, atol=1e-12,
                                       err_msg=f"{name}: {k}")


# ----------------------------------------------------------------------
# the working-set model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lw", [False, True], ids=["sw", "lw"])
def test_model_is_monotone(lw):
    base = dict(ncol=1000, nlay=8, nband=2, nreg=2, nstream=4, itemsize=4)
    ref = sum(DM.solve_bytes(**base, lw=lw))
    for key, more in (("ncol", 1001), ("nlay", 9), ("nband", 3), ("nreg", 3),
                      ("nstream", 8), ("itemsize", 8)):
        assert sum(DM.solve_bytes(**{**base, key: more}, lw=lw)) > ref, key
    assert DM.solve_bytes(**{**base, "itemsize": 8}, lw=lw)[0] == 2 * DM.solve_bytes(
        **base, lw=lw)[0]
    cfg = Config(do_lw=True, nsw=2, nlw=2).consolidate()
    rep = np.array([0, 1, 2, 3, 4, 5] * 4)
    runs = [working_set_bytes(cfg, r, 8, 4) for r in (rep, np.append(rep, 3))]
    assert runs[1] > runs[0]
    assert DM.device_budget("cpu") == float("inf")


COMMON_KEYS = ("dz", "cos_sza", "veg_fraction", "veg_scale", "veg_ext", "veg_fsd",
               "veg_contact_fraction", "building_fraction", "building_scale")
SW_KEYS = ("sw_air_ext", "sw_air_ssa", "sw_veg_ssa", "ground_albedo", "roof_albedo",
           "roof_albedo_dir", "wall_albedo", "wall_specular_frac")
LW_KEYS = ("lw_air_ext", "lw_air_ssa", "lw_veg_ssa", "ground_emissivity", "ground_emission",
           "roof_emissivity", "roof_emission", "wall_emissivity", "wall_emission",
           "clear_air_planck", "veg_planck", "veg_air_planck")


def row_bytes(a, keys, lay0=False):
    """Bytes of one column's row (lay0: its layer-0 slice) of the keys."""
    return sum((a[k][0, 0] if lay0 else a[k][0]).nbytes for k in keys)


@pytest.mark.parametrize("bands", ["sw", "lw", "sw_lw"])
def test_model_counts_the_whole_fields_and_the_gathered_rows(monkeypatch, bands):
    """On a permuted mix of the six tile types (SW at 2 bands, LW at 3),
    SW only, LW only and both: working_set_bytes holds every field read
    once, whole, and Plan.need the rows the core gathers: with each solve's
    bytes set to 0, the need is the flux containers and the largest
    section's rows (the flat tiles', a layered group's, the simple tiles'
    with their layer-0 slices), the model that and the whole fields;
    Plan.gathered is every section's rows.  With the solves counted again,
    the model is the need and the fields."""
    do_sw, do_lw = bands != "lw", bands != "sw"
    L, cpu = 4, torch.device("cpu")
    rep = np.random.default_rng(2).permutation(np.repeat(np.arange(6), [5, 7, 4, 6, 3, 2]))
    a = example_arrays(C=rep.size, L=L, S=2, dtype=np.float64, i_representation=rep)
    a3 = example_arrays(C=rep.size, L=L, S=3, dtype=np.float64, i_representation=rep)
    a.update({k: a3[k] for k in LW_KEYS})
    cfg = Config(do_sw=do_sw, do_lw=do_lw, nsw=2, nlw=3).consolidate()
    read = COMMON_KEYS + (SW_KEYS if do_sw else ()) + (LW_KEYS if do_lw else ())
    whole = sum(a[k].nbytes for k in read)
    ground = (("ground_albedo",) if do_sw else ()) + (
        ("ground_emissivity", "ground_emission") if do_lw else ())
    lay0 = ("dz", "building_fraction", "building_scale") + (
        ("roof_albedo", "wall_albedo") if do_sw else ()) + (
        ("roof_emissivity", "roof_emission", "wall_emissivity", "wall_emission")
        if do_lw else ())
    flat = 5 * row_bytes(a, ground)
    layered = [C * row_bytes(a, read) for C in (7, 4, 6)]
    simple = 5 * (row_bytes(a, ("cos_sza", *ground)) + row_bytes(a, lay0, lay0=True))
    containers = sum(2 * DM.class_bytes(DM.CONTAINER_WORDS, rep.size, L, S, 8)
                     for S, on in ((2, do_sw), (3, do_lw)) if on)

    real = DM.solve_bytes
    monkeypatch.setattr(DM, "solve_bytes", lambda *a, **k: (0, 0))
    plan, payload = TD._plan(cfg, a, cpu, "kernel", None, host=True)
    assert plan.need == containers + max(flat, *layered, simple)
    assert plan.gathered == flat + sum(layered) + simple
    assert sum(t.nbytes for t in payload["fields"].values()) == whole
    assert working_set_bytes(cfg, rep, L, 8) == containers + whole + max(flat, *layered, simple)
    monkeypatch.setattr(DM, "solve_bytes", real)
    plan, _ = TD._plan(cfg, a, cpu, "kernel", None, host=True)
    assert plan.need > containers + max(layered)
    assert working_set_bytes(cfg, rep, L, 8) == plan.need + whole


def test_chunked_plan_need_is_the_models(small_budget):
    """Under a budget that forces AUTO chunks on one layered group (9
    VegetatedUrban columns, SW and LW at 2 bands): Plan.need is the flux
    containers and the larger of the two solves' terms, each the group's
    rows, the outputs kept before it, and its transient at its chunk with
    its own outputs twice, as they are concatenated; the chunks in the
    plan are the ones AUTO picked."""
    L, S, C = 3, 2, 9
    rep = np.full(C, 3)
    a = example_arrays(C=C, L=L, S=S, dtype=np.float64, i_representation=rep)
    cfg = Config(do_lw=True, nsw=S, nlw=S).consolidate()
    plan, _ = TD._plan(cfg, a, torch.device("cpu"), "kernel", None, host=True)
    ((_, _, ((_, opt_sw, opt_lw),)),) = plan.layered
    assert [opt_sw.column_chunk, opt_lw.column_chunk] == small_budget
    assert all(0 < ck < C for ck in small_budget)
    size = lambda n, lw: DM.solve_bytes(n, L, S, 2, 4, 8, lw=lw)
    rows = C * row_bytes(a, COMMON_KEYS + SW_KEYS + LW_KEYS)
    sw = rows + size(opt_sw.column_chunk, False)[0] + 2 * size(C, False)[1]
    lw = size(C, False)[1] + rows + size(opt_lw.column_chunk, True)[0] + 2 * size(C, True)[1]
    containers = 2 * 2 * DM.class_bytes(DM.CONTAINER_WORDS, C, L, S, 8)
    assert plan.need == containers + max(sw, lw)
    assert plan.need < working_set_bytes(cfg, rep, L, 8) - sum(
        a[k].nbytes for k in COMMON_KEYS + SW_KEYS + LW_KEYS)


class LiveBytes(TorchDispatchMode):
    """The peak bytes of the tensor storages alive at once, over every
    tensor an op returns while this mode is on (storages freed are dropped
    at the next op); `paused` hides the ops inside an emulated kernel."""

    def __init__(self):
        super().__init__()
        self.live, self.peak, self.paused = {}, 0, False

    def hold(self, out):
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                ref = self.live.get(s.data_ptr())
                if ref is None or ref[0].expired():
                    self.live[s.data_ptr()] = (StorageWeakRef(s), s.nbytes())
        self.live = {k: v for k, v in self.live.items() if not v[0].expired()}
        self.peak = max(self.peak, sum(n for _, n in self.live.values()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            self.hold(out)
        return out


KERNELS = ("layer_factory", "lw_layer_factory", "sw_up_sweep",
           "sw_down_sweep_both", "lw_up_sweep", "lw_down_sweep_both")
MODEL_CASES = {
    # (tile codes, layers, bands, Config kwargs)
    "headline": ([3] * 48 + [0] * 4 + [4] * 2 + [5] * 2, 8, 1,
                 dict(n_vegetation_region_urban=1, n_stream_sw_urban=4,
                      n_stream_lw_urban=4)),
    "rami5": ([1] * 6, 20, 6, dict(n_vegetation_region_forest=2,
                                   n_stream_sw_forest=4, n_stream_lw_forest=4)),
    "rami5_ns1": ([1] * 6, 20, 6, dict(n_vegetation_region_forest=2,
                                       n_stream_sw_forest=1, n_stream_lw_forest=1)),
    "cli_mix": ([3] * 24 + [1] * 12 + [2] * 12 + [0, 4, 5], 8, 1,
                dict(n_vegetation_region_forest=2, n_vegetation_region_urban=1,
                     do_save_flux_profile=True)),
    "urban_ns8": ([2] * 24, 6, 3, dict(n_stream_sw_urban=8, n_stream_lw_urban=8)),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_counts_the_live_tensors(case, monkeypatch):
    """working_set_bytes within 3 % of the peak bytes of the tensors that
    run_radsurf's kernel route holds at once (float32), the inputs copied
    to the device as on a card."""
    rep, L, S, kw = MODEL_CASES[case]
    arrays = example_arrays(C=len(rep), L=L, S=S, dtype=np.float32,
                            i_representation=np.array(rep))
    cfg = Config(do_lw=True, nsw=S, nlw=S, **kw).consolidate()
    mode = LiveBytes()
    for name in KERNELS:
        def emulated(*a, _fn=getattr(TS, name), **k):
            mode.paused = True
            try:
                out = _fn(*a, **k)
            finally:
                mode.paused = False
            mode.hold(out)
            return out
        monkeypatch.setattr(TS, name, emulated)
    to_device = TD.to_device
    monkeypatch.setattr(TD, "to_device", lambda *a: to_device(*a).clone())
    with torch.no_grad(), mode:
        run_radsurf(cfg, arrays, "cpu")
    model = working_set_bytes(cfg, np.array(rep), L, 4)
    assert 0.97 <= mode.peak / model <= 1.03, (mode.peak, model)
