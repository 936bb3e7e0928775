"""The port's spans and host-to-device counters, and the benchmark's two
readers of them.

utils/profiling.hook records (wall time into its totals and a named range
of the torch.profiler trace) while `profiling.enabled` is set or a
profiler runs, and does nothing else otherwise.  run_radsurf's host plan
opens dispatch.plan around models/dispatch.py _plan, with
dispatch.plan.memory_query (AUTO on a card) inside it, and gathers no
rows: the core gathers them on the device, and graphs.stats() counts
their bytes (gather_bytes); utils/graphs.py opens graphs.pack around the
pinned staging of each host group and counts the bytes and loads it moves
to the device (graphs.stats(): h2d_bytes, h2d_loads).
benchmark/metrics/dispatch.host_plan_ms.py and dispatch.h2d_mb.py read
them, loaded here by path as the benchmark loads them, so that the tests
run from any directory.

On the CPU: nothing records without a profiler; under one the plan opens
dispatch.plan alone, and gather_bytes counts the rows the core's
index_select calls return; the readers' arithmetic and their None on a
program that has no such span or counter (or no profiling.counts()); the
CLI's regions in a profiler trace without --timings, and its Graphs line
under --timings.  Marked cuda (skipped without a GPU): an eager, a
capturing and a replaying call under the profiler with CUDA activity,
where no device-side event carries a span's name, AUTO's memory query is
spanned and every load counts the payload's host bytes, the whole fields
and the indices; and a call with a gradient-requiring input, whose plan
moves the whole fields inside dispatch.plan (a device-side annotation),
and one with its fields already on the card, whose spans hold no launch,
read the same checks.trace_fields numbers with the spans on and off.
Imports nothing of JAX, so that the cuda test runs where JAX is missing
(pytest --noconftest).
"""

import contextlib
import importlib.util
import io
import json
import statistics
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from spartacus_surface_tpu_torch import checks
from spartacus_surface_tpu_torch.driver import main as CLI
from spartacus_surface_tpu_torch.models import dispatch
from spartacus_surface_tpu_torch.parallel.mesh import tree_leaves
from spartacus_surface_tpu_torch.utils import graphs, profiling
from spartacus_surface_tpu_torch.utils.config import Config
from spartacus_surface_tpu_torch.utils.inputs import example_arrays, write_example_input

SPANS = ("dispatch.plan", "dispatch.plan.memory_query", "graphs.pack")
METRICS = Path(__file__).resolve().parents[1] / "benchmark" / "metrics"


def reader(name):
    """The read() of benchmark/metrics/<name>.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"metric_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture
def clean_registry(monkeypatch):
    """Empty span totals for the test, the process's own put back after."""
    monkeypatch.setattr(profiling, "_totals", defaultdict(float))
    monkeypatch.setattr(profiling, "_counts", defaultdict(int))
    monkeypatch.setattr(profiling, "enabled", False)


def small_call(device="cpu"):
    """run_radsurf on 36 columns of all six tile types, SW and LW."""
    cfg = Config(do_lw=True, nsw=1, nlw=1).consolidate()
    return lambda seed=1: dispatch.run_radsurf(
        cfg, example_arrays(C=36, L=3, S=1, dtype=np.float64, seed=seed), device)


def whole_and_indices(arrays) -> int:
    """Bytes of a SW + LW call's host payload on example_arrays: every float
    field once, whole (ground_albedo_dir unread without
    use_sw_direct_albedo), every column's int64 index, and the simple
    tiles' is_inf flags."""
    rep = arrays["i_representation"]
    fields = sum(v.nbytes for k, v in arrays.items()
                 if v.dtype.kind == "f" and k != "ground_albedo_dir")
    return fields + 8 * rep.size + int(np.isin(rep, [4, 5]).sum())


def named(events, name, cpu=True):
    from torch.autograd import DeviceType

    kind = DeviceType.CPU if cpu else DeviceType.CUDA
    return [e for e in events if e.name == name and e.device_type == kind]


def test_nothing_records_without_a_profiler(clean_registry, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a range was opened with recording off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    out = small_call()()
    assert out["sw_norm_dir"]["top_net"].shape == (36, 1)
    assert profiling.totals() == {} and profiling.counts() == {}


class IndexSelectBytes(TorchDispatchMode):
    """The bytes of the tensors that index_select returns while on."""

    nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket is torch.ops.aten.index_select:
            self.nbytes += out.numel() * out.element_size()
        return out


def test_plan_spans_nest_under_a_profiler(clean_registry):
    """The plan gathers no rows (no dispatch.plan.gather): the core gathers
    them, and gather_bytes counts what its index_select calls return."""
    call = small_call()
    before = graphs.stats()["gather_bytes"]
    with profile(activities=[ProfilerActivity.CPU]) as prof, IndexSelectBytes() as rows:
        call()
    events = prof.events()
    (plan,) = named(events, "dispatch.plan")
    assert not named(events, "dispatch.plan.gather")
    assert not named(events, "dispatch.plan.memory_query")  # no card: no budget to query
    assert profiling.totals()["dispatch.plan"] > 0
    assert profiling.counts() == {"dispatch.plan": 1}
    # the flat tiles, the three layered groups, the simple tiles' rows and layer-0 slices
    assert graphs.stats()["gather_bytes"] - before == rows.nbytes > 0
    assert not profiling.enabled


@pytest.mark.parametrize("totals, counts, want", [
    ({"dispatch.plan": 0.5, "dispatch.plan.gather": 0.4, "graphs.pack": 0.1},
     {"dispatch.plan": 4, "dispatch.plan.gather": 32, "graphs.pack": 12}, 150.0),
    ({"dispatch.plan": 0.03}, {"dispatch.plan": 2}, 15.0),
    ({"read_input": 1.0, "radsurf": 2.0}, {"read_input": 1, "radsurf": 1}, None),
    ({}, {}, None),
], ids=["plan_and_pack", "plan_alone", "no_plan_span", "empty"])
def test_host_plan_reader(monkeypatch, totals, counts, want):
    monkeypatch.setattr(profiling, "_totals", defaultdict(float, totals))
    monkeypatch.setattr(profiling, "_counts", defaultdict(int, counts))
    got = reader("dispatch.host_plan_ms")(None)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("stats, want", [
    ({"h2d_bytes": 855_000_000, "h2d_loads": 3}, 285.0),
    ({"h2d_bytes": 0, "h2d_loads": 0}, None),
    ({"captures": 2, "replays": 9}, None),  # a program that counts no load
], ids=["loads", "no_load", "no_counter"])
def test_h2d_reader(monkeypatch, stats, want):
    monkeypatch.setattr(graphs, "stats", lambda: dict(stats))
    got = reader("dispatch.h2d_mb")(None)
    assert got == (None if want is None else pytest.approx(want))


def test_host_plan_reader_on_a_program_without_counts(monkeypatch):
    monkeypatch.setattr(profiling, "_counts", defaultdict(int, {"dispatch.plan": 3}))
    monkeypatch.delattr(profiling, "counts")
    assert reader("dispatch.host_plan_ms")(None) is None


def test_host_plan_reader_on_a_traced_call(clean_registry):
    call = small_call()
    call()
    assert reader("dispatch.host_plan_ms")(None) is None
    with profile(activities=[ProfilerActivity.CPU]):
        call(2)
        call(3)
    ms = reader("dispatch.host_plan_ms")(None)
    assert 0 < ms == pytest.approx(1e3 * profiling.totals()["dispatch.plan"] / 2)


NAMELIST = """&radsurf
  n_vegetation_region_forest = 2, n_vegetation_region_urban = 1,
  nsw = 1, nlw = 1,
  n_stream_sw_forest = 1, n_stream_sw_urban = 1,
  n_stream_lw_forest = 1, n_stream_lw_urban = 1,
/
&radsurf_driver
  iverbose = 1,
/
"""


@pytest.fixture
def cli_files(tmp_path):
    write_example_input(tmp_path / "in.nc", np.repeat(np.arange(6), 2), L=3, S=1, seed=3)
    (tmp_path / "c.nam").write_text(NAMELIST)
    return [str(tmp_path / "c.nam"), str(tmp_path / "in.nc"), str(tmp_path / "out.nc"),
            "--device", "cpu"]


def run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = CLI.main(argv)
    return rc, out.getvalue()


def test_cli_regions_in_a_profiler_trace_without_timings(clean_registry, cli_files):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rc, stdout = run_cli(cli_files)
    assert rc == 0
    names = {e.name for e in prof.events()}
    assert {"read_input", "radsurf", "save", "dispatch.plan"} <= names
    assert "Profiling summary" not in stdout  # the report is --timings' alone
    assert not profiling.enabled


def test_cli_timings_report_the_graph_counters_and_the_plan(clean_registry, cli_files):
    rc, stdout = run_cli(cli_files + ["--timings"])
    assert rc == 0
    (line,) = [ln for ln in stdout.splitlines() if ln.startswith("Graphs: ")]
    counted = json.loads(line[len("Graphs: "):])
    assert set(counted) == {"replays", "captures", "releases", "evictions", "h2d_bytes",
                            "h2d_direct_bytes", "h2d_direct_share", "gather_bytes"}
    assert counted["gather_bytes"] > 0
    assert "Kernel launches: " in stdout
    for span in ("radsurf", "dispatch.plan"):
        assert f"  {span} " in stdout
    assert "  dispatch.plan.gather " not in stdout


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    graphs.clear()
    yield torch.device("cuda")
    graphs.clear()


@pytest.mark.cuda
def test_cuda_spans_hold_no_device_work_and_loads_count_their_bytes(clean_registry,
                                                                    cuda_device):
    cfg = Config(do_lw=True, nsw=1, nlw=1).consolidate()  # AUTO column chunks
    arrays = [example_arrays(C=4096, L=8, S=1, dtype=np.float32, seed=s) for s in (1, 2, 3)]
    _, payload = dispatch._plan(cfg, arrays[0], cuda_device, "kernel", None, host=True)
    payload_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(payload))
    assert payload_bytes == whole_and_indices(arrays[0])
    loads, captures = [], graphs.stats()["captures"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for a in arrays:  # eager, captured (then replayed), replayed
            before = graphs.stats()
            dispatch.run_radsurf(cfg, a, cuda_device)
            torch.cuda.synchronize()
            after = graphs.stats()
            loads.append((after["h2d_loads"] - before["h2d_loads"],
                          after["h2d_bytes"] - before["h2d_bytes"]))
    assert graphs.stats()["captures"] - captures == 1
    # the capturing call loads its graph's static inputs, then replays
    assert loads == [(1, payload_bytes), (2, 2 * payload_bytes), (1, payload_bytes)]
    events = prof.events()
    for span in SPANS:
        assert not named(events, span, cpu=False), span
    assert len(named(events, "dispatch.plan")) == 3
    assert len(named(events, "dispatch.plan.memory_query")) == 3
    assert len(named(events, "graphs.pack")) == 4 * len({t.dtype for t in tree_leaves(payload)})
    assert any(e.device_type.name == "CUDA" for e in events)  # the card's work was traced


def _on_card(arrays, device):
    """arrays with every float field a tensor on `device` (the integer
    fields stay host numpy, as parallel/streaming passes them)."""
    return {k: torch.as_tensor(v, device=device) if v.dtype.kind == "f" else v
            for k, v in arrays.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["grad", "on_card"])
def test_cuda_trace_fields_read_the_same_with_the_spans_on_and_off(clean_registry, cuda_device,
                                                                   monkeypatch, inputs):
    """Where a span holds launches (the eager route's field moves), the
    profiler shows it as a device-side annotation; checks.trace_fields
    leaves those out, so it reads the same launches, busy and other ms
    whether the spans record.  Fields already on the card are indexed in
    the core, outside any span."""
    cfg = Config(do_lw=True, nsw=1, nlw=1).consolidate()
    arrays = example_arrays(C=4096, L=8, S=1, dtype=np.float32, seed=5)
    if inputs == "grad":
        arrays["veg_ext"] = torch.as_tensor(arrays["veg_ext"]).requires_grad_(True)
    else:
        arrays = _on_card(arrays, cuda_device)
    step = lambda: dispatch.run_radsurf(cfg, arrays, cuda_device)
    for _ in range(3):  # the compiled route's key: eager, captured, then replayed
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    held = [e for e in prof.events() if e.name in SPANS and e.device_type.name == "CUDA"]
    # the eager route moves the whole fields inside dispatch.plan; fields
    # on the card are indexed in the core, so the plan holds no launch
    assert bool(held) == (inputs == "grad")
    assert all(e.is_user_annotation for e in held)

    spans = profiling.hook
    only_label = lambda name: spans(name) if name == "bench_call" else contextlib.nullcontext()
    reads = {"on": [], "off": []}
    for way in ("on", "off") * 3:
        monkeypatch.setattr(profiling, "hook", spans if way == "on" else only_label)
        reads[way].append(checks.trace_fields(step, cuda=True))
    monkeypatch.setattr(profiling, "hook", spans)
    median = lambda way, field: statistics.median(r[field] for r in reads[way])
    # the profiler's own count of a call varies by a few from trace to trace
    assert abs(median("on", "device_launches") - median("off", "device_launches")) <= 4, reads
    for field in ("device_busy_ms", "other_device_ms"):
        assert median("on", field) == pytest.approx(median("off", field), rel=0.05), (field, reads)
