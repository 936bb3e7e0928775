"""The benchmark of the PyTorch / CUDA port: one cell of BENCHMARK.json,
run on the card this process finds.

    python3 -m benchmark.run --workload rami5.f32 --seed 7 --seconds 20 --trace 0

A cell names a configuration (benchmark/configs/<config>.json: the tile
mix, layers, &radsurf settings and field draws), a traffic mix
(benchmark/traffic/<traffic>.json: precision and input sets) and its own
file (benchmark/workloads/<cell>.json: the columns the check samples and
its limits).  End-to-end metrics are read by benchmark/end_to_end/<name>.py
from the timed window, per-layer metrics by benchmark/metrics/<name>.py
from the trace; which a cell reports, BENCHMARK.json says.

A run: the input sets from --seed (benchmark/generate.py), then set-up: the
program's import, the first call of the first set (eager; in a checkout's
first run it builds csrc/ into build/kernels/), the second (its CUDA graph
captured) and one replay of every set.  Then the timed window: a closed loop
of spartacus_surface_tpu_torch.models.dispatch.run_radsurf(config, arrays,
"cuda") on host numpy inputs, each call ending in torch.cuda.synchronize(),
cycling the sets, for --seconds, with one intra-op thread and the set-up's
objects frozen out of the garbage collector.  With --trace 1 one more call of each set
runs under torch.profiler (benchmark/trace.py).  Then the check
(benchmark/check.py): one call of each set, drawn from the seed among the
window's calls, compared at sampled columns with the plain reference.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, card, [breakdown], checks); the compared numbers
and their limits are also the last lines of standard error.  The run exits
with code 2 and prints no result where the card or cards the cell asks for
are missing, and with code 3 where JAX or the JAX package is loaded when
the result is due.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, before any heavy import

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spartacus_surface_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list
    bench: Path = BENCH  # where its readers are


@dataclass
class Window:
    """What the end-to-end readers read."""

    columns: int  # a call's
    walls: list  # seconds of each call
    seconds: float  # the window's length
    setup_s: float


def load_cell(name: str, spec: dict | None = None, bench: Path = BENCH) -> Cell:
    """The cell `name` of BENCHMARK.json (spec, or the file beside
    `bench`), its files found by name under `bench`."""
    if spec is None:
        spec = json.loads((bench.parent / "BENCHMARK.json").read_text())
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in spec["configs"] if c["name"] == wl["config"])
    read = lambda p: json.loads(Path(p).read_text())
    listed = lambda m: name in m.get("workloads", [name])
    return Cell(name, wl["chips"], read(bench.parent / cfg["file"]),
                read(bench / "traffic" / f"{wl['traffic']}.json"),
                read(bench / "workloads" / f"{name}.json")["check"],
                [m for m in spec["end_to_end"] if listed(m)],
                [m for m in spec["per_layer"] if listed(m)], bench)


def reader(kind: str, name: str, bench: Path = BENCH):
    """The read() of benchmark/<kind>/<name>.py."""
    path = bench / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """The modules of JAX or the JAX package loaded in this process."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        if res.returncode == 0 and res.stdout.strip():
            return res.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "power limit not read"


def cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own nvcc builds go to build/kernels/)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def _walls_summary(walls: list) -> dict:
    """The window's call walls in ms: min, median, max, and the median of
    each tenth of the window in order (a drift shows there)."""
    import statistics

    if not walls:
        return {}
    ms = [x * 1e3 for x in walls]
    n = len(ms)
    tenths = [statistics.median(ms[i * n // 10:max((i + 1) * n // 10, i * n // 10 + 1)])
              for i in range(min(10, n))]
    return {"min": min(ms), "median": statistics.median(ms), "max": max(ms), "tenths": tenths}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t0: float = T0, solve=None) -> dict:
    """One run of a cell; returns the result line's object.  solve: the
    timed call (run_radsurf's signature; default the program's)."""
    import numpy as np
    import torch

    from . import check as CK
    from . import generate as GEN

    from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
    from spartacus_surface_tpu_torch.utils import graphs
    from spartacus_surface_tpu_torch.utils.config import Config

    marks = {"import": time.perf_counter()}
    solve = solve or run_radsurf
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, traffic = cell.config, cell.traffic
    radsurf = cfg["radsurf"]
    config = Config(**radsurf).consolidate()
    sets = GEN.input_sets(cfg, traffic, seed)
    ncol = GEN.columns(cfg)
    marks["inputs"] = time.perf_counter()

    # ---- set-up: eager, capture, a replay of every set
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for step, arrays in zip(("first_call", "capture", "replays", "", "", ""),
                            sets[:2] + sets):
        solve(config, arrays, device)
        sync()
        marks[step or "replays"] = time.perf_counter()
    gc.collect()
    gc.freeze()  # the set-up's objects out of the window's collections
    setup_s = time.perf_counter() - t0
    setup = {}
    for k, v in marks.items():  # each step's seconds, in order
        setup[k] = v - t0 - sum(setup.values())
    captures = graphs.stats()["captures"]

    # ---- the timed window: a closed loop over the sets
    rng = np.random.default_rng([int(seed) % 2**64, 2])
    kept, seen, walls = [None] * len(sets), [0] * len(sets), []
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        i = len(walls) % len(sets)
        t = time.perf_counter()
        out = solve(config, sets[i], device)
        sync()
        walls.append(time.perf_counter() - t)
        seen[i] += 1
        if rng.uniform() * seen[i] < 1.0:  # one call of each set, uniform
            kept[i] = out
        del out
    window_s = time.perf_counter() - start
    gc.unfreeze()
    compiled_in_window = graphs.stats()["captures"] - captures
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    w = Window(ncol, walls, window_s, setup_s)
    card = card_line() if cuda else "cpu"
    result = {"correct": False, "attempted": len(walls), "failed": 0}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}

    # ---- the traced run
    extra = {}
    if trace:
        from . import trace as TR
        from .work import call_work

        events = TR.profile([lambda a=a: solve(config, a, device) for a in sets], cuda)
        calls = TR.split_calls(events)
        dname = traffic["dtype"]
        work = [call_work(radsurf, a, getattr(torch, dname), device) for a in sets]
        t = TR.Trace(calls, work, dname, TR.peaks(device_info["kind"]))
        metrics = {}
        for m in cell.per_layer:
            v = reader("metrics", m["name"], cell.bench)(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=t.busy_ms() / 1e3, window_s=t.span_ms() / 1e3)
        extra["breakdown"] = TR.breakdown(events, calls)
    else:
        metrics = {}
        for m in cell.end_to_end:
            v = reader("end_to_end", m["name"], cell.bench)(w)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # ---- the check, on the program's outputs after its state is freed
    t_check = time.perf_counter()
    pick = np.random.default_rng([int(seed) % 2**64, 3])
    picks = []
    for i, out in enumerate(kept):
        if out is None:
            continue
        cols = CK.sample_columns(sets[i]["i_representation"], cell.check["columns_per_call"],
                                 pick)
        idx = torch.as_tensor(cols, device=device)
        picks.append((i, cols, {k: v[idx] for k, v in CK.fields(out).items()}))
    kept = None
    graphs.clear()
    if cuda:
        torch.cuda.empty_cache()
    total, failed = CK.Comparison(), 0
    limits = cell.check["limits"]
    for i, cols, program in picks:
        ref = CK.reference_outputs(radsurf, CK.subset(sets[i], cols), device,
                                   cell.check["block_columns"])
        day = sets[i]["cos_sza"][cols]
        one = CK.Comparison()
        for c in (one, total):
            c.add(CK.day_only(program, day), CK.day_only(ref, day))
        failed += not CK.judge(one.numbers(), limits)
    numbers = total.numbers()
    correct = bool(picks) and CK.judge(numbers, limits)
    result.update(correct=correct, failed=failed, metrics=metrics, device=device_info,
                  card=card, calls_checked=len(picks), check_s=time.perf_counter() - t_check,
                  captures_in_window=compiled_in_window, setup=setup,
                  walls_ms=_walls_summary(walls), **extra,
                  checks={k: {"value": numbers[k][0], "limit": limits[k],
                              "field": numbers[k][1]} for k in limits})
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    cache_dirs()
    import torch

    torch.set_num_threads(1)  # one process with one intra-op thread: the
    # host plan's copies then wait on no other thread of a shared host
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this process sees {n}",
              file=sys.stderr)
        return 2
    return emit(run(cell, args.seed, args.seconds, bool(args.trace)))


def emit(result: dict) -> int:
    """Print a run's result: the compared numbers beside their limits as
    the last lines of standard error, the JSON line last on standard
    output.  Where JAX or the JAX package is loaded by now (the window,
    the traced run and the check are over), print no result: code 3."""
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package is loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} ({c['field']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
