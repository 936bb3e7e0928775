"""Time the port as it stands in several source trees, in turns, on one card.

    python spartacus_surface_tpu_torch/tools/compare_trees.py \\
        [--walls DIR ...] [--variant NAME ...] [--out FILE]

Each DIR holds a copy of the repo (for example a ``git archive`` of another
commit unpacked under build/) and is timed end to end, on the sweeps and
on the dense factory, as is this script's own tree.  ``--variant NAME``
adds a copy of this script's tree with the named edit of VARIANTS applied
(under build/compare_trees/NAME), timed on what it edits only (the dense
factory where it edits csrc/layer_factory.cu alone, else the sweeps): an
experiment that is measured here and not kept in the kernels.

First every tree's kernels are built, one process per tree, all at once.
Then one process per tree and turn runs in the order t1 .. tn tn .. t1, so
a drift of the card between turns cancels in the mean over the two turns.
Each imports the package from its own tree and measures:
- walls (not for variants): host seconds of warm kernel-route
  run_radsurf calls (SW + LW, ending in a synchronize; median, min, max of
  WALL_REPS after one) at the headline, rami5 and rami5_ns1 shapes (those
  of chip_smoke.py's slices) and the cli_ns1 shape (its CLI's columns at
  1 stream), float32 and float64;
- factory: K1d (layer_factory where is_structured is false) on the
  operands of one kernel-route run_radsurf at the cli_ns1 and rami5_ns1
  shapes, float32 and float64, captured from the tree's own solver: its SW
  call with the largest operands (cli_ns1: the Forest tiles', nd = 3) and
  its LW call (where one is dense), device ms per call
  as for the sweeps and the kernel's own (device_ms: its summed durations
  in a torch.profiler trace, without the wrapper's other launches and host
  work), the field-normalized error against the tree's plain
  version and, where the tree reports it (layer_kernel.factory_config for
  K1d), the launch shape;
- sweeps: K2 (sw_up_sweep), K3 (sw_down_sweep_both), K4 (lw_up_sweep)
  and K5 (lw_down_sweep_both) through their public wrappers on seeded
  operands on the card (no solver: the sweeps' work does not depend on the
  values; K3 / K5 read the stacks the tree's own K2 / K4 wrote), at the
  headline and the rami5 shapes, float32 and float64: device ms per call
  (CUDA events over SWEEP_REPS back-to-back calls after a warm-up), the
  field-normalized error against the tree's own plain version (an edit that
  breaks a kernel shows here; the no_stack_stores variant breaks K2 / K4 on
  purpose) and, where the tree reports it (sweep_kernels.up_config,
  down_config), the launch shape (registers, shared bytes and blocks per SM, resident teams per SM,
  waves).
Each process prints one JSON line; the script prints, per tree, the mean of
its two turns, then the card's name and power limit, and writes every line
to --out (default build/compare_trees/results.jsonl).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

THIS_TREE = Path(__file__).resolve().parents[2]
WORK = THIS_TREE / "build" / "compare_trees"
WALL_REPS = 10
SWEEP_REPS = 5
SHAPE_KEYS = ("registers", "smem_per_block", "blocks_per_sm", "resident_per_sm", "waves")
# (nreg, ns, layers, columns, bands, do_urban) of the sweeps at each shape
SWEEP_SHAPES = {"headline": (2, 4, 8, 16384, 1, True),
                "rami5_shape": (3, 4, 62, 1024, 14, False)}
# chip_smoke.py's slices and the CLI's columns at 1 stream: tile types per
# column, layers, bands, namelist
CLI_COLUMNS = [3] * 8192 + [1] * 4096 + [2] * 4096 + [0] * 512 + [4] * 256 + [5] * 256
ONE_STREAM = dict(n_stream_sw_forest=1, n_stream_sw_urban=1, n_stream_lw_forest=1,
                  n_stream_lw_urban=1)
WALL_SHAPES = {
    "headline": ([3] * 16384 + [0] * 512 + [4] * 256 + [5] * 256, 8, 1,
                 dict(n_vegetation_region_urban=1, n_stream_sw_urban=4,
                      n_stream_lw_urban=4, nsw=1, nlw=1), ("float32", "float64")),
    "rami5_shape": ([1] * 1024, 62, 14,
                    dict(n_vegetation_region_forest=2, n_stream_sw_forest=4,
                         n_stream_lw_forest=4, nsw=14, nlw=14), ("float32", "float64")),
    "cli_ns1": (CLI_COLUMNS, 8, 1,
                dict(ONE_STREAM, n_vegetation_region_forest=2, n_vegetation_region_urban=1,
                     nsw=1, nlw=1), ("float32", "float64")),
    "rami5_ns1": ([1] * 1024, 62, 14,
                  dict(ONE_STREAM, n_vegetation_region_forest=2, nsw=14, nlw=14),
                  ("float32", "float64")),
}
FACTORY_SHAPES = ("cli_ns1", "rami5_ns1")  # the dense factory's (K1d's) shapes
FACTORY_REPS = 5
# experiments on the kernels: {name: [(file under the package, text, replacement)]}
VARIANTS = {
    # K1d's team size the power of two >= N = 2 nd + ndir (4, 8, 16 at the
    # solver's N = 3, 6, 9) rather than >= nd
    "dense_ts_n": [
        ("csrc/layer_factory.cu",
         "  if (A.nd <= 1) return run_k1d<T, 1>(A, s, info, configure);\n"
         "  if (A.nd <= 2) return run_k1d<T, 2>(A, s, info, configure);\n"
         "  return run_k1d<T, 4>(A, s, info, configure);\n",
         "  const int N = 2 * A.nd + A.ndir;\n"
         "  if (N <= 4) return run_k1d<T, 4>(A, s, info, configure);\n"
         "  if (N <= 8) return run_k1d<T, 8>(A, s, info, configure);\n"
         "  return run_k1d<T, 16>(A, s, info, configure);\n"),
    ],
    # K1d stops after the size-N solve (assembly, norm, Pade), or after the
    # extraction and doubling (before the Schur integrals): the time of each
    # stage by difference (their results are not written)
    "dense_stop_after_pade": [
        ("csrc/layer_factory.cu", "  tsolve(tm, W1, F, N, N);  // F = expm(Gamma dz 2^-K)\n",
         "  tsolve(tm, W1, F, N, N);  // F = expm(Gamma dz 2^-K)\n  if (A.n > 0) return;\n"),
    ],
    "dense_stop_after_extract": [
        ("csrc/layer_factory.cu",
         "op(A.R, n2, nd), op(A.Tm, n2, nd), op(A.E, d2, ndir),\n"
         "                          op(A.Sup, nr, ndir), op(A.Sdn, nr, ndir));\n",
         "op(A.R, n2, nd), op(A.Tm, n2, nd), op(A.E, d2, ndir),\n"
         "                          op(A.Sup, nr, ndir), op(A.Sdn, nr, ndir));\n"
         "  if (A.n > 0) return;\n"),
    ],
    # K1d's team products keep at most 9 entries of a row in registers
    # (N <= 9) rather than 16
    "dense_cap9": [
        ("csrc/layer_factory.cu", "#define SPX_DENSE_CAP 16", "#define SPX_DENSE_CAP 9"),
    ],
    # K1d's N x N Pade products compute three entries of a row at once
    # (three independent sums)
    "dense_ju3": [
        ("csrc/layer_factory.cu", "  tmm<TS, CAP>(tm, W1, G, G, N, N, N);    // A2",
         "  tmm<TS, CAP, 3>(tm, W1, G, G, N, N, N);    // A2"),
        ("csrc/layer_factory.cu", "  tmm<TS, CAP>(tm, W2, W1, W1, N, N, N);  // A4",
         "  tmm<TS, CAP, 3>(tm, W2, W1, W1, N, N, N);  // A4"),
        ("csrc/layer_factory.cu", "  tmm<TS, CAP>(tm, W3, W1, W2, N, N, N);  // A6",
         "  tmm<TS, CAP, 3>(tm, W3, W1, W2, N, N, N);  // A6"),
        ("csrc/layer_factory.cu", "  tmm<TS, CAP>(tm, W2, G, W3, N, N, N);  // U",
         "  tmm<TS, CAP, 3>(tm, W2, G, W3, N, N, N);  // U"),
    ],
    # K2 and K4 read their operands from device memory (no copy-ahead, and
    # no shared memory for its buffers)
    "direct_reads": [
        ("csrc/common.cuh", "  constexpr bool AHEAD = !GLOBAL;",
         "  constexpr bool AHEAD = false;"),
        ("csrc/sw_sweeps.cu", "2 * spx::sw_up_operands(A).total(), A.B, info);",
         "0, A.B, info);"),
        ("csrc/lw_sweeps.cu", "2 * spx::lw_up_operands(A).total(), A.B, info);",
         "0, A.B, info);"),
    ],
    # each warp copies a per-column overlap row (uov, vov) once per column
    # its elements span, instead of once per element
    "uv_once": [
        ("csrc/common.cuh",
         "      return ShS<T>{buf + ((l & 1) * total + off[s]) * ew + e, ew};",
         "      const long long f = ops.per_col[s] ? b / S * S - b0 : e;\n"
         "      return ShS<T>{buf + ((l & 1) * total + off[s]) * ew + (int)(f > 0 ? f : 0),"
         " ew};"),
        ("csrc/common.cuh",
         "        if (ops.per_col[s]) x /= S;\n",
         "        if (ops.per_col[s]) {\n"
         "          x /= S;\n"
         "          if (k > 0 && x == (b0 + k - 1 < B ? b0 + k - 1 : B - 1) / S) continue;\n"
         "        }\n"),
    ],
    # K3 and K5 copy nothing ahead (their slots hold what they hold): the
    # time of their arithmetic and stores alone
    "no_copy": [
        ("csrc/common.cuh", "__pipeline_memcpy_async(dst + i * ld + c, src, sizeof(T));",
         "(void)dst;"),
    ],
    # K2 and K4 store no stack rows (nor the top): the most that any way of
    # storing them (staging through shared memory) could save
    "no_stack_stores": [
        ("csrc/sw_sweeps.cu", "  tm.sync();\n  rd.start();\n",
         "  tm.sync();\n  rd.start();\n  valid = false;\n"),
        ("csrc/lw_sweeps.cu", "  tm.sync();\n  rd.start();\n",
         "  tm.sync();\n  rd.start();\n  valid = false;\n"),
    ],
}


def times_factory(name: str) -> bool:
    """Whether the variant is timed on the dense factory (it edits
    csrc/layer_factory.cu alone), not on the sweeps."""
    return all(rel == "csrc/layer_factory.cu" for rel, _, _ in VARIANTS[name])


def make_variant(name: str, work: Path = WORK) -> Path:
    """A copy of this tree's package under work/name with VARIANTS[name]
    applied (each text must occur exactly once); returns work/name."""
    root = work / name
    pkg = root / "spartacus_surface_tpu_torch"
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(THIS_TREE / "spartacus_surface_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in VARIANTS[name]:
        path = pkg / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {rel} holds the text to edit"
                               f" {text.count(old)} times, not once")
        path.write_text(text.replace(old, new))
    return root


# ----------------------------------------------------------------------
# a worker: one tree, one turn (imports the package from its tree)
# ----------------------------------------------------------------------

def _ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, symbol, calls):
    """Device ms per call of the kernels whose name holds `symbol`: their
    summed durations in one torch.profiler trace of `calls` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation
               and symbol in e.name) / 1e3 / calls


def _field_err(ref, got):
    worst = 0.0
    for r, g in zip(ref, got):
        r, g = r.double(), g.double()
        if not (r.isfinite().all() and g.isfinite().all()):
            return math.inf
        worst = max(worst, (r - g).abs().max().item() / max(1.0, r.abs().max().item()))
    return worst


def up_operands(mode, nreg, ns, L, C, S, dtype, dev, seed):
    """Seeded operands of one K2 (mode "sw") or K4 ("lw") call, made on
    `dev`, in the ranges of tests/test_torch_kernels.py's Pallas check."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    nd, nregp, B = nreg * ns, nreg + 1, C * S

    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev, dtype=dtype) * (hi - lo) + lo

    R, T = u(L, nd * nd, B, hi=0.5 / nd), u(L, nd * nd, B, hi=0.5 / nd)
    cols = (u(L, nreg * nregp, C, hi=1.0 / nregp), u(L, nregp * nreg, C, hi=1.0 / nregp))
    if mode == "sw":
        return (R, T, u(L, nreg * nreg, B), u(L, nd * nreg, B, hi=0.2),
                u(L, nd * nreg, B, hi=0.2), *cols, u(L, B), u(L, B),
                torch.cat([u(2, B), u(1, B, lo=0.2)]))
    return (R, T, u(L, nd, B, hi=50.0), *cols, u(L, B, lo=0.5), u(L, B, hi=400.0),
            u(L, B), torch.cat([u(1, B, lo=0.5), u(1, B, hi=400.0), u(nreg, B)]))


def down_operands(mode, nreg, ns, up_args, stacks, dtype, dev, seed):
    """Seeded operands of one K3 (mode "sw") or K5 ("lw") call on the layer
    operators of up_operands' call (up_args) and the stacks its K2 / K4
    wrote, in the ranges of tests/test_torch_kernels.py's Pallas check,
    with the quadrature of ns streams."""
    import torch

    from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    nd, nod = nreg * ns, max(nreg - 1, 1)
    L, _, B = up_args[0].shape

    def u(*shape, hi=1.0):
        return torch.rand(shape, generator=g, device=dev, dtype=dtype) * hi

    lg = LegendreGauss(ns)
    quad = tuple(torch.as_tensor(x, dtype=dtype, device=dev)
                 for x in (lg.hweight, 1.0 / lg.mu, lg.tan_ang))
    if mode == "sw":
        R, T, E, _, Sdn, _, vov, _, _, grd = up_args[:10]
        return (R, T, E, Sdn, u(L, nreg * nreg, B, hi=0.5), u(L, nd * nd, B, hi=0.5 / nd),
                u(L, nd * nreg, B, hi=0.2), stacks, vov, u(L, nreg + nod + 3, B),
                grd[2].contiguous(), *quad)
    R, T, p, _, vov = up_args[:5]
    aux = torch.cat([u(L, nreg + nod + 3, B), u(L, 4, B, hi=400.0)], dim=1)
    return (R, T, p, u(L, nd * nd, B, hi=0.5 / nd), u(L, nd, B, hi=50.0), stacks, vov,
            aux, *quad)


def _dense_calls(solver, LK, run):
    """{"sw": (args, kwargs) of the largest K1d call of the SW factory, "lw":
    the first K1d call of the LW factory} of run() (absent: no K1d call),
    recorded on the tree's solver."""
    calls = {"layer_factory": [], "lw_layer_factory": []}
    saved = {n: getattr(solver, n) for n in calls}

    def recorder(name, fn):
        def rec(*a, **k):
            calls[name].append((a, k))
            return fn(*a, **k)
        return rec

    for n, fn in saved.items():
        setattr(solver, n, recorder(n, fn))
    try:
        run()
    finally:
        for n, fn in saved.items():
            setattr(solver, n, fn)
    dense = {n: [(a, k) for a, k in c if not LK.is_structured(k["nd"], k.get("ndir", 1))]
             for n, c in calls.items()}
    out = {}
    if dense["layer_factory"]:
        out["sw"] = max(dense["layer_factory"], key=lambda c: c[0][1].numel())
    if dense["lw_layer_factory"]:
        out["lw"] = dense["lw_layer_factory"][0]
    return out


def worker(tree: Path, label: str, turn: int, walls: bool, parts=("sweeps", "factory")) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import spartacus_surface_tpu_torch as pkg
    from spartacus_surface_tpu_torch.ops import cuda_build
    from spartacus_surface_tpu_torch.ops import lw_sweep_kernels as LSK
    from spartacus_surface_tpu_torch.ops import sweep_kernels as SK
    from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss

    assert Path(pkg.__file__).resolve().parents[1] == tree.resolve(), pkg.__file__
    dev = torch.device("cuda")
    dtypes = {"float32": torch.float32, "float64": torch.float64}
    rec = {"tree": label, "turn": turn, "sweeps": {}}
    for sname, (nreg, ns, L, C, S, urban) in (SWEEP_SHAPES.items() if "sweeps" in parts
                                              else ()):
        hw = LegendreGauss(ns).hweight
        kw = dict(nd=nreg * ns, ns=ns, nreg=nreg)
        dkw = dict(kw, do_urban=urban, with_profiles=False)
        for dname, dt in dtypes.items():
            for mode, mod in (("sw", SK), ("lw", LSK)):
                a = (*up_operands(mode, nreg, ns, L, C, S, dt, dev, seed=7),
                     torch.as_tensor(hw, dtype=dt, device=dev))
                up, down = getattr(mod, f"{mode}_up_sweep"), getattr(mod, f"{mode}_down_sweep_both")
                d = down_operands(mode, nreg, ns, a, up(*a, **kw)[0], dt, dev, seed=8)
                lib = cuda_build.load(f"{mode}_sweeps")
                for k, fn, args, kws, plain, config in (
                        ("K2" if mode == "sw" else "K4", up, a, kw, f"{mode}_up_sweep_plain",
                         hasattr(SK, "up_config") and (lambda: SK.up_config(
                             lib, f"{mode}_up_sweep", kw["nd"], ns, nreg, C * S, dt))),
                        ("K3" if mode == "sw" else "K5", down, d, dkw,
                         f"{mode}_down_sweep_plain",
                         hasattr(SK, "down_config") and (lambda: SK.down_config(
                             lib, f"{mode}_down_sweep", kw["nd"], ns, nreg, urban, False,
                             C * S, dt)))):
                    ms = _ms(lambda: fn(*args, **kws), SWEEP_REPS)
                    err = _field_err(getattr(mod, plain)(*args, **kws), fn(*args, **kws))
                    row = rec["sweeps"][f"{k} {sname} {dname}"] = {"ms": ms, "err": err}
                    if config:  # the launch shape, where the tree reports it
                        row.update({key: config()[key] for key in SHAPE_KEYS})
                del a, d
                torch.cuda.empty_cache()
    from spartacus_surface_tpu_torch.models import solver
    from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
    from spartacus_surface_tpu_torch.ops import layer_kernel as LK
    from spartacus_surface_tpu_torch.utils.config import Config
    from spartacus_surface_tpu_torch.utils.inputs import example_arrays

    if "factory" in parts:
        rec["factory"] = {}
        lib = cuda_build.load("layer_factory")
        for sname in FACTORY_SHAPES:
            rep, L, S, cfg, dnames = WALL_SHAPES[sname]
            config = Config(do_lw=True, **cfg).consolidate()
            for dname in dnames:
                arrays = example_arrays(C=len(rep), L=L, S=S, dtype=getattr(np, dname),
                                        i_representation=np.array(rep))
                calls = _dense_calls(solver, LK, lambda: run_radsurf(config, arrays, dev))
                for mode, (a, k) in calls.items():
                    fn = getattr(LK, "layer_factory" if mode == "sw" else "lw_layer_factory")
                    plain = getattr(LK, f"{fn.__name__}_plain")
                    ms = _ms(lambda: fn(*a, **k), FACTORY_REPS)
                    got, ref = fn(*a, **k), plain(*a, **k)
                    row = rec["factory"][f"K1d {mode} {sname} {dname}"] = {
                        "ms": ms, "err": _field_err([ref[n] for n in ref], [got[n] for n in ref]),
                        "device_ms": _device_ms(lambda: fn(*a, **k), "layer_factory_dense_kernel",
                                                FACTORY_REPS),
                        "elements": a[1].shape[0] * a[1].shape[2], "nd": k["nd"]}
                    if not hasattr(LK, "dense_workspace_rows"):  # K1d's launch shape
                        c = LK.factory_config(lib, k["nd"], k.get("ndir", 1), row["elements"],
                                              a[1].dtype)
                        row.update({key: c[key] for key in SHAPE_KEYS + ("team_size",)})
                    del got, ref
                del arrays, calls
                torch.cuda.empty_cache()
    if walls:
        rec["walls"] = {}
        for sname, (rep, L, S, cfg, dnames) in WALL_SHAPES.items():
            config = Config(do_lw=True, **cfg).consolidate()
            for dname in dnames:
                arrays = example_arrays(C=len(rep), L=L, S=S, dtype=getattr(np, dname),
                                        i_representation=np.array(rep))
                run_radsurf(config, arrays, dev)
                torch.cuda.synchronize()
                secs = []
                for _ in range(WALL_REPS):
                    t0 = time.perf_counter()
                    run_radsurf(config, arrays, dev)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                rec["walls"][f"{sname} {dname}"] = {
                    "ms_median": 1e3 * statistics.median(secs),
                    "ms_min": 1e3 * min(secs), "ms_max": 1e3 * max(secs)}
                del arrays
                torch.cuda.empty_cache()
    return rec


def build(tree: Path, parts) -> None:
    sys.path.insert(0, str(tree))
    from concurrent.futures import ThreadPoolExecutor

    from spartacus_surface_tpu_torch.ops import cuda_build

    names = ((("sw_sweeps", "lw_sweeps") if "sweeps" in parts else ())
             + (("layer_factory",) if "factory" in parts else ()))
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(cuda_build.load, names))


# ----------------------------------------------------------------------
# the main process
# ----------------------------------------------------------------------

def _run(args, timeout):
    return subprocess.run([sys.executable, str(Path(__file__).resolve()), *args],
                          capture_output=True, text=True, timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--walls", nargs="*", default=[], type=Path)
    ap.add_argument("--variant", nargs="*", default=[], choices=sorted(VARIANTS))
    ap.add_argument("--out", type=Path, default=WORK / "results.jsonl")
    ap.add_argument("--worker", nargs=3, metavar=("TREE", "LABEL", "TURN"))
    ap.add_argument("--build", type=Path)
    ap.add_argument("--with-walls", action="store_true")
    ap.add_argument("--parts", default="sweeps,factory")
    o = ap.parse_args(argv)
    parts = tuple(o.parts.split(","))
    if o.build is not None:
        build(o.build, parts)
        return 0
    if o.worker is not None:
        tree, label, turn = o.worker
        print(json.dumps(worker(Path(tree), label, int(turn), o.with_walls, parts)),
              flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("compare_trees: needs a CUDA card", file=sys.stderr)
        return 1
    both = "sweeps,factory"
    trees = [(p.name, p, True, both) for p in o.walls] + [("this", THIS_TREE, True, both)]
    trees += [(name, make_variant(name), False,
               "factory" if times_factory(name) else "sweeps") for name in o.variant]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--build",
                               str(path), "--parts", parts],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _, path, _, parts in trees]
    for (label, *_), proc in zip(trees, procs):
        err = proc.communicate()[1]
        if proc.returncode != 0:
            print(f"compare_trees: the build of {label} failed:\n{err[-4000:]}",
                  file=sys.stderr)
            return 1
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}), flush=True)
    o.out.parent.mkdir(parents=True, exist_ok=True)
    records = []
    order = [(t, 0) for t in trees] + [(t, 1) for t in reversed(trees)]
    with o.out.open("w") as f:
        for (label, path, walls, parts), turn in order:
            res = _run(["--worker", str(path), label, str(turn), "--parts", parts,
                        *(["--with-walls"] if walls else [])], timeout=900)
            if res.returncode != 0:
                print(f"compare_trees: {label} turn {turn} failed:\n{res.stderr[-4000:]}",
                      file=sys.stderr)
                return 1
            rec = json.loads(res.stdout.strip().splitlines()[-1])
            records.append(rec)
            f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
    for label, *_ in trees:
        turns = [r for r in records if r["tree"] == label]
        mean = {}
        for part in ("sweeps", "factory", "walls"):
            for key in turns[0].get(part, {}):
                vals = [r[part][key]["ms_median" if part == "walls" else "ms"] for r in turns]
                mean[f"{part} {key}"] = {"mean_ms": statistics.mean(vals), "turns_ms": vals}
                if part == "factory":
                    mean[f"{part} {key}"]["mean_device_ms"] = statistics.mean(
                        r[part][key]["device_ms"] for r in turns)
        print(json.dumps({"tree": label, "mean_of_turns": mean}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
