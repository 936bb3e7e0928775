"""Time the port as it stands in several source trees, in turns, on one card.

    python spartacus_surface_tpu_torch/tools/compare_trees.py \\
        [--walls DIR ...] [--variant NAME ...] [--out FILE]

Each DIR holds a copy of the repo (for example a ``git archive`` of another
commit unpacked under build/) and is timed end to end and on the
sweeps, as is this script's own tree.  ``--variant NAME`` adds a copy
of this script's tree with the named edit of VARIANTS applied (under
build/compare_trees/NAME), timed on the sweeps only: an experiment that
is measured here and not kept in the kernels.

First every tree's kernels are built, one process per tree, all at once.
Then one process per tree and turn runs in the order t1 .. tn tn .. t1, so
a drift of the card between turns cancels in the mean over the two turns.
Each imports the package from its own tree and measures:
- walls (not for variants): host seconds of warm kernel-route
  run_radsurf calls (SW + LW, ending in a synchronize; median, min, max of
  WALL_REPS after one) at the headline and the rami5 shapes, float32 and
  float64 (the shapes of chip_smoke.py's slices);
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
# chip_smoke.py's slices: tile types per column, layers, bands, namelist
WALL_SHAPES = {
    "headline": ([3] * 16384 + [0] * 512 + [4] * 256 + [5] * 256, 8, 1,
                 dict(n_vegetation_region_urban=1, n_stream_sw_urban=4,
                      n_stream_lw_urban=4, nsw=1, nlw=1), ("float32", "float64")),
    "rami5_shape": ([1] * 1024, 62, 14,
                    dict(n_vegetation_region_forest=2, n_stream_sw_forest=4,
                         n_stream_lw_forest=4, nsw=14, nlw=14), ("float32", "float64")),
}
# experiments on the sweeps: {name: [(file under the package, text, replacement)]}
VARIANTS = {
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


def worker(tree: Path, label: str, turn: int, walls: bool) -> dict:
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
    for sname, (nreg, ns, L, C, S, urban) in SWEEP_SHAPES.items():
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
    if walls:
        from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
        from spartacus_surface_tpu_torch.utils.config import Config
        from spartacus_surface_tpu_torch.utils.inputs import example_arrays

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


def build(tree: Path, walls: bool) -> None:
    sys.path.insert(0, str(tree))
    from concurrent.futures import ThreadPoolExecutor

    from spartacus_surface_tpu_torch.ops import cuda_build

    names = ("layer_factory", "sw_sweeps", "lw_sweeps") if walls else ("sw_sweeps", "lw_sweeps")
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
    o = ap.parse_args(argv)
    if o.build is not None:
        build(o.build, o.with_walls)
        return 0
    if o.worker is not None:
        tree, label, turn = o.worker
        print(json.dumps(worker(Path(tree), label, int(turn), o.with_walls)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("compare_trees: needs a CUDA card", file=sys.stderr)
        return 1
    trees = [(p.name, p, True) for p in o.walls] + [("this", THIS_TREE, True)]
    trees += [(name, make_variant(name), False) for name in o.variant]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--build",
                               str(path), *(["--with-walls"] if walls else [])],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _, path, walls in trees]
    for (label, _, _), proc in zip(trees, procs):
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
        for (label, path, walls), turn in order:
            res = _run(["--worker", str(path), label, str(turn),
                        *(["--with-walls"] if walls else [])], timeout=900)
            if res.returncode != 0:
                print(f"compare_trees: {label} turn {turn} failed:\n{res.stderr[-4000:]}",
                      file=sys.stderr)
                return 1
            rec = json.loads(res.stdout.strip().splitlines()[-1])
            records.append(rec)
            f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
    for label, _, _ in trees:
        turns = [r for r in records if r["tree"] == label]
        mean = {}
        for part in ("sweeps", "walls"):
            for key in turns[0].get(part, {}):
                vals = [r[part][key]["ms" if part == "sweeps" else "ms_median"] for r in turns]
                mean[f"{part} {key}"] = {"mean_ms": statistics.mean(vals), "turns_ms": vals}
        print(json.dumps({"tree": label, "mean_of_turns": mean}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
