#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (spartacus_surface_tpu_torch) on one GPU.

    python3 chip_smoke.py              # build, check, run the slice
    python3 chip_smoke.py --profile    # ... then time and trace the slice

Phases, one JSON line each (failures make the script exit nonzero before the
final line):
  1. build   - nvcc builds csrc/*.cu for sm_90a, all sources at once
     (ptxas register/spill report).
  2. kernel_vs_plain - each kernel against its plain PyTorch version on the
     same operands: K1 layer factory (its SW and its LW calls), K2 SW
     up-sweep, K3 fused SW down-sweep, K4 LW up-sweep, K5 fused LW
     down-sweep, captured from spartacus_sw + spartacus_lw for (nreg,
     nstream) in (1,2) (2,4) (3,4) (2,8) at 1024 columns x 8 layers x 2
     bands, in float32 and float64; the LW solve runs once on the uniform
     example fields and once on LW fields drawn per column, layer and band.
     Tolerances: K1 float32 elementwise rtol 2e-4 / atol 2e-5; per-field
     max|diff| / max(1, max|plain|) <= 3e-5 (K2, K3, K4) and 2e-4 (K5) in
     float32; <= 1e-9 for all in float64.  A non-finite value in either
     result fails the comparison.
  3. slice   - run_radsurf (SW + LW, as the JAX bench's step) on the CUDA
     device, kernel route against the plain scan route, in float32 and
     float64, at
       headline: 16,384 VegetatedUrban columns (nreg=2, ns=4 SW and LW) x
         8 layers x 1 band, plus 512 Flat, 256 SimpleUrban and 256
         InfiniteStreet;
       rami5_shape: 1,024 Forest columns (nreg=3, ns=4 SW and LW) x 62
         layers x 14 bands.
     Checks: field-normalized error (bench.py's metric) <= 3e-4 (SW) /
     2.5e-3 (LW) in f32, 1e-9 in f64; finite outputs of the expected
     shapes; the SW and LW energy budgets close (LW: on the layered and flat
     columns; the simple-urban LW solve keeps the reference's ground
     emissivity in its wall-wall term and does not conserve exactly); every
     kernel launched in the kernel-route run (K1 in both modes); and each
     kernel's results in that run against its plain version on the same
     operands, at the tolerances of phase 2.  Also prints each route's wall
     seconds (first call, after synchronize) and peak device memory.
  4. profile (--profile only) - for each slice run: warm wall seconds of
     both routes (median, min, max of 5 calls), and one torch.profiler trace
     of a warm kernel-route call: device launches, device busy ms (union of
     the device intervals), the device idle share of the call, and each
     kernel's device ms.
Then the per-kernel summary line {"kernels": [...]} (launches counted over
the headline float32 main-path run; ms / plain_ms timed with CUDA events on
that run's operands, K1's LW call as ms_lw / plain_ms_lw), the card's name
and power limit from nvidia-smi, and the final {"ok": true, "device": {...}}
line.

Inputs are random from fixed numpy seeds (spartacus_surface_tpu_torch/utils/
inputs.py); nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

ENTRY_CONFIGS = ((1, 2), (2, 4), (3, 4), (2, 8))  # (nreg, nstream)
SOURCES = ("layer_factory", "sw_sweeps", "lw_sweeps")  # csrc/<name>.cu
# (name, source, TPU kernel replaced, device symbol, solver wrappers)
KERNELS = (
    ("K1 layer_factory", "spartacus_surface_tpu_torch/csrc/layer_factory.cu",
     "spartacus_surface_tpu/ops/pallas_layer.py:788", "layer_factory_kernel",
     ("layer_factory", "lw_layer_factory")),
    ("K2 sw_up_sweep", "spartacus_surface_tpu_torch/csrc/sw_sweeps.cu",
     "spartacus_surface_tpu/ops/pallas_sweep.py:783", "sw_up_kernel",
     ("sw_up_sweep",)),
    ("K3 sw_down_sweep_both", "spartacus_surface_tpu_torch/csrc/sw_sweeps.cu",
     "spartacus_surface_tpu/ops/pallas_sweep.py:842", "sw_down_kernel",
     ("sw_down_sweep_both",)),
    ("K4 lw_up_sweep", "spartacus_surface_tpu_torch/csrc/lw_sweeps.cu",
     "spartacus_surface_tpu/ops/pallas_sweep.py:964", "lw_up_kernel",
     ("lw_up_sweep",)),
    ("K5 lw_down_sweep_both", "spartacus_surface_tpu_torch/csrc/lw_sweeps.cu",
     "spartacus_surface_tpu/ops/pallas_sweep.py:1020", "lw_down_kernel",
     ("lw_down_sweep_both",)),
)
WRAPPERS = tuple(n for k in KERNELS for n in k[4])
# float32 per-field bar of each sweep kernel (tests/test_pallas_sweep.py:25,
# 94); K1 is held elementwise
SWEEP_TOL_F32 = {"sw_up_sweep": 3e-5, "sw_down_sweep_both": 3e-5,
                 "lw_up_sweep": 3e-5, "lw_down_sweep_both": 2e-4}
FAILURES = []


def emit(**record):
    print(json.dumps(record), flush=True)


def check(ok, what):
    if not ok:
        FAILURES.append(what)
    return bool(ok)


def field_err(ref, got):
    """Worst per-field max|got - ref| / max(1, max|ref|, max|got|); inf if
    either side holds a non-finite value."""
    worst = 0.0
    for r, g in zip(ref, got):
        r, g = r.double(), g.double()
        if not (r.isfinite().all() and g.isfinite().all()):
            return math.inf
        scale = max(1.0, r.abs().max().item(), g.abs().max().item())
        worst = max(worst, (r - g).abs().max().item() / scale)
    return worst


class Capture:
    """Record the operands and results of every call of the solver's kernel
    wrappers, {wrapper name: [(args, kwargs, result), ...]} (the wrappers
    themselves run unchanged)."""

    def __init__(self, solver):
        self.solver, self.calls = solver, {n: [] for n in WRAPPERS}

    def __enter__(self):
        self.saved = {n: getattr(self.solver, n) for n in WRAPPERS}
        for name, fn in self.saved.items():
            def rec(*a, _n=name, _fn=fn, **k):
                out = _fn(*a, **k)
                self.calls[_n].append((a, k, out))
                return out
            setattr(self.solver, name, rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.solver, name, fn)


def max_abs_diff(ref, got):
    """max|got - ref| over the fields; NaN counts as inf."""
    return max((g - r).abs().nan_to_num(nan=math.inf).max().item()
               for r, g in zip(ref, got))


def plain_versions(LK, SK, LSK):
    """{wrapper name: its plain PyTorch version}."""
    return {"layer_factory": LK.layer_factory_plain,
            "lw_layer_factory": LK.lw_layer_factory_plain,
            "sw_up_sweep": SK.sw_up_sweep_plain,
            "sw_down_sweep_both": SK.sw_down_sweep_plain,
            "lw_up_sweep": LSK.lw_up_sweep_plain,
            "lw_down_sweep_both": LSK.lw_down_sweep_plain}


def compare_call(name, plain, a, k, got, f32):
    """(max_abs_err, passed) of one captured kernel result against the plain
    version on the same operands."""
    import torch

    ref = plain(*a, **k)
    if isinstance(ref, dict):  # K1: the factory's named outputs
        names = list(ref)
        ref, got = [ref[n] for n in names], [got[n] for n in names]
        if f32:
            ok = (field_err(ref, got) < math.inf
                  and all(torch.allclose(g, r, rtol=2e-4, atol=2e-5)
                          for r, g in zip(ref, got)))
            return max_abs_diff(ref, got), ok
    return max_abs_diff(ref, got), field_err(ref, got) <= (
        SWEEP_TOL_F32[name] if f32 else 1e-9)


def compare_kernels(calls, dtype, LK, SK, LSK):
    """Per kernel of KERNELS, (max_abs_err, passed) over every captured call
    of its wrappers against the plain versions on the same operands; (None,
    None) for a kernel with no call."""
    import torch

    plains = plain_versions(LK, SK, LSK)
    out = []
    for *_, names in KERNELS:
        res = [compare_call(n, plains[n], a, k, got, dtype == torch.float32)
               for n in names for a, k, got in calls.get(n, ())]
        out.append((max(e for e, _ in res), all(ok for _, ok in res))
                   if res else (None, None))
    return out


def time_ms(fn, reps=3):
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_seconds(fn, reps=5):
    """(median, min, max) host seconds of warm calls, each ending in a
    synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), min(walls), max(walls)


def trace_call(fn):
    """Trace one warm call with torch.profiler: device launches, device busy
    ms (the union of the device intervals), the device idle share of the
    call (from its host start to its last device activity), and each
    kernel's device ms.  The profiler slows the host side, so the idle
    share is an upper bound for an untraced call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_call"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    call = next(e for e in events if e.name == "chip_smoke_call"
                and e.device_type == DeviceType.CPU)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.name != "chip_smoke_call")
    busy, reach = 0.0, -math.inf
    for t0, t1 in spans:
        busy += max(0.0, t1 - max(t0, reach))
        reach = max(reach, t1)
    span = max(call.time_range.end, reach) - call.time_range.start
    kernel_ms = {
        kname: sum(e.time_range.elapsed_us() for e in events
                   if e.device_type == DeviceType.CUDA and sym in e.name) / 1e3
        for kname, _, _, sym, _ in KERNELS}
    return dict(device_launches=len(spans), device_busy_ms=busy / 1e3,
                traced_call_ms=span / 1e3,
                device_idle_share=(1.0 - busy / span) if spans else None,
                kernel_device_ms=kernel_ms)


def group_err(out_s, out_k, groups):
    """field_err over every field of the given result groups."""
    keys = [(g, k) for g in groups for k in out_s[g]]
    return field_err([out_s[g][k] for g, k in keys],
                     [out_k[g][k] for g, k in keys]), keys


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--profile", action="store_true",
                      help="also time both routes warm and trace the kernel route")
    profile = args.parse_args(argv).profile
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run"
              " needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from spartacus_surface_tpu_torch.models import solver
    from spartacus_surface_tpu_torch.models.dispatch import (
        TILE_INFINITE_STREET, TILE_SIMPLE_URBAN, run_radsurf)
    from spartacus_surface_tpu_torch.models.flux_utils import (
        budget_components, budget_residual)
    from spartacus_surface_tpu_torch.ops import cuda_build
    from spartacus_surface_tpu_torch.ops import layer_kernel as LK
    from spartacus_surface_tpu_torch.ops import lw_sweep_kernels as LSK
    from spartacus_surface_tpu_torch.ops import sweep_kernels as SK
    from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss
    from spartacus_surface_tpu_torch.utils.config import Config
    from spartacus_surface_tpu_torch.utils.inputs import (
        example_arrays, example_inputs, random_lw_fields)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    counters = (LK.layer_factory, SK.sw_up_sweep, SK.sw_down_sweep_both,
                LSK.lw_up_sweep, LSK.lw_down_sweep_both, LK.lw_layer_factory)
    dtypes = {"float32": (np.float32, torch.float32),
              "float64": (np.float64, torch.float64)}

    # ---- 1. build, one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(cuda_build.load, SOURCES))
    ptxas = {name: [line.split(":", 1)[-1].strip()
                    for line in log.splitlines()
                    if "entry function" in line or "Used" in line
                    or "spill" in line]
             for name, log in cuda_build.build_log.items()}
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds=cuda_build.build_seconds, ptxas=ptxas)

    # ---- 2. each kernel against its plain version, 1024 columns x 8 layers
    C2, L2, S2 = 1024, 8, 2
    for nreg, ns in ENTRY_CONFIGS:
        for dname, (np_dt, dt) in dtypes.items():
            to_dev = lambda d: solver.CanopyInputs(**{
                k: torch.as_tensor(v, device=dev) for k, v in d.items()})
            lw = example_inputs(C=C2, L=L2, S=S2, dtype=np_dt, lw=True)
            opt = solver.SolverOptions(nreg=nreg, nstream=ns, do_urban=True)
            lg = LegendreGauss(ns)
            for fields in ("uniform", "random_lw"):
                with Capture(solver) as cap:
                    if fields == "uniform":
                        solver.spartacus_sw(to_dev(example_inputs(
                            C=C2, L=L2, S=S2, dtype=np_dt)), opt, lg)
                        solver.spartacus_lw(to_dev(lw), opt, lg)
                    else:
                        solver.spartacus_lw(to_dev({**lw, **random_lw_fields(
                            C2, L2, S2, np_dt, seed=nreg * ns)}), opt, lg)
                torch.cuda.synchronize()
                res = compare_kernels(cap.calls, dt, LK, SK, LSK)
                for (err, ok), kern in zip(res, KERNELS):
                    if ok is not None:
                        check(ok, f"{kern[0]} vs plain, nreg={nreg} ns={ns}"
                                  f" {dname} {fields}")
                emit(phase="kernel_vs_plain", config=f"nreg{nreg}_ns{ns}",
                     dtype=dname, lw_fields=fields,
                     max_abs_err=[r[0] for r in res],
                     passed=[r[1] for r in res])
                del cap

    # ---- 3. the slice through run_radsurf at realistic size, SW + LW
    C_head = 16384
    slices = {
        "headline": (
            np.array([3] * C_head + [0] * 512 + [4] * 256 + [5] * 256), 8, 1,
            dict(n_vegetation_region_urban=1, n_stream_sw_urban=4,
                 n_stream_lw_urban=4, nsw=1, nlw=1)),
        "rami5_shape": (
            np.array([1] * 1024), 62, 14,
            dict(n_vegetation_region_forest=2, n_stream_sw_forest=4,
                 n_stream_lw_forest=4, nsw=14, nlw=14)),
    }
    runs = [(sname, dname, Config(do_lw=True, **cfg).consolidate(), rep, L, S)
            for sname, (rep, L, S, cfg) in slices.items() for dname in dtypes]
    sw_groups = ("sw_norm_dir", "sw_norm_diff")
    lw_groups = ("lw_internal", "lw_norm")
    for sname, dname, config, rep, L, S in runs:
        np_dt, dt = dtypes[dname]
        arrays = example_arrays(C=len(rep), L=L, S=S, dtype=np_dt,
                                i_representation=rep)
        for w in counters:
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with Capture(solver) as cap:
            out_k = run_radsurf(config, arrays, dev)
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        mem_kernel = torch.cuda.max_memory_allocated() / 2**30
        launches = [w.launches for w in counters]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out_s = run_radsurf(config, arrays, dev, route="scan")
        torch.cuda.synchronize()
        t_scan = time.perf_counter() - t0
        mem_scan = torch.cuda.max_memory_allocated() / 2**30

        for g in ("sw", "lw"):  # bc_out as two result groups
            out_s[f"bc_{g}"] = {k: v for k, v in out_s["bc_out"].items()
                                if k.startswith(g)}
            out_k[f"bc_{g}"] = {k: v for k, v in out_k["bc_out"].items()
                                if k.startswith(g)}
        err_sw, keys_sw = group_err(out_s, out_k, sw_groups + ("bc_sw",))
        err_lw, keys_lw = group_err(out_s, out_k, lw_groups + ("bc_lw",))
        got = [out_k[g][k] for g, k in keys_sw + keys_lw]
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        shapes = (all(set(out_k[g]) == set(out_s[g])
                      for g in sw_groups + lw_groups)
                  and all(out_k[g][k].shape == out_s[g][k].shape
                          for g, k in keys_sw + keys_lw)
                  and out_k["bc_out"]["sw_albedo"].shape == (len(rep), S)
                  and out_k["bc_out"]["lw_emission"].shape == (len(rep), S))
        resid_sw = max(
            budget_residual(budget_components(out_k[g], rep)).abs().max().item()
            for g in sw_groups)
        conserving = torch.as_tensor(
            ~np.isin(rep, [TILE_SIMPLE_URBAN, TILE_INFINITE_STREET]), device=dev)
        resid_lw = [
            (budget_residual(budget_components(out_k[g], rep)).abs()
             * conserving).max().item() for g in lw_groups]
        emission_scale = max(1.0, float(np.abs(arrays["ground_emission"]).max()))
        del out_k, out_s, got
        kernel_errs = compare_kernels(cap.calls, dt, LK, SK, LSK)
        f32 = dname == "float32"
        tag = f"{sname} {dname}"
        check(err_sw <= (3e-4 if f32 else 1e-9),
              f"{tag}: SW kernel route vs scan route {err_sw:.3e}")
        check(err_lw <= (2.5e-3 if f32 else 1e-9),
              f"{tag}: LW kernel route vs scan route {err_lw:.3e}")
        check(finite and shapes, f"{tag}: non-finite or misshapen output")
        check(resid_sw <= (1e-4 if f32 else 1e-10),
              f"{tag}: SW energy budget residual {resid_sw:.3e}")
        lw_tols = ((1e-4 * emission_scale,) * 2 if f32 else (1e-9, 1e-10))
        for g, r, tol in zip(lw_groups, resid_lw, lw_tols):
            check(r <= tol, f"{tag}: {g} energy budget residual {r:.3e}")
        check(all(n > 0 for n in launches),
              f"{tag}: a kernel was not launched {launches}")
        for (e, ok), kern in zip(kernel_errs, KERNELS):
            check(ok, f"{tag}: {kern[0]} vs plain {e}")
        emit(phase="slice", run=sname, dtype=dname, columns=len(rep),
             layers=L, bands=S, sw_field_normalized_err=err_sw,
             lw_field_normalized_err=err_lw, max_sw_budget_residual=resid_sw,
             max_lw_budget_residual=dict(zip(lw_groups, resid_lw)),
             launches=dict(zip([k[0] for k in KERNELS] + ["K1 LW mode"],
                               launches)),
             kernel_vs_plain_max_abs_err=[e for e, _ in kernel_errs],
             kernel_vs_plain_passed=[ok for _, ok in kernel_errs],
             seconds_kernel_route=t_kernel, seconds_scan_route=t_scan,
             peak_gib_kernel_route=mem_kernel, peak_gib_scan_route=mem_scan,
             finite=finite, shapes_ok=shapes)
        if sname == "headline" and f32:  # the main path
            main_launches, errs = launches, kernel_errs
            wrappers = {n: getattr(solver, n) for n in WRAPPERS}
            plains = plain_versions(LK, SK, LSK)
            timings = {}
            for n in WRAPPERS:
                a, k, _ = cap.calls[n][0]
                timings[n] = (time_ms(lambda: wrappers[n](*a, **k)),
                              time_ms(lambda: plains[n](*a, **k)))
        del cap
        torch.cuda.empty_cache()

    # ---- 4. warm wall times and a device trace of each slice run
    if profile:
        for sname, dname, config, rep, L, S in runs:
            arrays = example_arrays(C=len(rep), L=L, S=S,
                                    dtype=dtypes[dname][0], i_representation=rep)
            walls = {route: wall_seconds(
                lambda: run_radsurf(config, arrays, dev, route=route))
                for route in ("kernel", "scan")}
            emit(phase="profile", run=sname, dtype=dname,
                 **{f"seconds_{r}_route": w for r, w in walls.items()},
                 **trace_call(lambda: run_radsurf(config, arrays, dev)))
            torch.cuda.empty_cache()

    rows = []
    for (kname, src, rep, _, names), n, e in zip(KERNELS, main_launches, errs):
        row = {"name": kname, "route": "cuda", "source": src, "replaces": rep,
               "launches": n, "max_abs_err": e[0], "ms": timings[names[0]][0],
               "plain_ms": timings[names[0]][1]}
        if len(names) > 1:  # K1: its LW call
            row.update(launches_lw=main_launches[-1],
                       ms_lw=timings[names[1]][0],
                       plain_ms_lw=timings[names[1]][1])
        rows.append(row)
    emit(kernels=rows)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    if FAILURES:
        for f in FAILURES:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
