#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (spartacus_surface_tpu_torch) on one GPU.

    python3 chip_smoke.py              # build, check, run the slice
    python3 chip_smoke.py --profile    # ... then time and trace the slice

Phases, one JSON line each (failures make the script exit nonzero before the
final line):
  1. build   - nvcc builds csrc/*.cu for sm_90a (ptxas register/spill report).
  2. kernel_vs_plain - each kernel (K1 layer factory, K2 SW up-sweep, K3 fused
     SW down-sweep) against its plain PyTorch version on the same operands,
     for (nreg, nstream) in (1,2) (2,4) (3,4) (2,8) at 1024 columns x 8
     layers, in float32 and float64.  Tolerances: K1 float32 elementwise
     rtol 2e-4 / atol 2e-5; K2, K3 float32 per-field max|diff| / max(1,
     max|plain|) <= 3e-5; all three float64 <= 1e-9 (per-field form).  A
     non-finite value in either result fails the comparison.
  3. slice   - run_radsurf (do_lw = false) on the CUDA device, kernel route
     against the plain scan route, in float32 and float64, at
       headline: 16,384 VegetatedUrban columns (nreg=2, ns=4) x 8 layers x
         1 band, plus 512 Flat, 256 SimpleUrban and 256 InfiniteStreet;
       rami5_shape: 1,024 Forest columns (nreg=3, ns=4) x 62 layers x
         14 bands.
     Checks: field-normalized error (bench.py's metric) <= 3e-4 (f32) /
     1e-9 (f64); finite outputs of the expected shapes; the energy budget
     closes; every kernel launched in the kernel-route run; and each
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
that run's operands), the card's name and power limit from nvidia-smi, and
the final {"ok": true, "device": {...}} line.

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
KERNELS = (
    ("K1 layer_factory", "spartacus_surface_tpu_torch/csrc/layer_factory.cu",
     "spartacus_surface_tpu/ops/pallas_layer.py:788"),
    ("K2 sw_up_sweep", "spartacus_surface_tpu_torch/csrc/sw_sweeps.cu",
     "spartacus_surface_tpu/ops/pallas_sweep.py:783"),
    ("K3 sw_down_sweep_both", "spartacus_surface_tpu_torch/csrc/sw_sweeps.cu",
     "spartacus_surface_tpu/ops/pallas_sweep.py:842"),
)
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
    """Record the operands and results of the solver's three kernel calls
    (the wrappers themselves run unchanged)."""

    NAMES = ("layer_factory", "sw_up_sweep", "sw_down_sweep_both")

    def __init__(self, solver):
        self.solver, self.calls = solver, {}

    def __enter__(self):
        self.saved = {n: getattr(self.solver, n) for n in self.NAMES}
        for name, fn in self.saved.items():
            def rec(*a, _n=name, _fn=fn, **k):
                out = _fn(*a, **k)
                self.calls[_n] = (a, k, out)
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


def compare_kernels(calls, dtype, LK, SK):
    """(K1, K2, K3) (max_abs_err, passed) of the kernels' captured results
    against the plain versions on the same operands."""
    import torch

    f32 = dtype == torch.float32
    out = []
    a, k, got = calls["layer_factory"]
    ref = LK.layer_factory_plain(*a, **k)
    names = LK.OUT_NAMES
    abs_err = max_abs_diff([ref[n] for n in names], [got[n] for n in names])
    if f32:
        ok = all(torch.allclose(got[n], ref[n], rtol=2e-4, atol=2e-5) for n in names)
    else:
        ok = field_err([ref[n] for n in names], [got[n] for n in names]) <= 1e-9
    out.append((abs_err, ok))
    for name, plain in (("sw_up_sweep", SK.sw_up_sweep_plain),
                        ("sw_down_sweep_both", SK.sw_down_sweep_plain)):
        a, k, got = calls[name]
        ref = plain(*a, **k)
        abs_err = max_abs_diff(ref, got)
        out.append((abs_err, field_err(ref, got) <= (3e-5 if f32 else 1e-9)))
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
        for kname, sym in zip((k[0] for k in KERNELS), (
            "layer_factory_kernel", "sw_up_kernel", "sw_down_kernel"))}
    return dict(device_launches=len(spans), device_busy_ms=busy / 1e3,
                traced_call_ms=span / 1e3,
                device_idle_share=(1.0 - busy / span) if spans else None,
                kernel_device_ms=kernel_ms)


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
    import numpy as np

    from spartacus_surface_tpu_torch.models import solver
    from spartacus_surface_tpu_torch.models.dispatch import run_radsurf
    from spartacus_surface_tpu_torch.models.flux_utils import (
        budget_components, budget_residual)
    from spartacus_surface_tpu_torch.ops import cuda_build
    from spartacus_surface_tpu_torch.ops import layer_kernel as LK
    from spartacus_surface_tpu_torch.ops import sweep_kernels as SK
    from spartacus_surface_tpu_torch.ops.legendre_gauss import LegendreGauss
    from spartacus_surface_tpu_torch.utils.config import Config
    from spartacus_surface_tpu_torch.utils.inputs import (
        example_arrays, example_inputs)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    wrappers = (LK.layer_factory, SK.sw_up_sweep, SK.sw_down_sweep_both)
    dtypes = {"float32": (np.float32, torch.float32),
              "float64": (np.float64, torch.float64)}

    # ---- 1. build
    t0 = time.perf_counter()
    for name in ("layer_factory", "sw_sweeps"):
        cuda_build.load(name)
    ptxas = [line.split(":", 1)[-1].strip()
             for log in cuda_build.build_log.values()
             for line in log.splitlines() if "Used" in line or "spill" in line]
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds=cuda_build.build_seconds, ptxas=ptxas)

    # ---- 2. each kernel against its plain version, 1024 columns x 8 layers
    for nreg, ns in ENTRY_CONFIGS:
        for dname, (np_dt, dt) in dtypes.items():
            inp = solver.CanopyInputs(**{
                k: torch.as_tensor(v, device=dev) for k, v in
                example_inputs(C=1024, L=8, S=1, dtype=np_dt).items()})
            opt = solver.SolverOptions(nreg=nreg, nstream=ns, do_urban=True)
            with Capture(solver) as cap:
                solver.spartacus_sw(inp, opt, LegendreGauss(ns))
            torch.cuda.synchronize()
            res = compare_kernels(cap.calls, dt, LK, SK)
            for (err, ok), (kname, _, _) in zip(res, KERNELS):
                check(ok, f"{kname} vs plain, nreg={nreg} ns={ns} {dname}")
            emit(phase="kernel_vs_plain", config=f"nreg{nreg}_ns{ns}",
                 dtype=dname, max_abs_err=[r[0] for r in res],
                 passed=[r[1] for r in res])

    # ---- 3. the slice through run_radsurf at realistic size
    C_head = 16384
    slices = {
        "headline": (
            np.array([3] * C_head + [0] * 512 + [4] * 256 + [5] * 256), 8, 1,
            dict(n_vegetation_region_urban=1, n_stream_sw_urban=4, nsw=1)),
        "rami5_shape": (
            np.array([1] * 1024), 62, 14,
            dict(n_vegetation_region_forest=2, n_stream_sw_forest=4, nsw=14)),
    }
    runs = [(sname, dname, Config(do_lw=False, **cfg).consolidate(), rep, L, S)
            for sname, (rep, L, S, cfg) in slices.items() for dname in dtypes]
    for sname, dname, config, rep, L, S in runs:
        np_dt, dt = dtypes[dname]
        arrays = example_arrays(C=len(rep), L=L, S=S, dtype=np_dt,
                                i_representation=rep)
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with Capture(solver) as cap:
            out_k = run_radsurf(config, arrays, dev)
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        mem_kernel = torch.cuda.max_memory_allocated() / 2**30
        launches = [w.launches for w in wrappers]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out_s = run_radsurf(config, arrays, dev, route="scan")
        torch.cuda.synchronize()
        t_scan = time.perf_counter() - t0
        mem_scan = torch.cuda.max_memory_allocated() / 2**30

        groups = ("sw_norm_dir", "sw_norm_diff", "bc_out")
        keys = [(g, k) for g in groups for k in out_s[g]]
        ref = [out_s[g][k] for g, k in keys]
        got = [out_k[g][k] for g, k in keys]
        err = field_err(ref, got)
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        shapes = (set(out_k["sw_norm_dir"]) == set(out_s["sw_norm_dir"])
                  and all(x.shape == y.shape for x, y in zip(got, ref))
                  and out_k["bc_out"]["sw_albedo"].shape == (len(rep), S))
        resid = max(
            budget_residual(budget_components(out_k[g], rep)).abs().max().item()
            for g in ("sw_norm_dir", "sw_norm_diff"))
        del out_k, out_s, ref, got
        kernel_errs = compare_kernels(cap.calls, dt, LK, SK)
        tol = 3e-4 if dname == "float32" else 1e-9
        budget_tol = 1e-4 if dname == "float32" else 1e-10
        tag = f"{sname} {dname}"
        check(err <= tol, f"{tag}: kernel route vs scan route {err:.3e}")
        check(finite and shapes, f"{tag}: non-finite or misshapen output")
        check(resid <= budget_tol, f"{tag}: energy budget residual {resid:.3e}")
        check(all(n > 0 for n in launches), f"{tag}: a kernel was not launched")
        for (e, ok), (kname, _, _) in zip(kernel_errs, KERNELS):
            check(ok, f"{tag}: {kname} vs plain {e:.3e}")
        emit(phase="slice", run=sname, dtype=dname, columns=len(rep),
             layers=L, bands=S, field_normalized_err=err,
             max_budget_residual=resid, launches=launches,
             kernel_vs_plain_max_abs_err=[e for e, _ in kernel_errs],
             kernel_vs_plain_passed=[ok for _, ok in kernel_errs],
             seconds_kernel_route=t_kernel, seconds_scan_route=t_scan,
             peak_gib_kernel_route=mem_kernel, peak_gib_scan_route=mem_scan,
             finite=finite, shapes_ok=shapes)
        if sname == "headline" and dname == "float32":  # the main path
            main_launches, errs = launches, kernel_errs
            plains = (LK.layer_factory_plain, SK.sw_up_sweep_plain,
                      SK.sw_down_sweep_plain)
            timings = []
            for w, p, n in zip(wrappers, plains, Capture.NAMES):
                a, k, _ = cap.calls[n]
                timings.append((time_ms(lambda: w(*a, **k)),
                                time_ms(lambda: p(*a, **k))))
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

    emit(kernels=[
        {"name": kname, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "max_abs_err": e[0], "ms": t[0], "plain_ms": t[1]}
        for (kname, src, rep), n, e, t in zip(KERNELS, main_launches, errs,
                                              timings)])
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
