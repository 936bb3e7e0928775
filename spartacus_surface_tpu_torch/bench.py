"""The port's benchmark: columns/s of the SW + LW solve on one card, gated by
the checks that make the number worth having.

    python3 -m spartacus_surface_tpu_torch.bench            # every block, on the card
    python3 -m spartacus_surface_tpu_torch.bench --trace    # + per-layer device ms
    python3 -m spartacus_surface_tpu_torch.bench --block parity --block headline
    python3 -m spartacus_surface_tpu_torch.bench --device cpu --block mesh   # plain versions

Port of bench.py (the JAX system's bench).  One JSON line per block, in
bench.py's order, the headline (float32) last; every line names the card
(`nvidia-smi --query-gpu=name,power.limit`):

  build_check_matrix_ok          entry.build_check_matrix: every csrc/ source
                                 built (build_seconds: the first-use nvcc
                                 wall, set-up), each ENTRY_CONFIGS step run,
                                 finite, K1 (SW and LW mode) and K2-K5
                                 launched
  kernel_scan_parity_max_rel_err the kernel route against the scan route on
                                 ENTRY_CONFIGS, float32 and float64
  mesh_sharded_parity_max_rel_err run_radsurf over a column mesh (>= 2
                                 entries) against no mesh
  columns_per_sec_per_chip_sw_lw_urban8lay_nreg3      nreg 3 (RAMI-V's config)
  columns_per_sec_per_chip_rami5_62lay_14band_nreg3   RAMI-V's shape, + _f64
  cli_end_to_end_columns_per_sec the CLI in a subprocess on 50,048 columns
  grad_step_columns_per_sec_per_chip   a gradient step (retrieval)
  capacity_1M_columns_per_sec_per_chip 1,048,576 columns, AUTO column chunk
  columns_per_sec_per_chip_sw_lw_urban8lay            the headline, _f64 first

A block that raises prints {"metric": ..., "error": <traceback tail>} and
the bench exits 1; the others still run.  The throughput blocks gate
finite outputs and the energy budgets (budget_gate: a column with a
sub-threshold roof, which leaks by design, against the scan route's
residual on it).

Timing: a timed call is one spartacus_sw + spartacus_lw (one gradient step
in the grad block) on device-resident inputs, host clock to
torch.cuda.synchronize(), tracing off: the port is host-bound at the
headline, and its users pay that host time, so bench.py's differential
in-device loop, which cancels dispatch, is not used.  3 warm-up calls (the
first one's wall is `first_call_s`, set-up), then --reps timed calls (40,
11 in the capacity block).  Each solve is a compiled program (a CUDA graph
per key, utils/graphs.py): the warm-up runs it eagerly, then captures it,
and the timed calls replay it; a line holds the seconds its captures took
(`capture_s`, set-up) and their count (`captures`).  A throughput line holds columns/s/chip from the
median wall (one card), median_ms, the highest percentile with at least ten
samples beyond it (p75 at 40 calls; none with fewer than 20), min_ms,
max_ms, n, and peak_gib, the peak device memory above what was allocated
before the first call.  --trace traces one more call of every throughput
block (nreg3, rami5, grad, capacity, headline) under torch.profiler and
prints, before the block's own line, the device ms of each kernel, of
everything else (the front end and epilogue), the launches, the
device-busy ms and the idle share.  --seed s draws example_inputs from s
and example_arrays from s + 1 (__graft_entry__'s draws at s = 0).  No
number here is compared with a TPU's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import torch

from . import entry
from .driver.duplicate_profiles import DEFAULT_COS_SZA, duplicate_profiles
from .driver.main import working_arrays
from .driver.read_input import read_input
from .models import solver
from .models.dispatch import TILE_FOREST, TILE_VEGETATED_URBAN, run_radsurf
from .models.flux_utils import budget_components, budget_residual
from .models.simple_spectrum import calc_simple_spectrum_lw
from .models.solver import SolverOptions, spartacus_lw, spartacus_sw
from .ops import cuda_build, launches
from .ops.legendre_gauss import LegendreGauss
from .parallel.mesh import tree_leaves
from .utils import graphs, profiling
from .utils.config import Config, DriverConfig
from .utils.constants import StefanBoltzmann
from .utils.inputs import example_arrays, write_example_input

REPO = Path(__file__).resolve().parents[1]
WARMUP = 3
REPS = 40
REPS_CAPACITY = 11
# field-normalized error bars of the kernel route against the scan route
# (PERF.md section 2): float32 SW, LW; float64 both
PARITY_BARS = {"float32": {"sw": 3e-4, "lw": 2.5e-3}, "float64": {"sw": 1e-9, "lw": 1e-9}}
MESH_BAR = 1e-6
GROUPS = ("sw_norm_dir", "sw_norm_diff", "lw_internal", "lw_norm")
# the CLI block: the worst column's residual of the two SW budgets
# (bench.py's bar; its LW budgets are held to this bar times the largest
# emission, sigma T_max^4), the subprocess's time limit in seconds
CLI_RESIDUAL_BAR = 1e-4
CLI_TABLE_COLUMNS = 1000  # flux_utils.print_budget's max_table_columns
CLI_TIMEOUT = 3000
CLI_NAMELIST = """&radsurf
  n_vegetation_region_forest = 2,
  n_stream_sw_forest = 4, n_stream_lw_forest = 4,
  nsw = {S}, nlw = {S}, lw_band_fraction = {fractions},
  do_save_spectral_flux = .true., do_save_flux_profile = .true.,
/
&radsurf_driver
  do_conservation_check = .true.,
  iverbose = 1,
/
"""
CLI_VARIABLES = ("height", "ground_spectral_flux_dn_sw", "spectral_flux_dn_layer_top_sw",
                 "ground_sunlit_fraction", "wall_spectral_flux_net_sw")
# the kernels of the solve, by the device symbol a trace names them with
TRACE_KERNELS = ("layer_factory_kernel", "layer_factory_dense_kernel", "sw_up_kernel",
                 "sw_down_kernel", "lw_up_kernel", "lw_down_kernel")
DTYPES = {"float32": np.float32, "float64": np.float64}
# the runtime calls of a trace that launch device work
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")


@dataclass
class Bench:
    """What every block reads: the device, the seed of the inputs, the timed
    calls (None: each block's default), whether to trace, the card's line,
    and `watch`, a context manager that a throughput block's first call
    runs inside (nothing by default; chip_smoke.py holds each kernel call
    there against its plain version)."""

    device: torch.device
    seed: int = 0
    reps: int | None = None
    trace: bool = False
    card: str = "cpu"
    build_seconds: float | None = None
    watch: object = contextlib.nullcontext

    def emit(self, metric: str, **fields):
        print(json.dumps({"metric": metric, **fields, "card": self.card}), flush=True)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def card_line(device=None) -> str:
    """The card's name and power limit as nvidia-smi gives them (device:
    cuda:0 by default; "cpu" off the card)."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type != "cuda":
        return "cpu"
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        lines = res.stdout.strip().splitlines()
        index = device.index or 0
        if res.returncode == 0 and len(lines) > index:
            return lines[index].strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(device)}, power limit not read"


# ----------------------------------------------------------------------
# measurement and checks
# ----------------------------------------------------------------------

def fields_of(tree, path="") -> dict:
    """{path: tensor} of the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    return {p: x for k, v in items for p, x in fields_of(v, f"{path}/{k}").items()}


def max_rel_err(a, b) -> float:
    """Worst per-field max|x - y| / max(1, max|x|, max|y|) over the fields
    of two results, matched by name (bench.py's _max_rel_err); inf where a
    field holds a non-finite value."""
    fa, fb = fields_of(a), fields_of(b)
    if fa.keys() != fb.keys():
        raise ValueError(f"the results differ in their fields: {fa.keys() ^ fb.keys()}")
    worst = 0.0
    for key, x in fa.items():
        x, y = x.detach().double(), fb[key].detach().double()
        if not (bool(x.isfinite().all()) and bool(y.isfinite().all())):
            return math.inf
        if x.numel():
            scale = max(1.0, x.abs().max().item(), y.abs().max().item())
            worst = max(worst, (x - y).abs().max().item() / scale)
    return worst


def percentile(walls) -> tuple:
    """(name, value) of the highest of p99, p95, p90, p75, p50 with at
    least ten samples beyond it, or (None, None)."""
    for p in (99, 95, 90, 75, 50):
        if len(walls) * (100 - p) / 100 >= 10:
            return f"p{p}", float(np.percentile(walls, p))
    return None, None


def measure(b: Bench, step, columns: int, reps: int, check) -> dict:
    """WARMUP calls of step(), then `reps` timed ones, each from the host
    clock to a synchronize; check(outputs of the first call) -> dict of its
    findings (it raises on a failed gate) runs between the first and the
    second call.  Returns the throughput fields of a block's line."""
    cuda = b.device.type == "cuda"
    b.sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(b.device)
        base = torch.cuda.memory_allocated(b.device)
    with b.watch():
        t0 = time.perf_counter()
        out = step()
        b.sync()
        first = time.perf_counter() - t0
    found = check(out)
    del out
    before = graphs.stats()
    for _ in range(WARMUP - 1):
        step()
        b.sync()
    after = graphs.stats()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        b.sync()
        walls.append(time.perf_counter() - t0)
    med = statistics.median(walls)
    pname, pval = percentile(walls)
    return dict(
        value=columns / med, unit="columns/s/chip", columns=columns, n_cards=1,
        median_ms=med * 1e3, percentile=pname,
        percentile_ms=None if pval is None else pval * 1e3,
        min_ms=min(walls) * 1e3, max_ms=max(walls) * 1e3, n=reps,
        peak_gib=(torch.cuda.max_memory_allocated(b.device) - base) / 2**30 if cuda else None,
        first_call_s=first, capture_s=after["capture_s"] - before["capture_s"],
        captures=after["captures"] - before["captures"], **found)


def trace_fields(step, label: str = "bench_call", cuda: bool = True,
                 kernels: dict | None = None) -> dict:
    """One more call of step() under torch.profiler, inside
    profiling.hook(label), after a warm call: the device ms of each
    kernel of `kernels` ({name: the device symbol a trace names it with};
    default TRACE_KERNELS by symbol) and of everything else (the front end
    and epilogue), the device launches (kernels and copies the device ran,
    those of a CUDA graph's replay each counted), the host's launch calls
    (host_launches: kernel, copy and graph launches issued; a replay is one),
    the device-busy ms (the union of the device intervals) and the idle
    share of the call (from its host start to its last device activity).  The profiler slows the host side, so the
    idle share is an upper bound for an untraced call.  A named range that
    holds launches (`label`, the program's profiling.hook spans) also shows
    as a device-side annotation over them, which is not device work and is
    left out.  Without the card (cuda false) the device numbers are None
    (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kernels = kernels or {k: k for k in TRACE_KERNELS}
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    step()
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with profiling.hook(label):
            step()
            sync()
    events = prof.events()
    call = next(e for e in events if e.name == label and e.device_type == DeviceType.CPU)
    dev = [e for e in events if e.device_type == DeviceType.CUDA and e.name != label
           and not e.is_user_annotation]
    fields = dict(traced_call_ms=call.time_range.elapsed_us() / 1e3, kernel_device_ms=None,
                  other_device_ms=None, device_launches=None, device_busy_ms=None,
                  device_idle_share=None, host_launches=sum(
                      1 for e in events if e.device_type == DeviceType.CPU
                      and e.name.startswith(LAUNCH_CALLS)))
    if dev:
        busy, reach = 0.0, -math.inf
        for t0, t1 in sorted((e.time_range.start, e.time_range.end) for e in dev):
            busy += max(0.0, t1 - max(t0, reach))
            reach = max(reach, t1)
        span = max(call.time_range.end, reach) - call.time_range.start
        kernel = {k: sum(e.time_range.elapsed_us() for e in dev if sym in e.name) / 1e3
                  for k, sym in kernels.items()}
        total = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        fields.update(kernel_device_ms=kernel, other_device_ms=total - sum(kernel.values()),
                      device_launches=len(dev), device_busy_ms=busy / 1e3,
                      traced_call_ms=span / 1e3, device_idle_share=1.0 - busy / span)
    return fields


def trace_call(b: Bench, metric: str, step):
    """The per_layer_device_ms line of a block: trace_fields of one more
    call of step()."""
    b.emit("per_layer_device_ms", block=metric,
           **trace_fields(step, metric, b.device.type == "cuda"))


def sw_lw(sw, lw, opt, lg, route="kernel"):
    """One SW + LW solve: ((norm_dir, norm_diff, bc), (internal, norm, bc))."""
    return spartacus_sw(sw, opt, lg, route=route), spartacus_lw(lw, opt, lg, route=route)


def budget_bars(dname: str, lw_scale: float) -> dict:
    """{group: the energy-budget bar of its worst column} (PERF.md section
    2); LW float32 scales with lw_scale, max(1, the largest emission)."""
    if dname == "float32":
        return {"sw_norm_dir": 1e-4, "sw_norm_diff": 1e-4, "lw_internal": 1e-4 * lw_scale,
                "lw_norm": 1e-4 * lw_scale}
    return {"sw_norm_dir": 1e-10, "sw_norm_diff": 1e-10, "lw_internal": 1e-9, "lw_norm": 1e-10}


def sub_threshold_roofs(building_fraction, min_building_fraction: float):
    """[C] bool: the columns whose building fraction steps by less than
    min_building_fraction between two layers.  Such a step is a roof (or
    overhang) of that area, which the reference leaves out of its budget,
    so the column leaks O(its area) of the flux by design."""
    step = np.abs(np.diff(np.asarray(building_fraction, np.float64), axis=1))
    return step.min(1, initial=np.inf) < min_building_fraction


def budget_gate(resid: dict, leaky, bars: dict, witness: dict | None = None):
    """Hold per-column budget residuals to their bars.  resid: {group: [C]
    signed residuals}; leaky: sub_threshold_roofs of the columns; witness:
    {group: the scan route's residuals on the leaky columns}.  A column
    without a sub-threshold roof is held to bars[group]; one with it to its
    residual on the scan route, within bars[group]: the leak is the
    reference formulation's, and the kernel route adds no more than the bar
    to it.  Returns ({group: the worst residual; for the leaky columns the
    worst of each route and the worst difference}, [failures])."""
    found, failed = {}, []
    for g, r in resid.items():
        r = np.asarray(r, np.float64)
        found[g] = float(np.abs(r[~leaky]).max(initial=0.0))
        if not found[g] <= bars[g]:
            failed.append(f"{g}: energy budget residual {found[g]:.3e} > {bars[g]:.3e}")
        if leaky.any():
            w = np.asarray(witness[g], np.float64)
            off = float(np.abs(r[leaky] - w).max())
            found[f"{g} sub-threshold roof"] = float(np.abs(r[leaky]).max())
            found[f"{g} sub-threshold roof, scan route"] = float(np.abs(w).max())
            found[f"{g} sub-threshold roof, kernel - scan"] = off
            if not off <= bars[g]:
                failed.append(f"{g}: on a column with a sub-threshold roof the residual is"
                              f" {off:.3e} from the scan route's (bar {bars[g]:.3e})")
    found["sub_threshold_roof_columns"] = int(leaky.sum())
    return found, failed


def budget_residuals(out, C: int) -> dict:
    """{group: [C] signed budget residuals, numpy} of an sw_lw result on
    vegetated urban columns."""
    rep = np.full(C, TILE_VEGETATED_URBAN)
    (ndir, ndiff, _), (lint, lnorm, _) = out
    return {g: budget_residual(budget_components(flux, rep)).double().cpu().numpy()
            for g, flux in zip(GROUPS, (ndir, ndiff, lint, lnorm))}


def lw_scale(lw) -> float:
    """max(1, the largest emission) of LW inputs: the scale of the LW
    float32 budget bars."""
    return max([1.0] + [float(getattr(lw, k).abs().max()) for k in
                        ("ground_emission", "roof_emission", "wall_emission",
                         "clear_air_planck", "veg_planck", "veg_air_planck")])


def budget_worst(out, sw, lw, opt: SolverOptions, lg, dname: str) -> dict:
    """budget_gate of an sw_lw result on vegetated urban columns, its
    leaky columns witnessed by the scan route on the same inputs; raises on
    a failure."""
    C = sw.air_ext.shape[0]
    leaky = sub_threshold_roofs(sw.building_fraction.cpu(), opt.min_building_fraction)
    witness = None
    if leaky.any():
        idx = torch.as_tensor(np.flatnonzero(leaky), device=sw.air_ext.device)
        sub = lambda inp: replace(inp, **{k: x[idx] for k, x in inp.tensors()})
        witness = budget_residuals(sw_lw(sub(sw), sub(lw), opt, lg, route="scan"), len(idx))
    found, failed = budget_gate(budget_residuals(out, C), leaky,
                                budget_bars(dname, lw_scale(lw)), witness)
    if failed:
        raise AssertionError("; ".join(failed))
    return {"budget_max_residual": found}


def solve_checks(sw, lw, dname, opt: SolverOptions, lg):
    """check() of a throughput block: every output finite, then the energy
    budgets (budget_worst)."""
    def check(out):
        bad = [i for i, x in enumerate(tree_leaves(out)) if not bool(x.isfinite().all())]
        if bad:
            raise AssertionError(f"outputs {bad} are not finite")
        return {"finite": True, **budget_worst(out, sw, lw, opt, lg, dname)}
    return check


def throughput_block(b: Bench, metric: str, *, C, L, S, nreg, dname="float32",
                     reps=None, extra=None):
    """A forward throughput block: sw_lw on C x L x S urban inputs (nreg,
    4 streams, column_chunk -1: AUTO), measured, traced with --trace, and
    emitted; extra() -> fields added to the line, read after the timed
    calls."""
    opt = SolverOptions(nreg=nreg, nstream=4, do_urban=True, column_chunk=-1)
    lg = LegendreGauss(4)
    sw, lw = entry.canopy_inputs(C, L, S, DTYPES[dname], b.device, b.seed)
    step = lambda: sw_lw(sw, lw, opt, lg)
    res = measure(b, step, C, reps or b.reps or REPS, solve_checks(sw, lw, dname, opt, lg))
    more = extra() if extra else {}
    if b.trace:
        trace_call(b, metric, step)
    b.emit(metric, **res, dtype=dname, shape=[C, L, S], nreg=nreg, nstream=4, **more)


# ----------------------------------------------------------------------
# the blocks, in bench.py's order
# ----------------------------------------------------------------------

def build_block(b: Bench, **shape):
    """Block 1: entry.build_check_matrix (shape: the steps' C, L, S)."""
    res = entry.build_check_matrix(b.device, verbose=False, **shape)
    b.emit("build_check_matrix_ok", value=len(res["launches"]), unit="configs_checked",
           ok=True, build_seconds=b.build_seconds, nvcc_seconds=dict(cuda_build.build_seconds),
           launches=res["launches"])


def parity_block(b: Bench, C=1024, L=8, S=1, configs=entry.ENTRY_CONFIGS):
    """Block 2: the kernel route against the scan route, SW and LW, on each
    (nreg, nstream) of `configs`, in float32 and float64, held to
    PARITY_BARS by max_rel_err."""
    per, worst, failed = {}, {"float32": 0.0, "float64": 0.0}, []
    for dname, np_dt in DTYPES.items():
        for nreg, ns in configs:
            sw, lw = entry.canopy_inputs(C, L, S, np_dt, b.device, b.seed)
            opt, lg = SolverOptions(nreg=nreg, nstream=ns, do_urban=True), LegendreGauss(ns)
            got = {r: (spartacus_sw(sw, opt, lg, route=r), spartacus_lw(lw, opt, lg, route=r))
                   for r in ("kernel", "scan")}
            errs = {band: max_rel_err(got["kernel"][i], got["scan"][i])
                    for i, band in enumerate(("sw", "lw"))}
            name = f"nreg{nreg}_ns{ns}"
            per.setdefault(name, {})[dname] = errs
            worst[dname] = max(worst[dname], *errs.values())
            failed += [f"{name} {dname} {band} {e:.3e}" for band, e in errs.items()
                       if not e <= PARITY_BARS[dname][band]]
            del got
    b.emit("kernel_scan_parity_max_rel_err", value=worst["float32"],
           value_f64=worst["float64"], unit="rel_err", ok=not failed, bars=PARITY_BARS,
           shape=[C, L, S], per_config=per)
    if failed:
        raise AssertionError(f"parity gate failed: {failed}")


def mesh_block(b: Bench, C=2048, L=8, S=1):
    """Block 3: run_radsurf (SW + LW, flux profiles) over a column mesh of
    max(2, the visible cards) entries (cuda:0 repeated on one card; two
    CPU entries on the CPU) against no mesh, held to MESH_BAR."""
    config = Config(nsw=1, nlw=1, do_save_flux_profile=True).consolidate()
    arrays = example_arrays(C=C, L=L, S=S, seed=b.seed + 1)
    if b.device.type == "cuda":
        mesh = entry.mesh_devices(max(2, torch.cuda.device_count()))
    else:
        mesh = [b.device] * 2
    ref = run_radsurf(config, arrays, b.device)
    got = run_radsurf(config, arrays, b.device, mesh=mesh)
    err = max_rel_err(ref, got)
    b.emit("mesh_sharded_parity_max_rel_err", value=err, unit="rel_err", ok=err < MESH_BAR,
           bar=MESH_BAR, n_mesh_devices=len(mesh), n_cards=len(set(mesh)),
           mesh=[str(d) for d in mesh], shape=[C, L, S])
    if not err < MESH_BAR:
        raise AssertionError(f"mesh parity gate failed: {err}")


def nreg3_block(b: Bench, C=8192, L=8, S=1):
    """Block 4: nreg 3 x 4 streams (RAMI-V's configuration, nd = 12)."""
    throughput_block(b, "columns_per_sec_per_chip_sw_lw_urban8lay_nreg3",
                     C=C, L=L, S=S, nreg=3)


def rami5_block(b: Bench, dname="float32", C=1024, L=62, S=14):
    """Block 5: RAMI-V's shape, 62 layers x 14 bands, nreg 3 x 4 streams."""
    sfx = "" if dname == "float32" else "_f64"
    throughput_block(b, f"columns_per_sec_per_chip_rami5_62lay_14band_nreg3{sfx}",
                     C=C, L=L, S=S, nreg=3, dname=dname)


def cli_witness(nam: Path, scene: Path, device) -> dict:
    """The worst column's residual of each of the CLI block's four budgets
    (GROUPS' order) on the scene under the 46-angle SZA sweep, solved in
    this process as the CLI solves it (its namelist, read_input, the LW
    simple spectrum, run_radsurf) on the kernel route in float32 and on the
    scan route in float32 and float64: {"<route> <dtype>": [4 residuals]}.
    The LW inputs do not change with the sun, so these are the LW residuals
    of every column of the CLI's input."""
    sweep = scene.with_name("sweep.nc")
    duplicate_profiles(str(scene), str(sweep), n_copies=len(DEFAULT_COS_SZA),
                       cos_sza=DEFAULT_COS_SZA)
    config = Config.from_namelist(str(nam))
    config.consolidate()
    data = read_input(str(sweep), config, DriverConfig.from_namelist(str(nam)),
                      verbose_print=lambda *a, **k: None)
    if config.do_lw:
        calc_simple_spectrum_lw(config, data["arrays"])
    rep = data["arrays"]["i_representation"]
    found = {}
    for route, dname in (("kernel", "float32"), ("scan", "float32"), ("scan", "float64")):
        out = run_radsurf(config, working_arrays(data, DTYPES[dname]), device, route=route)
        found[f"{route} {dname}"] = [
            float(budget_residual(budget_components(out[g], rep)).abs().max()) for g in GROUPS]
    return found


def cli_block(b: Bench, ncol=50048, L=62, S=14):
    """Block 6: the shipped program, `python -m
    spartacus_surface_tpu_torch.driver.main namelist input output
    --precision single --timings` in a subprocess, on ncol columns: one
    seeded L x S Forest profile (write_example_input) duplicated over the
    46-angle SZA sweep, nreg 3, 4 streams, spectral fluxes and profiles
    saved, conservation checked.  Gates: exit code 0; the read_input,
    radsurf and save regions of --timings; on the card, K1-K5 launched
    (the CLI's "Kernel launches" line); a budget line per flux group, the
    two SW ones below CLI_RESIDUAL_BAR, the two LW ones (W m-2) below it
    times sigma T_max^4; the output's column count, variables, [ncol, S]
    finite ground fluxes and the profile's fill.  The line also holds
    cli_witness's residuals (residuals_in_process).
    The scratch directory is removed."""
    from scipy.io import netcdf_file

    if ncol <= CLI_TABLE_COLUMNS:
        raise ValueError(f"ncol must exceed {CLI_TABLE_COLUMNS}: the CLI prints the"
                         " one-line budget summaries this block reads only then")
    tmp = Path(tempfile.mkdtemp(prefix="spartacus_cli_bench_"))
    try:
        scene, inp, outp = tmp / "scene.nc", tmp / "input.nc", tmp / "output.nc"
        write_example_input(scene, [TILE_FOREST], L=L, S=S, seed=b.seed)
        duplicate_profiles(str(scene), str(inp), n_copies=ncol,
                           cos_sza=np.tile(DEFAULT_COS_SZA, ncol // 46 + 1)[:ncol])
        with netcdf_file(scene, "r", mmap=False) as f:
            t_max = max(float(np.max(f.variables[k][:])) for k in f.variables
                        if k.endswith("_temperature"))
        nam = tmp / "config.nam"
        nam.write_text(CLI_NAMELIST.format(S=S, fractions=", ".join(["1.0"] * S)))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "spartacus_surface_tpu_torch.driver.main", str(nam),
             str(inp), str(outp), "--precision", "single", "--timings",
             "--device", b.device.type],
            capture_output=True, text=True, timeout=CLI_TIMEOUT, cwd=REPO)
        process_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"CLI exit code {proc.returncode}: {proc.stderr[-1500:]}")
        text = proc.stdout
        phases = {k: float(v) for k, v in re.findall(
            r"^\s+(radsurf|save|read_input)\s+([0-9.]+) s", text, re.M)}
        if set(phases) != {"radsurf", "save", "read_input"}:
            raise AssertionError(f"--timings regions: {phases}")
        counted = re.findall(r"^Kernel launches: (\{.*\})$", text, re.M)
        if len(counted) != 1:
            raise AssertionError(f"{len(counted)} kernel launch lines in the CLI's output")
        counted = json.loads(counted[0])
        not_launched = [k for k in launches.PATH_4 if not counted.get(k)]
        if b.device.type == "cuda" and not_launched:
            raise AssertionError(f"the CLI did not launch {not_launched}: {counted}")
        residuals = [float(m) for m in re.findall(r"max \|residual\| = ([0-9.e+-]+)", text)]
        bars = [CLI_RESIDUAL_BAR] * 2 + [CLI_RESIDUAL_BAR * StefanBoltzmann * t_max**4] * 2
        if len(residuals) != 4 or not all(r < bar for r, bar in zip(residuals, bars)):
            raise AssertionError(f"budget residuals {residuals}, bars {bars}")
        with netcdf_file(outp, "r", mmap=True) as f:
            if f.dimensions["column"] != ncol:
                raise AssertionError(f"{f.dimensions['column']} columns, expected {ncol}")
            missing = [k for k in CLI_VARIABLES if k not in f.variables]
            if missing:
                raise AssertionError(f"output variables missing: {missing}")
            ground = np.array(f.variables["ground_spectral_flux_dn_sw"][:])
            prof = np.array(f.variables["spectral_flux_dn_layer_top_sw"][:1000])
        if ground.shape != (ncol, S) or not np.isfinite(ground).all():
            raise AssertionError(f"ground_spectral_flux_dn_sw: shape {ground.shape}, finite"
                                 f" {bool(np.isfinite(ground).all())}")
        if not np.isfinite(prof[prof != -9999.0]).all():
            raise AssertionError("spectral_flux_dn_layer_top_sw holds non-finite values")
        del ground, prof
        witness = cli_witness(nam, scene, b.device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = sum(phases.values())
    b.emit("cli_end_to_end_columns_per_sec", value=ncol / total, unit="columns/s/chip",
           n_cards=1, ncol=ncol, shape=[ncol, L, S], read_s=phases["read_input"],
           solve_s=phases["radsurf"], save_s=phases["save"], process_s=process_s,
           conservation_max_residual=max(residuals), residuals=residuals,
           residual_bars=bars, residuals_in_process=witness, launches=counted, n=1)


def grad_block(b: Bench, C=4096, L=8, S=1):
    """Block 7: one gradient step, torch.autograd.grad of the sum of every
    SW + LW output with respect to veg_ext (one tensor, the SW and the LW
    inputs' vegetation extinction), nreg 2 x 4 streams, column_chunk 0, on
    the kernel route (its backward is the scan route's, _KernelRouteGrad)."""
    metric = "grad_step_columns_per_sec_per_chip"
    opt, lg = SolverOptions(nreg=2, nstream=4, do_urban=True), LegendreGauss(4)
    sw, lw = entry.canopy_inputs(C, L, S, np.float32, b.device, b.seed)
    veg_ext = sw.veg_ext.clone().requires_grad_()

    def step():
        out = sw_lw(replace(sw, veg_ext=veg_ext), replace(lw, veg_ext=veg_ext), opt, lg)
        loss = sum(x.sum() for x in tree_leaves(out))
        return torch.autograd.grad(loss, veg_ext)[0]

    def check(g):
        if not bool(g.isfinite().all()):
            raise AssertionError("the gradient is not finite")
        return {"finite": True, "grad_abs_max": float(g.abs().max())}

    res = measure(b, step, C, b.reps or REPS, check)
    if b.trace:
        trace_call(b, metric, step)
    b.emit(metric, **res, dtype="float32", shape=[C, L, S], nreg=2, nstream=4,
           column_chunk=0)


def capacity_block(b: Bench, C=1048576, L=8, S=1):
    """Block 8: production width, C columns at column_chunk -1 (AUTO, sized
    from the card's memory once the inputs are on it; the chunk the last
    timed call's SW and LW solves ran with, 0 for one shot, is in the
    line)."""
    throughput_block(b, "capacity_1M_columns_per_sec_per_chip", C=C, L=L, S=S, nreg=2,
                     reps=b.reps or REPS_CAPACITY,
                     extra=lambda: {"auto_column_chunk": dict(solver.last_column_chunk)})


def headline_block(b: Bench, dname="float32", C=16384, L=8, S=1):
    """Block 9: the headline, nreg 2 x 4 streams, 8 layers, 1 band."""
    sfx = "" if dname == "float32" else "_f64"
    throughput_block(b, f"columns_per_sec_per_chip_sw_lw_urban8lay{sfx}",
                     C=C, L=L, S=S, nreg=2, dname=dname)


# (block name for --block, metric, function), in the order they run; a
# twin in float64 is a block of its own, so that one failing leaves the
# other's line
BLOCKS = (
    ("build", "build_check_matrix_ok", build_block),
    ("parity", "kernel_scan_parity_max_rel_err", parity_block),
    ("mesh", "mesh_sharded_parity_max_rel_err", mesh_block),
    ("nreg3", "columns_per_sec_per_chip_sw_lw_urban8lay_nreg3", nreg3_block),
    ("rami5", "columns_per_sec_per_chip_rami5_62lay_14band_nreg3", rami5_block),
    ("rami5", "columns_per_sec_per_chip_rami5_62lay_14band_nreg3_f64",
     lambda b: rami5_block(b, "float64")),
    ("cli", "cli_end_to_end_columns_per_sec", cli_block),
    ("grad", "grad_step_columns_per_sec_per_chip", grad_block),
    ("capacity", "capacity_1M_columns_per_sec_per_chip", capacity_block),
    ("headline", "columns_per_sec_per_chip_sw_lw_urban8lay_f64",
     lambda b: headline_block(b, "float64")),
    ("headline", "columns_per_sec_per_chip_sw_lw_urban8lay", headline_block),
)
BLOCK_NAMES = tuple(dict.fromkeys(name for name, _, _ in BLOCKS))


def run_block(fn, b: Bench, metric: str) -> bool:
    """fn(b), or on an exception its {"metric", "error": traceback tail}
    line; whether it succeeded."""
    try:
        fn(b)
        return True
    except Exception:
        b.emit(metric, error=traceback.format_exc()[-1500:])
        return False


def main(argv=None, watch=contextlib.nullcontext) -> int:
    """The bench's command line; watch: Bench.watch."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' plain versions)")
    p.add_argument("--seed", type=int, default=0, help="seed of every input generator")
    p.add_argument("--block", action="append", choices=BLOCK_NAMES,
                   help="run only this block (repeatable; default: all)")
    p.add_argument("--reps", type=int, default=None,
                   help=f"timed calls per throughput block (default {REPS}, capacity"
                        f" {REPS_CAPACITY})")
    p.add_argument("--trace", action="store_true",
                   help="also trace one call of each throughput block (per-kernel device ms)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench: --device cuda but torch.cuda.is_available() is false; use"
              " --device cpu for the plain PyTorch versions", file=sys.stderr)
        return 1
    b = Bench(device=device, seed=args.seed, reps=args.reps, trace=args.trace,
              card=card_line(device), watch=watch)
    if device.type == "cuda":  # nvcc at first use: set-up, never in a block's wall
        try:
            b.build_seconds = entry.build_all()
        except Exception:
            b.emit("build_check_matrix_ok", error=traceback.format_exc()[-1500:])
            return 1
    ok = True
    for name, metric, fn in BLOCKS:
        if not args.block or name in args.block:
            ok = run_block(fn, b, metric) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
