"""One-shot checks of the port at fixed shapes, and the result helpers,
energy-budget gate and trace reduction that chip_smoke.py shares.

SHAPES: {name: check(device, seed=0, **shape) -> dict of findings}, run in
this order by chip_smoke.py's `shapes` phase, each once at its full shape
(tests/test_torch_checks.py: each at a small one on the CPU).  A check
raises on a failed gate; nothing is timed (the benchmark is benchmark/):

  build         entry.build_check_matrix at 1,024 x 4 x 1
  parity        kernel against scan route on ENTRY_CONFIGS, 1,024 x 8 x 1
  mesh          run_radsurf over a column mesh against none, 2,048 x 8 x 1
  nreg3         solve, 8,192 x 8 x 1, nreg 3 (RAMI-V's nd = 12)
  rami5         solve, RAMI-V's 1,024 x 62 x 14, nreg 3; rami5_f64 in float64
  cli           the CLI in a subprocess on 50,048 columns x 62 x 14
  grad          a gradient step of the SW + LW solve, 4,096 x 8 x 1
  capacity      solve, 1,048,576 x 8 x 1, nreg 2
  headline_f64  solve, the headline's 16,384 x 8 x 1, nreg 2, float64;
                headline in float32
"""

from __future__ import annotations

import functools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
from dataclasses import replace
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
from .ops import launches
from .ops.legendre_gauss import LegendreGauss
from .parallel.mesh import tree_leaves
from .utils import profiling
from .utils.config import Config, DriverConfig
from .utils.constants import StefanBoltzmann
from .utils.inputs import example_arrays, write_example_input

REPO = Path(__file__).resolve().parents[1]
# field-normalized error bars of the kernel route against the scan route
# (PERF.md section 2): float32 SW, LW; float64 both
PARITY_BARS = {"float32": {"sw": 3e-4, "lw": 2.5e-3}, "float64": {"sw": 1e-9, "lw": 1e-9}}
MESH_BAR = 1e-6
GROUPS = ("sw_norm_dir", "sw_norm_diff", "lw_internal", "lw_norm")
# the cli check: the worst column's residual of the two SW budgets (its LW
# budgets are held to this bar times the largest emission, sigma T_max^4),
# the subprocess's time limit in seconds
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
DTYPES = {"float32": np.float32, "float64": np.float64}


# ----------------------------------------------------------------------
# results and traces
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


def trace_fields(step, label: str = "bench_call", cuda: bool = True,
                 kernels: dict | None = None) -> dict:
    """One more call of step() under torch.profiler, inside
    profiling.hook(label), after a warm call: the device ms of each
    kernel of `kernels` ({name: the device symbol a trace names it with};
    none by default) and of everything else, the device launches
    (kernels and copies the device ran, those of a CUDA graph's replay each
    counted), the host's launch calls (host_launches: kernel, copy and graph
    launches issued; a replay is one), the device-busy ms (the union of the
    device intervals) and the idle share of the call (from its host start to
    its last device activity).  The profiler slows the host side, so the
    idle share is an upper bound for an untraced call.  A named range that
    holds launches (`label`, the program's profiling.hook spans) also shows
    as a device-side annotation over them, which is not device work and is
    left out.  Without the card (cuda false) the device numbers are None
    (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kernels = kernels or {}
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
                      1 for e in events if e.device_type == DeviceType.CPU and e.name.startswith(
                          ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy",
                           "cudaMemset"))))
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


# ----------------------------------------------------------------------
# the energy-budget gate
# ----------------------------------------------------------------------

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


# ----------------------------------------------------------------------
# the checks, in SHAPES' order
# ----------------------------------------------------------------------

def build(device, seed=0, **shape) -> dict:
    """entry.build_check_matrix (shape: the steps' C, L, S)."""
    return {"launches": entry.build_check_matrix(device, verbose=False, **shape)["launches"]}


def parity(device, seed=0, C=1024, L=8, S=1, configs=entry.ENTRY_CONFIGS) -> dict:
    """The kernel route against the scan route, SW and LW, on each (nreg,
    nstream) of `configs`, in float32 and float64, held to PARITY_BARS by
    max_rel_err."""
    per, worst, failed = {}, {"float32": 0.0, "float64": 0.0}, []
    for dname, np_dt in DTYPES.items():
        for nreg, ns in configs:
            sw, lw = entry.canopy_inputs(C, L, S, np_dt, device, seed)
            opt, lg = SolverOptions(nreg=nreg, nstream=ns, do_urban=True), LegendreGauss(ns)
            got = {r: sw_lw(sw, lw, opt, lg, route=r) for r in ("kernel", "scan")}
            errs = {band: max_rel_err(got["kernel"][i], got["scan"][i])
                    for i, band in enumerate(("sw", "lw"))}
            name = f"nreg{nreg}_ns{ns}"
            per.setdefault(name, {})[dname] = errs
            worst[dname] = max(worst[dname], *errs.values())
            failed += [f"{name} {dname} {band} {e:.3e}" for band, e in errs.items()
                       if not e <= PARITY_BARS[dname][band]]
            del got
    if failed:
        raise AssertionError(f"parity gate failed: {failed}")
    return {"max_rel_err": worst, "per_config": per}


def mesh(device, seed=0, C=2048, L=8, S=1) -> dict:
    """run_radsurf (SW + LW, flux profiles) over a column mesh of max(2,
    the visible cards) entries (cuda:0 repeated on one card; two CPU
    entries on the CPU) against no mesh, held to MESH_BAR."""
    device = torch.device(device)
    config = Config(nsw=1, nlw=1, do_save_flux_profile=True).consolidate()
    arrays = example_arrays(C=C, L=L, S=S, seed=seed + 1)
    if device.type == "cuda":
        devices = entry.mesh_devices(max(2, torch.cuda.device_count()))
    else:
        devices = [device] * 2
    err = max_rel_err(run_radsurf(config, arrays, device),
                      run_radsurf(config, arrays, device, mesh=devices))
    if not err < MESH_BAR:
        raise AssertionError(f"mesh parity gate failed: {err}")
    return {"max_rel_err": err, "mesh": [str(d) for d in devices]}


def solve(device, seed=0, *, C, L, S, nreg, dname="float32") -> dict:
    """spartacus_sw + spartacus_lw on C x L x S urban inputs (nreg, 4
    streams, column_chunk -1: AUTO): every output finite, then the energy
    budgets (budget_worst); the chunk each solve resolves to (0: one shot)."""
    opt = SolverOptions(nreg=nreg, nstream=4, do_urban=True, column_chunk=-1)
    lg = LegendreGauss(4)
    sw, lw = entry.canopy_inputs(C, L, S, DTYPES[dname], device, seed)
    resolve = lambda inp, lw: solver.resolve_chunk(
        opt, lg, C, L, S, inp.air_ext.dtype, device, lw=lw, route="kernel").column_chunk
    chunk = {"sw": resolve(sw, False)}
    out_sw = spartacus_sw(sw, opt, lg)
    chunk["lw"] = resolve(lw, True)
    out = (out_sw, spartacus_lw(lw, opt, lg))
    bad = [i for i, x in enumerate(tree_leaves(out)) if not bool(x.isfinite().all())]
    if bad:
        raise AssertionError(f"outputs {bad} are not finite")
    return {"finite": True, **budget_worst(out, sw, lw, opt, lg, dname),
            "auto_column_chunk": chunk}


def cli_witness(nam: Path, scene: Path, device) -> dict:
    """The worst column's residual of each of the cli check's four budgets
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


def cli(device, seed=0, ncol=50048, L=62, S=14) -> dict:
    """The shipped program, `python -m
    spartacus_surface_tpu_torch.driver.main namelist input output
    --precision single --timings` in a subprocess, on ncol columns: one
    seeded L x S Forest profile (write_example_input) duplicated over the
    46-angle SZA sweep, nreg 3, 4 streams, spectral fluxes and profiles
    saved, conservation checked.  Gates: exit code 0; the read_input,
    radsurf and save regions of --timings; on the card, K1-K5 launched
    (the CLI's "Kernel launches" line); a budget line per flux group, the
    two SW ones below CLI_RESIDUAL_BAR, the two LW ones (W m-2) below it
    times sigma T_max^4; the output's column count, variables, [ncol, S]
    finite ground fluxes and the profile's fill.  The findings also hold
    cli_witness's residuals (residuals_in_process).  The scratch directory
    is removed."""
    from scipy.io import netcdf_file

    device = torch.device(device)
    if ncol <= CLI_TABLE_COLUMNS:
        raise ValueError(f"ncol must exceed {CLI_TABLE_COLUMNS}: the CLI prints the"
                         " one-line budget summaries this check reads only then")
    tmp = Path(tempfile.mkdtemp(prefix="spartacus_cli_check_"))
    try:
        scene, inp, outp = tmp / "scene.nc", tmp / "input.nc", tmp / "output.nc"
        write_example_input(scene, [TILE_FOREST], L=L, S=S, seed=seed)
        duplicate_profiles(str(scene), str(inp), n_copies=ncol,
                           cos_sza=np.tile(DEFAULT_COS_SZA, ncol // 46 + 1)[:ncol])
        with netcdf_file(scene, "r", mmap=False) as f:
            t_max = max(float(np.max(f.variables[k][:])) for k in f.variables
                        if k.endswith("_temperature"))
        nam = tmp / "config.nam"
        nam.write_text(CLI_NAMELIST.format(S=S, fractions=", ".join(["1.0"] * S)))
        proc = subprocess.run(
            [sys.executable, "-m", "spartacus_surface_tpu_torch.driver.main", str(nam),
             str(inp), str(outp), "--precision", "single", "--timings",
             "--device", device.type],
            capture_output=True, text=True, timeout=CLI_TIMEOUT, cwd=REPO)
        if proc.returncode != 0:
            raise AssertionError(f"CLI exit code {proc.returncode}: {proc.stderr[-1500:]}")
        text = proc.stdout
        regions = {k: float(v) for k, v in re.findall(
            r"^\s+(radsurf|save|read_input)\s+([0-9.]+) s", text, re.M)}
        if set(regions) != {"radsurf", "save", "read_input"}:
            raise AssertionError(f"--timings regions: {regions}")
        counted = re.findall(r"^Kernel launches: (\{.*\})$", text, re.M)
        if len(counted) != 1:
            raise AssertionError(f"{len(counted)} kernel launch lines in the CLI's output")
        counted = json.loads(counted[0])
        not_launched = [k for k in launches.PATH_4 if not counted.get(k)]
        if device.type == "cuda" and not_launched:
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
        witness = cli_witness(nam, scene, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"ncol": ncol, "residuals": residuals, "residual_bars": bars,
            "residuals_in_process": witness, "launches": counted}


def grad(device, seed=0, C=4096, L=8, S=1) -> dict:
    """One gradient step, torch.autograd.grad of the sum of every SW + LW
    output with respect to veg_ext (one tensor, the SW and the LW inputs'
    vegetation extinction), nreg 2 x 4 streams, column_chunk 0, on the
    kernel route (its backward is the scan route's, _KernelRouteGrad);
    gates a finite gradient."""
    opt, lg = SolverOptions(nreg=2, nstream=4, do_urban=True), LegendreGauss(4)
    sw, lw = entry.canopy_inputs(C, L, S, np.float32, device, seed)
    veg_ext = sw.veg_ext.clone().requires_grad_()
    out = sw_lw(replace(sw, veg_ext=veg_ext), replace(lw, veg_ext=veg_ext), opt, lg)
    g = torch.autograd.grad(sum(x.sum() for x in tree_leaves(out)), veg_ext)[0]
    if not bool(g.isfinite().all()):
        raise AssertionError("the gradient is not finite")
    return {"finite": True, "grad_abs_max": float(g.abs().max())}


SHAPES = {
    "build": build,
    "parity": parity,
    "mesh": mesh,
    "nreg3": functools.partial(solve, C=8192, L=8, S=1, nreg=3),
    "rami5": functools.partial(solve, C=1024, L=62, S=14, nreg=3),
    "rami5_f64": functools.partial(solve, C=1024, L=62, S=14, nreg=3, dname="float64"),
    "cli": cli,
    "grad": grad,
    "capacity": functools.partial(solve, C=1048576, L=8, S=1, nreg=2),
    "headline_f64": functools.partial(solve, C=16384, L=8, S=1, nreg=2, dname="float64"),
    "headline": functools.partial(solve, C=16384, L=8, S=1, nreg=2),
}
