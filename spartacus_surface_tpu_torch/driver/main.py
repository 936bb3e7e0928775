"""Offline driver CLI of the port: spartacus_surface_torch config.nam in.nc out.nc.

Port of spartacus_surface_tpu/driver/main.py (program
spartacus_surface_driver, driver/spartacus_surface_driver.F90:20-302): the
same three arguments, namelist handling, benchmark repetition (nrepeat),
column-range selection, simple longwave spectrum, flux scaling and
summation, optional conservation check and output writing.  ``--device
cuda`` (the default) runs the layered tiles on the port's CUDA kernels and
fails when CUDA is not available; ``--device cpu`` runs their plain PyTorch
versions.  Where the reference parallelizes over OpenMP column blocks
(spartacus_surface_driver.F90:199-234), this driver can

* stream the solve over column chunks (``--stream-chunk N``,
  parallel/streaming.py): the copies to and from the device overlap the
  solve, and the scaling, summing and budget reductions run on the device
  per chunk.  Without the flag the chunk is automatic (auto_stream_chunk):
  the run streams only where the working-set model of its layered tiles
  (utils/device_memory.py) exceeds what the device has free;
* split each layered tile group over a mesh of devices (``--mesh``,
  parallel/mesh.py);
* run as several processes (``--coordinator``, ``--num-processes``,
  ``--process-id``, parallel/distributed.py), each solving its own
  contiguous column slice on cuda:{rank % device_count} and writing
  OUTPUT.pNN; process 0 merges the shards into OUTPUT after a barrier
  (driver/merge.py).

Precision: double by default to match the reference's jprb;
``--precision single`` solves in float32 (the reference's
-DSINGLE_PRECISION, Makefile:42-44).  The input arrays are read in float64
and cast to the working precision for the solve.  The automatic column
chunk of the solves (``column_chunk = -1``, the default) and the automatic
stream chunk are both sized from the card's free memory, never from a
constant.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from ..models import flux_utils
from ..models.dispatch import TILE_NAMES, run_radsurf, working_set_bytes
from ..models.simple_spectrum import calc_simple_spectrum_lw
from ..ops import launches
from ..parallel import distributed
from ..parallel.mesh import make_mesh
from ..parallel.streaming import stream_columns
from ..utils import graphs, profiling
from ..utils.device_memory import CONTAINER_WORDS, class_bytes, device_budget
from ..utils.config import Config, DriverConfig
from ..utils.transfer import to_device
from .merge import merge_shards
from .read_input import read_input
from .save import save_canopy_fluxes

# (budget table, run_radsurf flux group), in the order the tables print
BUDGETS = (("sw_dir", "sw_norm_dir"), ("sw_diff", "sw_norm_diff"),
           ("lw_int", "lw_internal"), ("lw_norm", "lw_norm"))
BUDGET_HEADERS = {
    "sw_dir": "Direct shortwave budget: radiation originating"
              " from direct solar at canopy top",
    "sw_diff": "Diffuse shortwave budget: radiation originating"
               " from downward diffuse solar at canopy top",
    "lw_int": "Internal longwave budget: radiation originating"
              " from emission within canopy",
    "lw_norm": "Incoming longwave budget: radiation originating"
               " from downward longwave at canopy top",
}


def build_argparser():
    p = argparse.ArgumentParser(
        prog="spartacus_surface_torch",
        description="SPARTACUS-Surface offline radiation scheme (PyTorch / CUDA build)",
    )
    p.add_argument("namelist", help="Namelist configuration file")
    p.add_argument("input", help="Input NetCDF file")
    p.add_argument("output", help="Output NetCDF file")
    p.add_argument(
        "--precision", choices=("double", "single"), default="double",
        help="Working precision (double matches the reference default)",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="Device of the solve: cuda (the default; fails when CUDA is not"
             " available) runs the layered tiles on the CUDA kernels, cpu"
             " runs their plain PyTorch versions",
    )
    p.add_argument(
        "--profile", metavar="DIR", default=None,
        help="Write a torch.profiler trace of the run to DIR/trace.json and"
             " print per-region wall times (the reference's Dr-Hook/GPROF"
             " equivalents, Makefile_include.gfortran:40-43)",
    )
    p.add_argument(
        "--timings", action="store_true",
        help="Print per-phase wall times (read_input / radsurf / save and"
             " run_radsurf's host plan), the kernels' launch counts and the"
             " CUDA graphs' counters at exit: the region timers of --profile"
             " without the trace",
    )
    p.add_argument(
        "--column-chunk", type=int, default=None, metavar="N",
        help="Solve the layered tiles in column chunks of N (bounds the"
             " device working set); 0 = whole batch, -1 = AUTO (the default:"
             " the whole batch where it fits the device's free memory, else"
             " the fewest equal chunks that fit; per shard under a mesh)."
             "  Overrides the `column_chunk` namelist extension.",
    )
    p.add_argument(
        "--stream-chunk", type=int, default=None, metavar="N",
        help="Stream the solve over column chunks of N: pinned host buffers"
             " and copy streams overlap the transfers with the solve, the"
             " scaling and the budget reductions run on the device per chunk,"
             " and only a few chunks are on the device at once (for inputs"
             " larger than device memory).  Differs from --column-chunk, which"
             " keeps every column on the device.  Default: auto, streaming"
             " only where the one-shot working set of the layered tiles"
             " exceeds the device's free memory (per process, per device of"
             " a mesh); 0 solves in one shot.",
    )
    p.add_argument(
        "--netcdf4", action="store_true",
        help="Write the output as NetCDF4/HDF5 via the native libnetcdf"
             " backend (default: NetCDF3 classic, as the reference driver)",
    )
    p.add_argument(
        "--mesh", default="auto", metavar="auto|off|N",
        help="Device mesh over columns: 'auto' (the default) splits each"
             " layered tile group over all visible CUDA devices when more"
             " than one is visible (one process), 'off' solves on one device,"
             " an integer N uses the first N CUDA devices (with --device cpu,"
             " N CPU entries).  The equivalent of the reference's OpenMP"
             " column blocks (spartacus_surface_driver.F90:199-234).",
    )
    p.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="Address of the process group for multi-process runs (gloo over"
             " TCP; process 0 listens there).  Each process solves its own"
             " contiguous column slice and writes OUTPUT.pNN",
    )
    p.add_argument(
        "--num-processes", type=int, default=None, metavar="N",
        help="Total process count for --coordinator runs",
    )
    p.add_argument(
        "--process-id", type=int, default=None, metavar="I",
        help="This process's rank (0-based) for --coordinator runs",
    )
    p.add_argument(
        "--keep-shards", action="store_true",
        help="Multi-process runs: keep the per-process OUTPUT.pNN shards"
             " after process 0 merges them into the single OUTPUT file",
    )
    p.add_argument(
        "--barrier-timeout", type=int, default=600, metavar="SECONDS",
        help="Multi-process runs: how long a process waits for its peers to"
             " join the group and to reach the barrier before the merge",
    )
    return p


# chunks a streamed solve keeps in flight (parallel/streaming.py depth)
STREAM_DEPTH = 2


def auto_stream_chunk(config, arrays: dict, ncol: int, n_devices: int = 1,
                      budget: float = math.inf, itemsize: int | None = None) -> int:
    """The automatic --stream-chunk: 0 (one shot) where the working-set
    model of one run_radsurf call over `arrays` (dispatch.working_set_bytes)
    fits `budget` bytes per device (device_budget) times n_devices, else
    the column chunk of the fewest slices that fit, preferring a chunk that
    divides ncol (a slice count in [n_min, 2 n_min]), else a ceiling split.
    A slice's columns are costed as the dearest layered tile type present,
    plus what the stream keeps on the device besides the solve: the inputs
    of the next slice (on their way) and of the last one (until the solve
    is done with them), and the summed fluxes of the slice and of the
    STREAM_DEPTH slices travelling back.  itemsize: bytes of the working
    precision (default: that of arrays["dz"])."""
    rep = np.asarray(arrays["i_representation"])
    nlay = arrays["dz"].shape[1]
    itemsize = itemsize or arrays["dz"].dtype.itemsize
    total = budget * max(1, n_devices)
    if working_set_bytes(config, rep, nlay, itemsize) <= total:
        return 0
    solve_col = max(working_set_bytes(config, [code], nlay, itemsize)
                    for code in np.unique(rep))
    inputs_col = itemsize * sum(v[0].size for v in arrays.values()
                                if v.dtype.kind == "f")
    fluxes_col = sum(class_bytes(CONTAINER_WORDS, 1, nlay, S, itemsize)
                     for on, S in ((config.do_sw, config.nswinternal),
                                   (config.do_lw, config.nlwinternal)) if on)
    per_col = solve_col + 3 * inputs_col + (STREAM_DEPTH + 1) * fluxes_col
    n_min = math.ceil(ncol * per_col / total)
    n_slices = next((n for n in range(n_min, min(2 * n_min, ncol) + 1)
                     if ncol % n == 0), n_min)
    return -(-ncol // n_slices)


def top_fluxes(config, data: dict, dtype) -> dict:
    """The top-of-canopy scale factors ("sw_dir", "sw_diff", "lw"), [C, S]
    host arrays of dtype."""
    top = {}
    if config.do_sw:
        top["sw_dir"] = np.asarray(data["top_flux_dn_direct_sw"], dtype)
        top["sw_diff"] = np.asarray(data["top_flux_dn_sw"]
                                    - data["top_flux_dn_direct_sw"], dtype)
    if config.do_lw:
        top["lw"] = np.asarray(data["top_flux_dn_lw"], dtype)
    return top


def working_arrays(data: dict, dtype) -> dict:
    """read_input's arrays (after the simple spectrum) with the float fields
    cast to the working dtype, host numpy."""
    return {k: v.astype(dtype) if v.dtype.kind == "f" else v
            for k, v in data["arrays"].items()}


def prepare(config, data: dict, dtype, device):
    """(working_arrays, top) for a one-shot run at working dtype on device;
    top holds the top-of-canopy scale factors (top_fluxes), moved to the
    device once."""
    top = {k: to_device(v, device) for k, v in top_fluxes(config, data, dtype).items()}
    return working_arrays(data, dtype), top


def scale_and_sum(config, result: dict, top: dict):
    """(sw_flux, lw_flux) of a run_radsurf result: the normalized fluxes
    scaled by the top-of-canopy fluxes and summed (None for a band that is
    off)."""
    sw_flux = lw_flux = None
    if config.do_sw:
        sw_flux = flux_utils.sum_flux(
            flux_utils.scale_flux(result["sw_norm_dir"], top["sw_dir"]),
            flux_utils.scale_flux(result["sw_norm_diff"], top["sw_diff"]))
    if config.do_lw:
        lw_flux = flux_utils.sum_flux(
            result["lw_internal"],
            flux_utils.scale_flux(result["lw_norm"], top["lw"]))
    return sw_flux, lw_flux


def stream_solve(config, data: dict, dtype, device, chunk: int, mesh=None,
                 want_budgets: bool = True):
    """The solve streamed over column chunks (parallel/streaming.py), each
    chunk's post-processing on the device: the normalized fluxes scaled by
    the top-of-canopy fluxes and summed, and (want_budgets) the budget
    reduced to per-column components, so that a chunk fetches one summed
    flux container per band and [C] vectors.

    Returns (sw_flux, lw_flux, budgets), host numpy; budgets maps the
    BUDGETS tables to budget_with_masks dicts (empty without want_budgets)."""
    top = top_fluxes(config, data, dtype)
    inputs = {**working_arrays(data, dtype), **{f"__top_{k}": v for k, v in top.items()}}

    def solve_chunk(a):
        sc = {k: a.pop(f"__top_{k}") for k in top}
        res = run_radsurf(config, a, device, mesh=mesh)
        out = {"budget": {}}
        out["sw_flux"], out["lw_flux"] = scale_and_sum(config, res, sc)
        if want_budgets:
            masks = flux_utils.representation_masks(a["i_representation"], device)
            out["budget"] = {name: flux_utils.budget_with_masks(res[key], masks)
                             for name, key in BUDGETS if key in res}
        return out

    streamed = stream_columns(solve_chunk, inputs, chunk, depth=STREAM_DEPTH,
                              device=device)
    return streamed["sw_flux"], streamed["lw_flux"], streamed["budget"]


def main(argv=None):
    args = build_argparser().parse_args(argv)
    saved = profiling.enabled
    if args.profile or args.timings:
        profiling.enabled = True
        profiling.reset()
    try:
        return _run(args)
    finally:
        profiling.enabled = saved
        distributed.shutdown()


def _run(args) -> int:
    def fail(msg: str) -> int:
        """Error exit; the process group is torn down, so that peers waiting
        at the barrier fail fast."""
        print(msg, file=sys.stderr)
        distributed.shutdown()
        return 1

    if args.device == "cuda" and not torch.cuda.is_available():
        return fail("*** Error: --device cuda but torch.cuda.is_available() is"
                    " false; use --device cpu for the plain PyTorch versions")
    # Multi-process bootstrap: the gloo group at --coordinator
    if args.num_processes is not None and args.num_processes > 1:
        try:
            distributed.initialize(args.coordinator, args.num_processes,
                                   args.process_id, timeout_s=args.barrier_timeout)
        except (RuntimeError, ValueError) as exc:
            return fail(f"*** Error joining the process group: {exc}")
    nproc, pid = distributed.process_count(), distributed.process_index()
    device = distributed.local_device(args.device)
    dtype = np.float64 if args.precision == "double" else np.float32
    if not os.path.exists(args.namelist):
        return fail(f'*** Error: namelist file "{args.namelist}" not found')
    if not os.path.exists(args.input):
        return fail(f'*** Error: input file "{args.input}" not found')

    config = Config.from_namelist(args.namelist)
    if args.column_chunk is not None:
        config.column_chunk = args.column_chunk
    driver_config = DriverConfig.from_namelist(args.namelist)
    iverbose = driver_config.iverbose
    if args.profile:
        profiling.start_trace(args.profile)

    def log(*a, level=2):
        if iverbose >= level:
            print(*a)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    log("------------------ OFFLINE SPARTACUS-SURFACE RADIATION SCHEME"
        " (PyTorch) ------------------")
    log(f"Floating-point precision: {args.precision}")
    log(f"Device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    config.consolidate()
    # Config echo at iverbose >= 2 (radsurf_config.F90:275-362, called from
    # spartacus_surface_driver.F90 after consolidate)
    config.print_config(iverbose=iverbose)

    try:
        with profiling.hook("read_input"):
            data = read_input(args.input, config, driver_config,
                              verbose_print=log)
    except KeyError as exc:
        return fail(f"*** Error reading {args.input}: {exc}")
    arrays = data["arrays"]
    ncol = data["ncol"]

    if nproc > ncol:
        # Every process reads the same input, so all of them take this
        # error exit (none is left at the barrier with no columns).
        return fail(f"*** Error: {nproc} processes for only {ncol} input"
                    " columns; use at most one process per column")

    # Multi-process execution: each process handles its own contiguous
    # slice of columns end to end (the reference's OpenMP loop has no
    # inter-column coupling) and writes OUTPUT.pNN.
    proc_suffix = ""
    if nproc > 1:
        hsl = distributed.host_column_slice(ncol)
        for key, val in list(arrays.items()):
            arrays[key] = val[hsl]
        for key in ("top_flux_dn_sw", "top_flux_dn_direct_sw",
                    "top_flux_dn_lw"):
            if data[key] is not None:
                data[key] = data[key][hsl]
        ncol = hsl.stop - hsl.start
        proc_suffix = f".p{pid:02d}"
        log(f"Process {pid}/{nproc}: columns {hsl.start + 1} to {hsl.stop}")

    # Device mesh over the column axis (parallel/mesh.py)
    mesh = None
    if args.mesh == "auto":
        if device.type == "cuda" and nproc == 1 and torch.cuda.device_count() > 1:
            mesh = make_mesh()
    elif args.mesh != "off":
        try:
            n_mesh = int(args.mesh)
            if n_mesh < 1:
                raise ValueError(f"a mesh needs at least one device, not {n_mesh}")
            mesh = (make_mesh(devices=[device] * n_mesh) if device.type == "cpu"
                    else make_mesh(n_mesh))
        except ValueError as exc:
            return fail(f"*** Error: --mesh {args.mesh}: {exc}")
    if mesh is not None:
        log(f"Parallel: sharding columns over {len(mesh)} devices"
            f" ({', '.join(map(str, mesh))})")

    # Column-range selection (spartacus_surface_driver.F90:153-164)
    icol1 = driver_config.istartcol
    icol2 = driver_config.iendcol
    if icol2 < 1 or icol2 > ncol:
        icol2 = ncol
    if icol1 > icol2:
        return fail(
            f"*** Error: requested column range ({icol1} to "
            f"{driver_config.iendcol}) is out of the range in the data"
            f" (1 to {ncol})"
        )
    if (icol1, icol2) != (1, ncol):
        sel = slice(icol1 - 1, icol2)
        for key, val in list(arrays.items()):
            arrays[key] = val[sel]
        for key in ("top_flux_dn_sw", "top_flux_dn_direct_sw",
                    "top_flux_dn_lw"):
            if data[key] is not None:
                data[key] = data[key][sel]
        ncol = icol2 - icol1 + 1

    if config.do_lw:
        calc_simple_spectrum_lw(config, arrays)

    if iverbose >= 4:
        # Per-column representation trace (radsurf_interface.F90:126-128,
        # 176-181 at iverbose >= 4)
        for jcol, code in enumerate(arrays["i_representation"], start=1):
            print(f"{jcol:5d}: {TILE_NAMES.get(int(code), '?')},"
                  f" {int(arrays['nlay'][jcol - 1])} layers")

    if args.stream_chunk is None:
        budget = min(device_budget(d) for d in (mesh or [device]))
        args.stream_chunk = auto_stream_chunk(
            config, arrays, ncol, len(mesh) if mesh else 1, budget,
            np.dtype(dtype).itemsize)
        if args.stream_chunk:
            log(f"Streaming the solve in {args.stream_chunk}-column"
                " chunks (host pipeline; see --stream-chunk)")
    elif args.stream_chunk > 0:
        log(f"Streaming the solve in {args.stream_chunk}-column chunks")
    if args.stream_chunk <= 0:
        solve_arrays, top = prepare(config, data, dtype, device)
    sync()
    tstart = time.perf_counter()
    for _ in range(max(1, driver_config.nrepeat)):
        with profiling.hook("radsurf"):
            if args.stream_chunk > 0:
                sw_flux, lw_flux, budgets = stream_solve(
                    config, data, dtype, device, args.stream_chunk, mesh,
                    want_budgets=driver_config.do_conservation_check)
            else:
                result = run_radsurf(config, solve_arrays, device, mesh=mesh)
                sw_flux, lw_flux = scale_and_sum(config, result, top)
            sync()
    elapsed = time.perf_counter() - tstart
    log(f"Time elapsed in radiative transfer: {elapsed:g} seconds")

    if driver_config.do_conservation_check:
        if args.stream_chunk <= 0:  # reduced on the device here
            budgets = {name: flux_utils.budget_components(
                result[key], arrays["i_representation"])
                for name, key in BUDGETS if key in result}
        for name, _ in BUDGETS:
            if name in budgets:
                print(BUDGET_HEADERS[name])
                flux_utils.print_budget(budgets[name])

    with profiling.hook("save"):
        save_canopy_fluxes(args.output + proc_suffix, config, arrays, sw_flux,
                           lw_flux, iverbose=iverbose, is_hdf5_file=args.netcdf4)
    if nproc > 1:
        # One output file, always (radsurf_save.F90:26): wait until every
        # process has written its shard, then process 0 merges them.
        try:
            distributed.barrier("spartacus_shards_written", args.barrier_timeout)
        except RuntimeError as exc:
            return fail(f"*** Error: not every process wrote its shard: {exc}")
        if pid == 0:
            merge_shards(args.output, n_processes=nproc,
                         delete=not args.keep_shards, is_hdf5_file=args.netcdf4)
            log(f"Merged {nproc} output shards into {args.output}")
    if args.profile:
        profiling.stop_trace()
    if args.profile or args.timings:
        profiling.report()
        print("Kernel launches: " + json.dumps(launches.counts()))
        counted = graphs.stats()
        print("Graphs: " + json.dumps({k: counted[k] for k in (
            "replays", "captures", "releases", "evictions", "h2d_bytes",
            "h2d_direct_bytes", "h2d_direct_share", "gather_bytes")}))
    if args.profile:
        log(f"Profiler trace written to {args.profile}")
    log("-----------------------------------------------------------------"
        "---------------")
    return 0


if __name__ == "__main__":
    sys.exit(main())
