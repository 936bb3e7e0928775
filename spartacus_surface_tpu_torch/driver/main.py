"""Offline driver CLI of the port: spartacus_surface_torch config.nam in.nc out.nc.

Port of spartacus_surface_tpu/driver/main.py (program
spartacus_surface_driver, driver/spartacus_surface_driver.F90:20-302): the
same three arguments, namelist handling, benchmark repetition (nrepeat),
column-range selection, simple longwave spectrum, flux scaling and
summation, optional conservation check and output writing.  The whole
column batch is solved on one device: ``--device cuda`` (the default) runs
the layered tiles on the port's CUDA kernels and fails when CUDA is not
available; ``--device cpu`` runs their plain PyTorch versions.

Precision: double by default to match the reference's jprb;
``--precision single`` solves in float32 (the reference's
-DSINGLE_PRECISION, Makefile:42-44).  The input arrays are read in float64
and cast to the working precision for the solve.

Not ported yet (ROADMAP A10): device meshes over several GPUs, the streamed
solve and multi-process runs.  ``--mesh N`` with N > 1, ``--stream-chunk N``
with N > 0, ``--coordinator``, ``--num-processes``, ``--process-id`` and
``--keep-shards`` exit nonzero.  The JAX driver's automatic stream chunking
models a TPU's DMA addressing and x64 memory limits and has no counterpart
here.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..models import flux_utils
from ..models.dispatch import TILE_NAMES, run_radsurf
from ..models.simple_spectrum import calc_simple_spectrum_lw
from ..utils import profiling
from ..utils.config import Config, DriverConfig
from .read_input import read_input
from .save import save_canopy_fluxes

_A10 = "ROADMAP A10: multi-device, streaming and multi-process runs are not ported yet"
_A10_FLAGS = ("--coordinator", "--num-processes", "--process-id", "--keep-shards")


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
        help="Print per-phase wall times (read_input / radsurf / save) at"
             " exit: the region timers of --profile without the trace",
    )
    p.add_argument(
        "--column-chunk", type=int, default=None, metavar="N",
        help="Solve the layered tiles in column chunks of N (bounds the"
             " device working set); 0 = whole batch.  Overrides the"
             " `column_chunk` namelist extension.  The port has no AUTO"
             " chunk: -1 solves the whole batch.",
    )
    p.add_argument(
        "--stream-chunk", type=int, default=0, metavar="N",
        help=f"Streamed solve over column chunks; only 0 (off) is accepted ({_A10})",
    )
    p.add_argument(
        "--netcdf4", action="store_true",
        help="Write the output as NetCDF4/HDF5 via the native libnetcdf"
             " backend (default: NetCDF3 classic, as the reference driver)",
    )
    p.add_argument(
        "--mesh", default="auto", metavar="auto|off|1",
        help=f"Device mesh over columns; one device only here ({_A10})",
    )
    return p


def _unported_flags(args, unknown: list) -> list:
    """The flags of this run that need ROADMAP A10: a mesh or a streamed
    solve, and the multi-process flags of the JAX CLI (left undeclared
    here, so they arrive among parse_known_args' unknown arguments)."""
    bad = [a.split("=")[0] for a in unknown if a.split("=")[0] in _A10_FLAGS]
    if args.mesh not in ("auto", "off", "1"):
        bad.append(f"--mesh {args.mesh}")
    if args.stream_chunk:
        bad.append(f"--stream-chunk {args.stream_chunk}")
    return bad


def prepare(config, data: dict, dtype, device):
    """(solve_arrays, top) for a run at working dtype on device:
    solve_arrays are read_input's arrays (after the simple spectrum) with
    the float fields cast to dtype; top holds the top-of-canopy scale
    factors ("sw_dir", "sw_diff", "lw"), moved to the device once."""
    solve_arrays = {k: v.astype(dtype) if v.dtype.kind == "f" else v
                    for k, v in data["arrays"].items()}
    to_dev = lambda x: torch.as_tensor(np.asarray(x, dtype), device=device)
    top = {}
    if config.do_sw:
        top["sw_dir"] = to_dev(data["top_flux_dn_direct_sw"])
        top["sw_diff"] = to_dev(data["top_flux_dn_sw"]
                                - data["top_flux_dn_direct_sw"])
    if config.do_lw:
        top["lw"] = to_dev(data["top_flux_dn_lw"])
    return solve_arrays, top


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


def main(argv=None):
    parser = build_argparser()
    args, unknown = parser.parse_known_args(argv)
    bad = _unported_flags(args, unknown)
    if bad:
        print(f"*** Error: {', '.join(bad)}: {_A10}", file=sys.stderr)
        return 1
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    saved = profiling.enabled
    if args.profile or args.timings:
        profiling.enabled = True
        profiling.reset()
    try:
        return _run(args)
    finally:
        profiling.enabled = saved


def _run(args) -> int:
    def fail(msg: str) -> int:
        print(msg, file=sys.stderr)
        return 1

    if args.device == "cuda" and not torch.cuda.is_available():
        return fail("*** Error: --device cuda but torch.cuda.is_available() is"
                    " false; use --device cpu for the plain PyTorch versions")
    device = torch.device(args.device)
    dtype = np.float64 if args.precision == "double" else np.float32
    if not os.path.exists(args.namelist):
        return fail(f'*** Error: namelist file "{args.namelist}" not found')
    if not os.path.exists(args.input):
        return fail(f'*** Error: input file "{args.input}" not found')

    config = Config.from_namelist(args.namelist)
    if args.column_chunk is not None:
        config.column_chunk = args.column_chunk
    config.column_chunk = max(config.column_chunk, 0)  # no AUTO chunk here
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

    solve_arrays, top = prepare(config, data, dtype, device)
    sync()
    tstart = time.perf_counter()
    for _ in range(max(1, driver_config.nrepeat)):
        with profiling.hook("radsurf"):
            result = run_radsurf(config, solve_arrays, device)
            sw_flux, lw_flux = scale_and_sum(config, result, top)
            sync()
    elapsed = time.perf_counter() - tstart
    log(f"Time elapsed in radiative transfer: {elapsed:g} seconds")

    if driver_config.do_conservation_check:
        headers = {
            "sw_dir": "Direct shortwave budget: radiation originating"
                      " from direct solar at canopy top",
            "sw_diff": "Diffuse shortwave budget: radiation originating"
                       " from downward diffuse solar at canopy top",
            "lw_int": "Internal longwave budget: radiation originating"
                      " from emission within canopy",
            "lw_norm": "Incoming longwave budget: radiation originating"
                       " from downward longwave at canopy top",
        }
        for name, key in (("sw_dir", "sw_norm_dir"),
                          ("sw_diff", "sw_norm_diff"),
                          ("lw_int", "lw_internal"),
                          ("lw_norm", "lw_norm")):
            if key in result:
                print(headers[name])
                flux_utils.check_flux(result[key], arrays, name)

    with profiling.hook("save"):
        save_canopy_fluxes(args.output, config, arrays, sw_flux, lw_flux,
                           iverbose=iverbose, is_hdf5_file=args.netcdf4)
    if args.profile:
        profiling.stop_trace()
    if args.profile or args.timings:
        profiling.report()
    if args.profile:
        log(f"Profiler trace written to {args.profile}")
    log("-----------------------------------------------------------------"
        "---------------")
    return 0


if __name__ == "__main__":
    sys.exit(main())
