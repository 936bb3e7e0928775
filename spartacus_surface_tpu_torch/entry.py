"""Entry points for a build check and a multi-device dry run.

Port of __graft_entry__.py's entry points (its input generators are
utils/inputs.py):

  entry()                  -> (fn, example_args): the SW step on the
                              headline options (nreg 2, 4 streams, urban).
  entry_matrix()           -> [(name, fn, (sw, lw))]: the full SW + LW step
                              of every (nreg, nstream) in ENTRY_CONFIGS.
  build_check_matrix()     -> the card's counterpart of compile_check_matrix:
                              build every csrc/ source, run each entry_matrix
                              step once, check finite outputs and that K1-K5
                              launched.
  dryrun_multidevice(n)    -> run_radsurf over an n-entry column mesh on a
                              mixed-tile input, outputs checked.

Every function runs on the card unless the caller passes a CPU device.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .models.dispatch import run_radsurf
from .models.solver import CanopyInputs, SolverOptions, spartacus_lw, spartacus_sw
from .ops import cuda_build, launches
from .ops.legendre_gauss import LegendreGauss
from .parallel.mesh import make_mesh
from .utils.config import Config
from .utils.inputs import example_arrays, example_inputs

# Every (nreg, nstream) configuration of the JAX package's kernel matrix
# (__graft_entry__.py:130), the same configurations checks.parity holds
# the kernel route to the scan route on.
ENTRY_CONFIGS = ((1, 2), (2, 4), (3, 4), (2, 8))


def canopy_inputs(C, L, S, dtype=np.float32, device="cuda", seed=0):
    """(SW, LW) CanopyInputs of utils.inputs.example_inputs (the draws of
    __graft_entry__._example_inputs) on `device`."""
    # a copy: a [C, 1] view may be "contiguous" with a negative stride,
    # which torch refuses
    put = lambda d: CanopyInputs(**{k: torch.as_tensor(np.array(v, order="C"), device=device)
                                    for k, v in d.items()})
    return (put(example_inputs(C, L, S, dtype, seed)),
            put(example_inputs(C, L, S, dtype, seed, lw=True)))


def sw_lw_step(opt: SolverOptions, lg: LegendreGauss):
    """The full SW + LW step of __graft_entry__.entry_matrix: six outputs,
    one of each result dict."""
    def fn(a, b):
        norm_dir, norm_diff, bc = spartacus_sw(a, opt, lg)
        lw_int, lw_norm, lw_bc = spartacus_lw(b, opt, lg)
        return (norm_dir["ground_dn"], norm_diff["ground_net"],
                bc["top_albedo_dir"], lw_int["top_dn"], lw_norm["ground_net"],
                lw_bc["top_emissivity"])
    return fn


def entry(device="cuda", dtype=np.float32):
    """(fn, example_args): the SW step on the headline options, on
    8 x 4 x 2 inputs (__graft_entry__.entry)."""
    opt = SolverOptions(nreg=2, nstream=4, do_urban=True)
    lg = LegendreGauss(4)
    sw_inp, _ = canopy_inputs(8, 4, 2, dtype, device)

    def fn(inp):
        norm_dir, norm_diff, bc = spartacus_sw(inp, opt, lg)
        return (norm_dir["ground_dn"], norm_diff["ground_net"],
                bc["top_albedo_dir"])

    return fn, (sw_inp,)


def entry_matrix(device="cuda", dtype=np.float32, C=1024, L=4, S=1):
    """[(name, fn, (sw, lw))]: the full SW + LW step of each (nreg,
    nstream) in ENTRY_CONFIGS, urban, on C x L x S inputs (1,024 x 4 x 1,
    as __graft_entry__.entry_matrix)."""
    out = []
    for nreg, ns in ENTRY_CONFIGS:
        opt = SolverOptions(nreg=nreg, nstream=ns, do_urban=True)
        out.append((f"nreg{nreg}_ns{ns}", sw_lw_step(opt, LegendreGauss(ns)),
                    canopy_inputs(C, L, S, dtype, device)))
    return out


def build_check_matrix(device="cuda", verbose: bool = True, **shape) -> dict:
    """The card's counterpart of __graft_entry__.compile_check_matrix (the
    card has no ahead-of-time compile): on CUDA build every csrc/ source,
    then run each entry_matrix step once (shape: its C, L, S) and raise
    unless every output is finite and, on CUDA, the step launched K1 (SW
    and LW mode) and K2-K5.  Returns {"build_seconds": wall of the build
    (None on the CPU, where the plain versions run), "launches": {config:
    the launch counts of its step}}."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    build_s = None
    if on_card:  # every csrc/*.cu, one nvcc each, all started together
        t0 = time.perf_counter()
        names = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
        with ThreadPoolExecutor(len(names)) as pool:
            list(pool.map(cuda_build.load, names))
        build_s = time.perf_counter() - t0
    counted = {}
    for name, fn, args in entry_matrix(device, **shape):
        before = launches.counts()
        outs = fn(*args)
        if on_card:
            torch.cuda.synchronize(device)
        counted[name] = {k: launches.counts()[k] - before[k] for k in launches.PATH_4}
        bad = [i for i, x in enumerate(outs) if not bool(x.isfinite().all())]
        if bad:
            raise RuntimeError(f"build_check_matrix: {name}: outputs {bad} are not finite")
        missing = [k for k, v in counted[name].items() if on_card and v < 1]
        if missing:
            raise RuntimeError(f"build_check_matrix: {name} did not launch {missing}")
        if verbose:
            print(f"build_check_matrix: {name} OK", flush=True)
    return {"build_seconds": build_s, "launches": counted}


def mesh_devices(n: int, devices=None) -> list:
    """An n-entry column mesh: `devices` as given, else the visible cards
    in turn (cuda:0 repeated where only one card is visible)."""
    if devices is not None:
        if len(devices) != n:
            raise ValueError(f"a mesh of {n} entries, but {len(devices)} devices given")
        return make_mesh(devices=devices)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is visible; pass devices=['cpu'] * n"
                           " for a mesh of CPU entries")
    return make_mesh(devices=[torch.device("cuda", i % count) for i in range(n)])


def dryrun_multidevice(n: int, devices=None, dtype=np.float32,
                       verbose: bool = True) -> dict:
    """run_radsurf over an n-entry column mesh (mesh_devices) on 3n
    mixed-tile columns of utils.inputs.example_arrays (3 layers, 1 band,
    flux profiles saved), solved on the mesh's first entry; raises unless
    every column has its albedo and every flux of the four groups and their
    sum are finite (__graft_entry__.dryrun_multichip).  Returns the
    run_radsurf result."""
    mesh = mesh_devices(n, devices)
    config = Config(nsw=1, nlw=1, n_vegetation_region_forest=1,
                    n_vegetation_region_urban=1,
                    do_save_flux_profile=True).consolidate()
    arrays = example_arrays(C=3 * n, L=3, S=1, dtype=dtype)
    out = run_radsurf(config, arrays, mesh[0], mesh=mesh)
    alb = out["bc_out"]["sw_albedo_dir"]
    if alb.shape[0] != 3 * n:
        raise RuntimeError(f"dryrun_multidevice: {alb.shape[0]} albedo columns,"
                           f" expected {3 * n}")
    for group in ("sw_norm_dir", "sw_norm_diff", "lw_internal", "lw_norm"):
        for key, val in out[group].items():
            if not bool(val.isfinite().all()):
                raise RuntimeError(f"dryrun_multidevice: {group}/{key} is not finite")
    total = float(out["sw_norm_dir"]["ground_dn"].sum() + out["lw_norm"]["top_net"].sum())
    if not np.isfinite(total):
        raise RuntimeError("dryrun_multidevice: the flux total is not finite")
    if verbose:
        print(f"dryrun_multidevice OK: {n} entries ({', '.join(map(str, mesh))}),"
              f" albedo[0]={float(alb[0, 0]):.4f}, total={total:.4f}", flush=True)
    return out

