"""Build the CUDA sources in csrc/ with nvcc at first use; load with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes
``build/kernels/<name>-<hash>.so`` at the repo root (the hash covers the
source and the shared headers, so an edited source is rebuilt).  A source
listed in PARTS compiles as several objects, one nvcc each with one of its
macros, all started together, then links into the one library (the layer
factory's K1 at team sizes 16 and 32, and its K1d, build apart).  Nothing here
runs at import time: a machine without nvcc imports every module, and only a
launch on a CUDA tensor builds.  Also the operand checks and ctypes helpers
that the kernel wrappers share.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
# {source: the macro of each part} (csrc/layer_factory.cu: SPX_PART_*); ""
# is the main part
PARTS = {"layer_factory": ("", "SPX_PART_TS16", "SPX_PART_TS32_F32",
                           "SPX_PART_TS32_F64", "SPX_PART_DENSE")}

_libs: dict = {}
build_seconds: dict = {}  # name -> nvcc wall seconds (absent: cached build)
part_seconds: dict = {}  # (name, macro) -> that part's nvcc wall seconds
build_log: dict = {}  # name -> nvcc's stderr (ptxas register/spill report)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from csrc/ at first"
            " use on a machine with the CUDA toolkit")
    return path


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    if name in _libs:
        return _libs[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1()
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    lib_path = BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        base = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC)]
        parts = PARTS.get(name)
        if parts is None:
            log = _nvcc_all([[*base, "-shared", "-o", str(tmp), str(src)]], src)[0]
        else:
            objs = [tmp.with_name(f"{tmp.name}.{i}.o") for i in range(len(parts))]
            log, secs = _nvcc_all([[*base, *([f"-D{m}"] if m else []), "-c", "-o",
                                    str(o), str(src)] for m, o in zip(parts, objs)], src)
            part_seconds.update({(name, m): t for m, t in zip(parts, secs)})
            log += _nvcc_all([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]], src)[0]
            for o in objs:
                o.unlink()
        os.replace(tmp, lib_path)
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = log
    _libs[name] = ctypes.CDLL(str(lib_path))
    return _libs[name]


def _nvcc_all(cmds, src):
    """Run the nvcc commands at once and wait for every one: (their stderr,
    the ptxas report; each one's wall seconds), or raise if one failed."""
    from concurrent.futures import ThreadPoolExecutor

    def run(cmd):
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        return res, time.perf_counter() - t0

    with ThreadPoolExecutor(len(cmds)) as pool:
        done = list(pool.map(run, cmds))
    for res, _ in done:
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{res.stderr}")
    return "".join(res.stderr for res, _ in done), [t for _, t in done]


def validate(kernel: str, operands: dict) -> torch.device:
    """Check {name: (tensor, expected shape)}: one device (CPU or CUDA), one
    float32/float64 dtype, exact shapes, contiguous.  Returns the device."""
    first = next(iter(operands.values()))[0]
    dev, dtype = first.device, first.dtype
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kernel}: dtype {dtype} is not float32/float64")
    for name, (t, shape) in operands.items():
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} is {t.dtype} on {t.device},"
                             f" expected {dtype} on {dev}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)},"
                             f" expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
    return dev


def bind(lib, name: str, argtypes, restype=ctypes.c_int):
    """lib's C function `name`, its argtypes and restype set at its first
    use and kept (ctypes caches the function object on the library)."""
    fn = getattr(lib, name)
    if not getattr(fn, "_spx_bound", False):
        fn.restype, fn.argtypes, fn._spx_bound = restype, argtypes, True
    return fn


# a team kernel's launch configuration as the C config functions write it
# (csrc/common.cuh SPX_TEAM_INFO; K1-K5)
TEAM_FIELDS = ("team_size", "teams_per_block", "threads_per_block",
               "slab_bytes", "smem_per_block", "blocks_per_sm", "registers",
               "sms", "global_slab", "grid", "fallback")
_team_configs: dict = {}


def team_config(lib, symbol: str, shape: tuple, n: int, itemsize: int) -> dict:
    """The launch configuration of a team kernel (K1-K5) over n
    elements: lib's config function `symbol` (int arguments `shape`, then n)
    runs once per (lib, symbol, shape), on the card the CUDA occupancy
    calculator; each call sets only the grid (ceil(n / teams_per_block), no
    more than the resident blocks where the slabs are global) and the derived
    fields: scratch_elements (the global slabs' scratch, else 0),
    resident_per_sm (teams resident on an SM) and waves (grid over the
    resident blocks of the card).  team_info(config) is the array the
    launchers take."""
    key = (id(lib), symbol, shape)
    if key not in _team_configs:
        fn = bind(lib, symbol, [ctypes.c_int] * len(shape)
                  + [ctypes.c_longlong, ctypes.c_void_p])
        info = (ctypes.c_longlong * len(TEAM_FIELDS))()
        check(fn(*shape, n, info), symbol)
        _team_configs[key] = dict(zip(TEAM_FIELDS, info))
    c = dict(_team_configs[key])
    pb, resident = c["teams_per_block"], c["blocks_per_sm"] * c["sms"]
    grid = max(1, -(-n // pb))
    if c["global_slab"]:
        grid = min(grid, resident)
    c.update(grid=grid, resident_per_sm=c["blocks_per_sm"] * pb,
             waves=grid / max(resident, 1),
             scratch_elements=(grid * pb * c["slab_bytes"] // itemsize
                               if c["global_slab"] else 0))
    return c


def team_info(config: dict):
    """The launch configuration of team_config as the launchers take it."""
    return (ctypes.c_longlong * len(TEAM_FIELDS))(*(config[f] for f in TEAM_FIELDS))


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaGetLastError() returned by a launcher (or a
    team kernel's config function)."""
    if err != 0:
        why = (" (invalid configuration: no block of the kernel fits an SM, as"
               " where one element's slab exceeds a block's shared memory)"
               if err == 9 else "")
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err}{why}")
