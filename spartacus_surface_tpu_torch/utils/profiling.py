"""Profiling hooks: the Dr-Hook equivalent.

The reference brackets every significant routine with
`if (lhook) call dr_hook(name, 0/1, handle)` (utilities/yomhook.F90:18-31,
used e.g. at radsurf/radsurf_interface.F90:83,315) and times the solver loop
with omp_get_wtime (driver/spartacus_surface_driver.F90:195,264-268).

Port of spartacus_surface_tpu/utils/profiling.py:
  * `hook(name)`: context manager accumulating wall time per region and
    opening a named range of the torch.profiler trace (the counterpart of
    the JAX package's named scope), on the same clock as the device's
    events.  It records while `enabled` is set (like lhook; the CLI sets it
    for one run under --timings or --profile) or while a torch.profiler
    session runs; otherwise it costs one check.  A region that launches
    device work must end in torch.cuda.synchronize() for its wall time to
    cover that work;
  * `start_trace(dir)` / `stop_trace()`: a torch.profiler trace (CPU, and
    CUDA where available) written to DIR as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler

enabled = False
_totals: defaultdict[str, float] = defaultdict(float)
_counts: defaultdict[str, int] = defaultdict(int)
_trace: list = []  # [(profiler, log_dir)] while a trace runs


_OFF = contextlib.nullcontext()


def hook(name: str):
    """Accumulating wall-clock region timer (dr_hook equivalent), recording
    while `enabled` is set or a torch.profiler session runs."""
    if not (enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _record(name)


@contextlib.contextmanager
def _record(name: str):
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    _totals[name] += time.perf_counter() - t0
    _counts[name] += 1


def report(printer=print):
    """Print accumulated region times, Dr-Hook-summary style."""
    if not _totals:
        return
    printer("Profiling summary (wall seconds):")
    width = max(len(k) for k in _totals)
    for name in sorted(_totals, key=_totals.get, reverse=True):
        printer(
            f"  {name:<{width}}  {_totals[name]:10.4f} s"
            f"  ({_counts[name]} calls)"
        )


def totals() -> dict:
    """{region: accumulated wall seconds}."""
    return dict(_totals)


def counts() -> dict:
    """{region: the times it was entered while recording}."""
    return dict(_counts)


def reset():
    _totals.clear()
    _counts.clear()


def start_trace(log_dir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _trace.append((prof, log_dir))


def stop_trace():
    """Stop the trace and write it to DIR/trace.json."""
    prof, log_dir = _trace.pop()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
