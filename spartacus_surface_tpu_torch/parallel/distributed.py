"""Multi-process execution over column slices, with torch.distributed.

Port of spartacus_surface_tpu/parallel/distributed.py.  The reference's
only parallelism is shared-memory OpenMP over column blocks
(driver/spartacus_surface_driver.F90:199-234).  Here:

  1. `initialize()` joins the process group (a no-op for one process);
  2. each process reads its own slice of the input columns
     (`host_column_slice`), so the input pipeline scales with processes;
  3. each process solves its columns on its own device
     (`local_device`: cuda:{rank % device_count}) or over a local mesh of
     devices (`make_global_mesh`, `global_column_array`);
  4. the solve has no collectives (no inter-column coupling);
  5. diagnostics reduce with `global_sum`, an all-reduce that is the
     pipeline's only collective, as the reference's serial post-processing
     (driver/spartacus_surface_driver.F90:250-296).

The group runs over gloo, whatever the device: the solve needs no device
collective, and NCCL refuses two ranks on one card.  Its address is given
explicitly (tcp://host:port); nothing is read from a cluster's environment.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .mesh import make_mesh, shard_inputs_by_column, tree_leaves


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               timeout_s: int = 600):
    """Join the gloo process group at coordinator_address (HOST:PORT) as
    rank process_id of num_processes.  A no-op for at most one process."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs a coordinator address"
                         " and a process id")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Best-effort teardown of the process group, so that peers waiting at a
    barrier fail fast on an early error exit instead of timing out."""
    if not dist.is_initialized():
        return
    try:
        dist.destroy_process_group()
    except (RuntimeError, ValueError):
        pass


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier(name: str, timeout_s: int = 600) -> None:
    """Wait until every process reaches this point.  A monitored barrier:
    a peer that does not arrive within timeout_s (or has died) makes it
    raise, naming that peer, instead of hanging."""
    if process_count() <= 1:
        return
    dist.monitored_barrier(timeout=timedelta(seconds=timeout_s))


def local_device(device_type: str = "cuda") -> torch.device:
    """This process's device: cuda:{rank % device_count}, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("a CUDA device was requested but none is visible")
    return torch.device("cuda", process_index() % n)


def make_global_mesh(device_type: str = "cuda") -> list:
    """This process's part of the global column mesh: its local device."""
    return make_mesh(devices=[local_device(device_type)])


def host_column_slice(ncol_global: int) -> slice:
    """The contiguous slice of global columns this process should read.

    Balanced split: the first ncol % nproc processes take one extra column,
    so every process gets >= 1 column whenever nproc <= ncol."""
    nproc, pid = process_count(), process_index()
    base, rem = divmod(ncol_global, nproc)
    start = pid * base + min(pid, rem)
    return slice(start, start + base + (1 if pid < rem else 0))


def global_column_array(local_arrays, mesh: list, ncol_global: int) -> list:
    """This process's columns of a global array, sharded over its mesh.

    local_arrays: pytree of host arrays holding this process's columns
    along axis 0.  The column counts of all processes must sum to
    ncol_global (checked with an all-reduce).  Returns one shard of the
    pytree per mesh entry, on its device (shard_inputs_by_column)."""
    ncol = len(tree_leaves(local_arrays)[0])
    total = global_sum(torch.tensor(float(ncol), dtype=torch.float64))
    if int(total) != ncol_global:
        raise ValueError(f"the processes hold {int(total)} columns in all,"
                         f" not {ncol_global}")
    return shard_inputs_by_column(local_arrays, mesh)


def global_sum(x) -> float:
    """The sum of x over every element of every process: a sum on x's own
    device, then an all-reduce of the float64 scalar over the group."""
    total = torch.as_tensor(x).detach().sum().to("cpu", torch.float64).reshape(1)
    if process_count() > 1:
        dist.all_reduce(total)
    return float(total[0])


def pad_columns(arrays: dict, multiple: int) -> tuple[dict, int]:
    """Pad the column axis of a dense input dict to `multiple` by
    replicating the last column (its outputs are discarded).  Returns the
    padded dict and the original column count."""
    ncol = next(v.shape[0] for v in arrays.values() if hasattr(v, "shape"))
    pad = (-ncol) % multiple
    if pad == 0:
        return arrays, ncol
    out = {}
    for key, val in arrays.items():
        if hasattr(val, "shape") and val.ndim >= 1 and val.shape[0] == ncol:
            out[key] = np.concatenate(
                [val, np.repeat(val[-1:], pad, axis=0)], axis=0
            )
        else:
            out[key] = val
    return out, ncol
