"""Device meshes over the column axis.

Port of spartacus_surface_tpu/parallel/mesh.py.  The column axis is
embarrassingly parallel: the reference has no inter-column coupling
(radsurf/radsurf_interface.F90:105-313) and runs OpenMP over column blocks
(driver/spartacus_surface_driver.F90:199-234).  Here a mesh is an ordered
list of torch devices; a [C, ...] input is split into one contiguous shard
of columns per entry, each on its own device, and every shard is solved
there with no communication.  Shards may be unequal (the first C % n entries
take one column more), so nothing is padded.  An entry may repeat: a mesh
of two ``cuda:0`` entries runs both shards on one card.
"""

from __future__ import annotations

from dataclasses import fields, is_dataclass, replace

import numpy as np
import torch

from ..utils.transfer import to_device


def make_mesh(n_devices: int | None = None, devices=None) -> list:
    """1-D mesh over the column axis: `devices` as given (any list, repeats
    included), else the first n_devices of the visible CUDA devices (all of
    them when n_devices is None)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"requested a {n_devices}-device mesh but only"
                    f" {len(devices)} devices are visible; run on a machine"
                    " with more cards")
            devices = devices[:n_devices]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return devices


def column_sharding(ncol: int, mesh: list) -> list:
    """[(device, slice of columns)] per mesh entry: contiguous, balanced (the
    first ncol % len(mesh) entries take one column more), in mesh order; an
    entry gets an empty slice where ncol < len(mesh)."""
    base, rem = divmod(ncol, len(mesh))
    out, start = [], 0
    for k, dev in enumerate(mesh):
        stop = start + base + (k < rem)
        out.append((dev, slice(start, stop)))
        start = stop
    return out


def tree_map(fn, tree):
    """fn over the array leaves of nested dicts, lists, tuples and
    dataclasses (CanopyInputs); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if is_dataclass(tree) and not isinstance(tree, type):
        return replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                for f in fields(tree)})
    return fn(tree)


def tree_leaves(tree) -> list:
    """The array leaves of a pytree, in tree_map's order."""
    out = []
    tree_map(out.append, tree)
    return out


def shard_inputs_by_column(inputs, mesh: list) -> list:
    """One shard of the pytree `inputs` per mesh entry: every [C, ...] leaf
    (numpy or tensor) cut to the entry's columns (column_sharding) and
    placed on its device.  Returns the shards as a list in mesh order."""
    ncol = len(tree_leaves(inputs)[0])

    def place(dev, sl):
        def put(x):
            if isinstance(x, torch.Tensor):
                return x[sl].to(dev)
            return to_device(np.asarray(x)[sl], dev)
        return tree_map(put, inputs)

    return [place(dev, sl) for dev, sl in column_sharding(ncol, mesh)]
