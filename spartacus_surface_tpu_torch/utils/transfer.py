"""Host-to-device copies that leave the host free to go on issuing work.

``torch.as_tensor(numpy_array, device="cuda")`` copies from pageable host
memory, and PyTorch then synchronizes the current stream: the host waits
until every kernel queued so far has run.  ``to_device`` converts the array
on the host as that call does, stages it in pinned memory and copies it with
``non_blocking=True``: the copy is queued on the current stream behind the
work already there, and the host returns at once.  The pinned block comes
from PyTorch's caching host allocator, which keeps it until the copy has run.
The values are those of ``torch.as_tensor``; on the CPU it is that call.

``constant`` is for the solver's small numpy constants (quadrature weights
and angles): each is moved once per (value, dtype, device) and then
reused, so that a solve issues no host-to-device copy of its own.  Under
CUDA graph capture (utils/graphs.py) such a copy would be captured reading
a pinned host buffer that is freed after the capture.
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(x, device, dtype=None) -> torch.Tensor:
    """Numpy data x as a tensor of dtype on device, without a stream sync."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    host = torch.as_tensor(np.asarray(x), dtype=dtype)
    return host.pin_memory().to(device, non_blocking=True)


_constants: dict = {}


def constant(x, device, dtype=None) -> torch.Tensor:
    """The numpy constant x as a tensor of dtype on device, moved there
    (to_device) at its first use and reused after.  Never write into it."""
    a = np.asarray(x)
    device = torch.device(device)
    key = (a.dtype.str, a.shape, a.tobytes(), device, dtype)
    t = _constants.get(key)
    if t is None:
        t = _constants[key] = to_device(a, device, dtype)
    return t
