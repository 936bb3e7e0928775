"""Host-to-device copies that leave the host free to go on issuing work.

``torch.as_tensor(numpy_array, device="cuda")`` copies from pageable host
memory, and PyTorch then synchronizes the current stream: the host waits
until every kernel queued so far has run.  ``to_device`` converts the array
on the host as that call does, stages it in pinned memory and copies it with
``non_blocking=True``: the copy is queued on the current stream behind the
work already there, and the host returns at once.  The pinned block comes
from PyTorch's caching host allocator, which keeps it until the copy has run.
The values are those of ``torch.as_tensor``; on the CPU it is that call.
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
