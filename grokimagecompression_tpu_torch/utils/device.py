"""Device resolution for the port.

The counterpart of `grokimagecompression_tpu/utils/device.py`, keyed on
CUDA rather than on a JAX backend. CUDA is the default; the CPU is used
only when a caller names it (the parity tests do). A request for CUDA on
a machine without it raises: the port never drops to the CPU by itself.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Map a device request to a `torch.device` (None means "cuda")."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_mesh(mesh: Optional[Sequence[DeviceLike]],
                 device: DeviceLike = "cuda") -> List[torch.device]:
    """The devices of a mesh, one shard each (`resolve_device` of every
    entry; entries may repeat a device), or `[resolve_device(device)]`
    without a mesh. A CUDA entry without CUDA, or past the card count,
    raises."""
    if mesh is None:
        return [resolve_device(device)]
    devs = [resolve_device(d) for d in mesh]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    for d in devs:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise ValueError(f"{d} is not among the "
                             f"{torch.cuda.device_count()} CUDA devices")
    return devs
