"""Device selection and stage placement.

Entry points take a ``device`` that defaults to ``"cuda"``.  Only an explicit
``"cpu"`` (or ``"meta"``, for shape-only construction) runs anywhere else:
a missing card is an error, never a silent move to the CPU.

Placement follows torchgpipe: one device per pipeline stage.  On one card
every entry is the same device and the boundary hop is a no-op.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def stage_devices(devices: Union[DeviceLike, Sequence[DeviceLike]],
                  n_stages: int) -> List[torch.device]:
    """One resolved device per stage (a single device is repeated)."""
    if isinstance(devices, (str, torch.device)):
        return [resolve_device(devices)] * n_stages
    devs = [resolve_device(d) for d in devices]
    if len(devs) != n_stages:
        raise ValueError(f"{len(devs)} devices for {n_stages} stages")
    return devs
