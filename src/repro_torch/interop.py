"""Move JAX-side parameters into the port, as numpy arrays.

The JAX package stacks stage parameters ``[n_stages, L_per_stage, ...]``
under its own pipe layout; the port may run another one.  This module turns
a JAX parameter tree, already converted to numpy (``jax.device_get``), into
the port's tensors restacked onto the port's layout.  It imports no JAX.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ParallelConfig
from repro_torch.core import stage as stage_lib
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.tree import tree_map


def to_tensor(x: Any) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> CPU tensor, bit for bit."""
    a = np.array(x)                  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree_of_numpy, *, arch: ArchConfig, src_pipe: int,
                    pcfg: ParallelConfig, device: DeviceLike = "cuda",
                    src_partition: Optional[Sequence[int]] = None,
                    dtype: Optional[torch.dtype] = None):
    """JAX params (numpy leaves, stacked for ``src_pipe`` stages) -> the
    port's params stacked for ``pcfg``, on ``device``.

    ``dtype`` casts every leaf (default: keep the source dtype)."""
    dev = resolve_device(device)
    n_layers = arch.n_layers + arch.enc_layers
    src = stage_lib.partition_layout(n_layers, src_pipe, src_partition)
    dst = stage_lib.partition_layout(n_layers,
                                     pcfg.pipe * pcfg.virtual_stages,
                                     pcfg.partition or None)
    tree = tree_map(to_tensor, tree_of_numpy)
    tree["stages"] = stage_lib.restack(tree["stages"], src, dst)

    def place(t):
        return t.to(device=dev, dtype=dtype or t.dtype)
    return tree_map(place, tree)
