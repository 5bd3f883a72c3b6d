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
from repro_torch.models.lm import LMModel
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

    ``dtype`` is a model dtype (default: keep every source dtype): each leaf
    takes the dtype the port's own ``LMModel.init`` gives it in a model of
    that dtype, so the leaves a model keeps in fp32 whatever its dtype
    (rwkv's ``tm/u`` and ``tm/w_base``) stay fp32."""
    dev = resolve_device(device)
    n_layers = arch.n_layers + arch.enc_layers
    src = stage_lib.partition_layout(n_layers, src_pipe, src_partition)
    dst = stage_lib.partition_layout(n_layers,
                                     pcfg.pipe * pcfg.virtual_stages,
                                     pcfg.partition or None)
    tree = tree_map(to_tensor, tree_of_numpy)
    tree["stages"] = stage_lib.restack(tree["stages"], src, dst)

    if dtype is None:
        return tree_map(lambda t: t.to(device=dev), tree)
    like = LMModel(arch, pcfg, dtype=dtype, device="meta").init(
        torch.Generator().manual_seed(0))
    return tree_map(lambda t, ref: t.to(device=dev, dtype=ref.dtype),
                    tree, like)
