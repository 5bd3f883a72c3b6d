"""Move JAX-side parameters into the port, as numpy arrays.

The JAX package stacks stage parameters ``[n_stages, L_per_stage, ...]``
under its own pipe layout; the port may run another one.  This module turns
a JAX parameter tree, already converted to numpy (``jax.device_get``), into
the port's tensors restacked onto the port's layout
(:func:`params_from_jax`), and the heterogeneous models' per-layer trees
from the reference's conv layouts into PyTorch's
(:func:`hetero_params_from_jax`).  It imports no JAX.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

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


def conv_leaf_from_jax(path: str, a: np.ndarray) -> np.ndarray:
    """One conv-net leaf from the reference's layout to PyTorch's.

    4-d leaves are HWIO conv kernels: OIHW here (a depthwise ``[k, k, 1,
    cin]`` becomes ``[cin, 1, k, k]``, run with ``groups=cin``).  The
    transposed conv's (``upconv/w``, ``[2, 2, cin, cout]``) becomes
    ``F.conv_transpose2d``'s ``[cin, cout, 2, 2]`` flipped in both spatial
    axes: ``jax.lax.conv_transpose`` (``transpose_kernel=False``) does not
    flip the kernel and PyTorch's transposed conv does.  Other leaves
    (biases, norm scales, the AmoebaNet head's ``[cin, cout]``) stay."""
    if a.ndim != 4:
        return a
    if path.endswith("upconv/w"):
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    return a.transpose(3, 2, 0, 1)


def hetero_params_from_jax(layer_params_numpy: Sequence[Any], model,
                           device: DeviceLike = "cuda") -> List[Any]:
    """The reference's per-layer U-Net / AmoebaNet params (numpy leaves,
    HWIO kernels) -> the port's per-layer trees (OIHW) on ``device``, the
    layout ``model.init`` gives (:func:`conv_leaf_from_jax`)."""
    if len(layer_params_numpy) != len(model.layers):
        raise ValueError(f"{len(layer_params_numpy)} layer trees for "
                         f"{len(model.layers)} layers")
    dev = resolve_device(device)

    def one(tree, path):
        if isinstance(tree, dict):
            return {k: one(v, f"{path}/{k}") for k, v in tree.items()}
        return to_tensor(conv_leaf_from_jax(path, np.asarray(tree))).to(dev)
    return [one(t, "") for t in layer_params_numpy]
