"""Layer -> stage assembly for homogeneous (stacked) stages.

Counterpart of :mod:`repro.core.stage`'s stacked form: every block of a
transformer LM shares one parameter structure, so per-layer trees stack to
``[n_stages, L_per_stage, ...]`` tensors.  Layer counts that do not divide
evenly are padded with identity layers (zero weights, ``mask`` 0), exactly
as in the reference, so a stage runs ``L_per_stage`` uniform slots.

:func:`restack` moves a stacked tree from one layout onto another (the
counterpart of ``runtime/elastic.restack_stages``): a JAX model at pipe 1
and the port at pipe 4 hold the same per-layer weights in different stacks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map


@dataclass(frozen=True)
class StageLayout:
    """Layer -> (stage, slot) assignment for the stacked representation.

    ``slot_layer[s, l]`` is the GLOBAL layer index living at stage ``s``,
    slot ``l`` (``-1`` for identity padding); ``mask`` is its 1.0/0.0
    float view (what the blocks gate their residual delta with).  With a
    ``partition`` stages hold contiguous, possibly non-uniform runs of
    layers padded to the largest stage; without one the uniform ceil
    layout (front-to-back flat fill, padding in the tail stages).
    """
    L_per_stage: int
    mask: np.ndarray              # [n_stages, L] float32
    slot_layer: np.ndarray        # [n_stages, L] int32, -1 = padding
    sizes: Tuple[int, ...]        # real layers per stage (sums to n_layers)
    bounds: Tuple[int, ...]       # cumulative: stage s owns [b[s], b[s+1])

    @property
    def n_stages(self) -> int:
        return len(self.sizes)

    @property
    def n_layers(self) -> int:
        return self.bounds[-1]

    def stage_of(self, layer: int) -> int:
        """Stage hosting GLOBAL layer index ``layer``."""
        for s in range(len(self.sizes)):
            if self.bounds[s] <= layer < self.bounds[s + 1]:
                return s
        raise ValueError(f"layer {layer} outside [0, {self.bounds[-1]})")

    def scatter(self, per_layer: np.ndarray, fill) -> np.ndarray:
        """Spread a length-``n_layers`` per-layer array onto the
        [n_stages, L] slot grid; padding slots take ``fill``."""
        per_layer = np.asarray(per_layer)
        out = np.full((len(self.sizes), self.L_per_stage), fill,
                      per_layer.dtype)
        valid = self.slot_layer >= 0
        out[valid] = per_layer[self.slot_layer[valid]]
        return out


def partition_layout(n_layers: int, n_stages: int,
                     partition: Optional[Sequence[int]] = None) -> StageLayout:
    """Build the stacked-stage layout, uniform or balance-partitioned.

    ``partition`` is per-stage layer counts (contiguous, len == n_stages,
    sums to n_layers); ``None``/empty keeps the uniform ceil layout.
    """
    if partition:
        sizes = tuple(int(p) for p in partition)
        if len(sizes) != n_stages:
            raise ValueError(f"partition has {len(sizes)} entries for "
                             f"{n_stages} stages")
        if sum(sizes) != n_layers:
            raise ValueError(f"partition {sizes} sums to {sum(sizes)}, "
                             f"model has {n_layers} layers")
    else:
        L = -(-n_layers // n_stages)  # ceil
        sizes = tuple(min(L, max(0, n_layers - s * L))
                      for s in range(n_stages))
    Lp = max(max(sizes), 1)
    bounds = [0]
    for sz in sizes:
        bounds.append(bounds[-1] + sz)
    slot = np.full((n_stages, Lp), -1, np.int32)
    for s, sz in enumerate(sizes):
        slot[s, :sz] = np.arange(bounds[s], bounds[s] + sz)
    mask = (slot >= 0).astype(np.float32)
    return StageLayout(Lp, mask, slot, sizes, tuple(bounds))


def place_layers(layer_params: Iterable[Any], slot_layer: np.ndarray) -> Any:
    """Stack per-layer trees onto a ``[S, L]`` slot grid: slot ``(s, l)``
    holds ``layer_params[slot_layer[s, l]]``, zeros where it is ``-1``.
    ``slot_layer`` may be a few stages' rows of a layout, indexing just
    their layers (one pipe rank's share).  Each layer is copied into its
    slots as it comes, so ``layer_params`` may be a generator that draws
    them in order: then the grid and one layer are all that is held (at
    llama3-405b's width a layer is 6.4 GB of bf16)."""
    S, L = slot_layer.shape
    out = None
    for i, p in enumerate(layer_params):
        if out is None:
            out = tree_map(lambda a: a.new_zeros((S, L) + a.shape), p)
        for s, l in zip(*np.nonzero(slot_layer == i)):
            tree_map(lambda dst, src: dst[s, l].copy_(src), out, p)
    return out


def _place(per_layer: Any, slot_layer: np.ndarray) -> Any:
    """[n_layers, ...] leaves -> [S, L, ...] on the ``slot_layer`` grid."""
    S, L = slot_layer.shape
    valid = torch.from_numpy((slot_layer >= 0).reshape(-1))
    src = torch.from_numpy(slot_layer.reshape(-1)[valid.numpy()]).long()

    def one(a):
        out = a.new_zeros((S * L,) + a.shape[1:])
        out[valid.to(a.device)] = a[src.to(a.device)]
        return out.reshape((S, L) + a.shape[1:])
    return tree_map(one, per_layer)


def unstack_layers(stacked: Any, lay: StageLayout) -> Any:
    """[n_stages, L, ...] leaves -> [n_layers, ...] in global layer order."""
    order = np.argsort(np.where(lay.slot_layer >= 0, lay.slot_layer,
                                np.iinfo(np.int32).max).reshape(-1),
                       kind="stable")[:lay.n_layers]
    idx = torch.from_numpy(order).long()

    def one(a):
        if tuple(a.shape[:2]) != (lay.n_stages, lay.L_per_stage):
            raise ValueError(f"leaf {tuple(a.shape)} is not stacked as "
                             f"[{lay.n_stages}, {lay.L_per_stage}, ...]")
        flat = a.reshape((lay.n_stages * lay.L_per_stage,) + a.shape[2:])
        return flat[idx.to(a.device)]
    return tree_map(one, stacked)


def restack(stacked: Any, src: StageLayout, dst: StageLayout) -> Any:
    """Move a stacked tree from layout ``src`` onto layout ``dst``."""
    if src.n_layers != dst.n_layers:
        raise ValueError(f"layouts hold {src.n_layers} and {dst.n_layers} "
                         "layers")
    return _place(unstack_layers(stacked, src), dst.slot_layer)
