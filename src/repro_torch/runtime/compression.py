"""int8 error-feedback gradient compression for data parallelism.

Counterpart of :mod:`repro.runtime.compression`.  Each replica quantizes
its local gradient to int8 with one fp32 scale per block of ``block``
elements, reduces the int8 payload (4x fewer bytes on the slow link; the
scales add ~1/256), dequantizes, and keeps the quantization residual as an
*error-feedback* state added to the next step's gradient (EF-SGD: Seide et
al., Karimireddy et al.).

    comp = EFCompressor(block=256)
    grads, ef = comp.compress_reduce(grads, ef, reduce_fn)

``reduce_fn`` is the cross-replica mean (identity on one replica).  The
same block quantizer encodes the pipeline's ``int8-ef`` wire
(:class:`repro_torch.core.pipeline._Codec`).  Plain torch ops, as the
reference's jnp: ``torch.round`` rounds half to even like ``jnp.round``, so
on the same fp32 inputs every output is bitwise the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves, tree_map


def _quantize_block(x: torch.Tensor, block: int):
    """Flat fp32 ``x`` -> (int8 payload [nb, block], fp32 scales [nb, 1])."""
    n = x.shape[0]
    pad = -(-n // block) * block - n
    xp = (F.pad(x, (0, pad)) if pad else x).reshape(-1, block)
    amax = xp.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: CUDA turns a division by a Python scalar into a
    # multiply by its reciprocal, which is not bitwise the true division
    # the reference (and the CPU) computes
    scale = torch.clamp(amax / amax.new_full((), 127.0), min=1e-12)
    q = torch.clamp(torch.round(xp / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize_block(q: torch.Tensor, scale: torch.Tensor, n: int):
    return (q.float() * scale).reshape(-1)[:n]


def ef_zeros_like(x: torch.Tensor) -> torch.Tensor:
    """The cold error-feedback residual of ``x``: fp32 zeros."""
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


def ef_quantize(v: torch.Tensor, e: torch.Tensor, block: int):
    """One error-feedback step on a leaf: fold the residual ``e`` into
    ``v`` (as fp32), quantize per block, and return ``(q, scale, deq,
    residual)``: the int8 payload and its scales, their dequantized value
    in ``v``'s shape, and what they lost (the next residual)."""
    y = v.float() + e
    flat = y.reshape(-1)
    q, scale = _quantize_block(flat, block)
    deq = _dequantize_block(q, scale, flat.shape[0]).reshape(v.shape)
    return q, scale, deq, y - deq


@dataclass(frozen=True)
class EFCompressor:
    block: int = 256

    def init_state(self, grads: Any) -> Any:
        return tree_map(ef_zeros_like, grads)

    def compress_reduce(self, grads: Any, ef: Any,
                        reduce_fn: Optional[Callable] = None
                        ) -> Tuple[Any, Any]:
        """Returns (reduced dequantized fp32 grads, new error-feedback
        state), both mirroring ``grads``."""
        reduce_fn = reduce_fn or (lambda x: x)

        def one(g, e):
            _, _, deq, resid = ef_quantize(g, e, self.block)
            return reduce_fn(deq), resid             # residual kept locally

        pairs = tree_map(one, grads, ef)           # leaves: (deq, residual)
        return (tree_map(lambda _, p: p[0], grads, pairs),
                tree_map(lambda _, p: p[1], grads, pairs))

    def payload_bytes(self, grads: Any) -> Tuple[int, int]:
        """(compressed, uncompressed) cross-link bytes per replica."""
        sizes = [int(g.numel()) for g in tree_leaves(grads)]
        raw = sum(n * 4 for n in sizes)
        comp = sum(n + 4 * (-(-n // self.block)) for n in sizes)
        return comp, raw
