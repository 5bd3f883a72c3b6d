"""Kernel dispatch by tensor device (counterpart of ``repro.kernels.ops``).

A CUDA tensor goes to the hand-written Hopper kernel, which launches or
raises; a CPU tensor goes to the kernel's plain PyTorch version.  There is no
backend probe and no fallback: the device of the tensor decides.  Under grad,
attention and RMSNorm run through their autograd Functions, whose backward
dispatches the same way (the reference's custom VJPs); WKV-6 on the card
has no backward yet and raises.  Operands
are made contiguous here (the kernels take dense row-major tensors; the
reference's arrays have no layout), a no-op for the usual callers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
from repro_torch.kernels.wkv6 import wkv6 as _wkv6


def attention(q, k, v, *, causal=True, window=None, q_offset: int = 0,
              kv_len=None):
    """GQA attention forward: q [B,Hq,S,D], k/v [B,Hkv,S,D] -> [B,Hq,S,D].

    ``causal`` and ``window`` are static Python values here.  The traced
    per-layer forms the reference also takes (whisper's causal flag and
    ``kv_len`` prefixes, gemma/hymba per-layer windows) are later slices."""
    if kv_len is not None or isinstance(causal, torch.Tensor):
        raise NotImplementedError(
            "kv_len and per-layer causal flags (whisper enc-dec) are not "
            "ported yet: ROADMAP A6")
    if isinstance(window, torch.Tensor):
        raise NotImplementedError(
            "per-layer attention windows (gemma / hymba) are not ported "
            "yet: ROADMAP A8")
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=bool(causal), window=int(window or 0),
                           q_offset=q_offset)


def rmsnorm(x, scale, eps: float = 1e-6):
    return _rmsnorm(x.contiguous(), scale.contiguous(), eps)


def wkv6(r, k, v, w, u, state0=None):
    """RWKV-6 recurrence: (out [B,H,T,V] in r's dtype, state [B,H,K,V] fp32).

    ``state0`` defaults to zeros.  r/k/v/w usually arrive as transposed views
    of [B, T, H, hd] projections; they are made contiguous here."""
    if state0 is None:
        B, H, _, K = r.shape
        state0 = torch.zeros((B, H, K, v.shape[-1]), dtype=torch.float32,
                             device=r.device)
    return _wkv6(r.contiguous(), k.contiguous(), v.contiguous(),
                 w.contiguous(), u.contiguous(), state0.contiguous())
