"""Flash attention forward: the Hopper kernel's wrapper and its plain version.

Counterpart of :mod:`repro.kernels.flash_attention`.  The CUDA source is
``csrc/flash_attention.cu``; see its header for the bound and the design.
:func:`flash_attention` launches the kernel for CUDA tensors (or raises) and
runs :func:`flash_attention_plain` only for tensors that lie on the CPU.

q: [B, Hq, Sq, D]; k/v: [B, Hkv, Sk, D]; Hq % Hkv == 0 (GQA without a KV
repeat: q head h reads kv head h // (Hq // Hkv)).  ``causal``, ``window``
(0 = unlimited) and ``q_offset`` (queries sit at key positions
``q_offset ..``) are plain Python values.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, scale: Optional[float] = None):
    """The same online-softmax recurrence in plain torch (ref.mha_blocked)."""
    return ref.mha_blocked(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, scale=scale)


def check_inputs(q, k, v) -> None:
    """The kernel's contract on dtype, shape and layout (any device)."""
    tensors = (q, k, v)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"flash attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if any(t.dim() != 4 for t in tensors):
        raise ValueError("flash attention kernel needs 4-d [B, H, S, D] "
                         "tensors")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if (k.shape != (B, Hkv, Sk, D) or v.shape != k.shape or Hkv == 0
            or Hq % Hkv or D not in HEAD_DIMS or Sk == 0):
        raise ValueError(f"flash attention kernel: bad shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} (want Hq % Hkv == 0, D in "
                         f"{HEAD_DIMS}, Sk > 0)")
    if B * Hq > 65535:
        raise ValueError(f"flash attention kernel: B * Hq = {B * Hq} > 65535")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash attention kernel needs contiguous q, k, v")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0, scale: Optional[float] = None):
    """Launch ``csrc/flash_attention.cu``; returns [B, Hq, Sq, D] in q.dtype."""
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA device")
    check_inputs(q, k, v)
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if (q.data_ptr() | k.data_ptr() | v.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("flash_attention_cuda needs 16-byte aligned tensors")
    scale = float(scale if scale is not None else D ** -0.5)
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = build.c_args("p", "p", "p", "p", "i", "i", "i", "i", "i",
                               "i", "f", "i", "i", "i", "i", "p")
    fn.restype = build.ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Hq, Hkv, Sq, Sk, D, scale, int(bool(causal)),
                 int(window or 0), int(q_offset), _DTYPES[q.dtype], stream)
    build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: Optional[float] = None):
    """GQA attention forward: the kernel on CUDA, the plain version on CPU."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


flash_attention.launches = 0
"""Kernel launches so far; a caller resets it to 0 around the run it counts."""
