"""Flash attention: the Hopper kernels' wrappers, their plain versions and
the autograd Function that joins them.

Counterpart of :mod:`repro.kernels.flash_attention` and of the reference's
``ops._attention_pallas`` custom VJP.  The CUDA source is
``csrc/flash_attention.cu``; see its header for the bounds and the design.
:func:`flash_attention` and :func:`flash_attention_bwd` launch the kernels
for CUDA tensors (or raise) and run the plain versions only for tensors that
lie on the CPU.  When grad mode is on and q, k or v requires grad, the
forward goes through :class:`FlashAttention`, which also keeps the per-row
log-sum-exp and runs :func:`flash_attention_bwd` in its backward: the same
Function on both devices, so the CPU tests exercise the path the card runs.

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
HEAD_DIMS = (64, 128, 256)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, scale: Optional[float] = None,
                          return_lse: bool = False):
    """The same online-softmax recurrence in plain torch (ref.mha_blocked_fwd);
    with ``return_lse`` also the per-row log-sum-exp."""
    out, lse = ref.mha_blocked_fwd(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0,
                              scale: Optional[float] = None):
    """The blocked backward in plain torch (ref.mha_blocked_bwd)."""
    return ref.mha_blocked_bwd(q, k, v, out, lse, dout, causal=causal,
                               window=window, q_offset=q_offset, scale=scale)


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


def check_bwd_inputs(q, k, v, out, lse, dout, q_offset: int) -> None:
    """The backward kernel's contract: the forward's, plus out / dout like q,
    lse [B, Hq, Sq] fp32, and the training case Sq == Sk with q_offset 0."""
    check_inputs(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"flash attention backward: {name} "
                             f"{tuple(t.shape)} {t.dtype} must be a "
                             f"contiguous tensor like q {tuple(q.shape)} "
                             f"{q.dtype}")
    if (lse.shape != q.shape[:3] or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"flash attention backward: lse must be contiguous "
                         f"fp32 {tuple(q.shape[:3])}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if q.shape[2] != k.shape[2] or q_offset != 0:
        raise ValueError(f"flash attention backward kernel takes Sq == Sk and "
                         f"q_offset 0 (training), got Sq {q.shape[2]}, Sk "
                         f"{k.shape[2]}, q_offset {q_offset}")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0, scale: Optional[float] = None,
                         return_lse: bool = False):
    """Launch the forward of ``csrc/flash_attention.cu``; returns
    [B, Hq, Sq, D] in q.dtype, and with ``return_lse`` also the fp32
    [B, Hq, Sq] log-sum-exp the kernel writes beside it."""
    build.on_one_card((q, k, v), "flash_attention_cuda")
    check_inputs(q, k, v)
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    build.aligned((q, k, v, out), "flash_attention_cuda")
    scale = float(scale if scale is not None else D ** -0.5)
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = build.c_args("p", "p", "p", "p", "p", "i", "i", "i", "i",
                               "i", "i", "f", "i", "i", "i", "i", "p")
    fn.restype = build.ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), B, Hq, Hkv, Sq, Sk,
                 D, scale, int(bool(causal)), int(window or 0), int(q_offset),
                 _DTYPES[q.dtype], stream)
    build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


def bwd_scratch_floats(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, D: int,
                       slices: int) -> int:
    """fp32 scratch of the backward: delta's B * Hq * Sq floats, and with
    more than one q-head slice (bf16 at D 256) the dK and dV partials after
    them, from the next multiple of 64 (``flash_attention_bwd``'s layout)."""
    rows = B * Hq * Sq
    if slices == 1:
        return rows
    return -(-rows // 64) * 64 + 2 * slices * B * Hkv * Sk * D


def bwd_head_slices(q, k, *, causal: bool = True, window: int = 0) -> int:
    """q-head slices of the kernels' dK / dV sums for this call (1 but for
    bf16 at D 256, where the card's kernel picks them to fill the SMs)."""
    B, Hq, _, D = q.shape
    _, Hkv, Sk, _ = k.shape
    fn = build.load("flash_attention").flash_attention_bwd_slices
    fn.argtypes = build.c_args("i", "i", "i", "i", "i", "i", "i", "i")
    fn.restype = build.ctypes.c_int
    return int(fn(B, Hq, Hkv, Sk, D, int(bool(causal)), int(window or 0),
                  _DTYPES[q.dtype]))


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: int = 0, q_offset: int = 0,
                             scale: Optional[float] = None):
    """Launch the backward of ``csrc/flash_attention.cu`` (three kernels, or
    at bf16 D 256 with several q-head slices four, one launch counted);
    returns (dq, dk, dv) in q's dtype."""
    tensors = (q, k, v, out, lse, dout)
    build.on_one_card(tensors, "flash_attention_bwd_cuda")
    check_bwd_inputs(q, k, v, out, lse, dout, q_offset)
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    slices = bwd_head_slices(q, k, causal=causal, window=window)
    delta = torch.empty(bwd_scratch_floats(B, Hq, Hkv, Sq, Sk, D, slices),
                        dtype=torch.float32, device=q.device)
    build.aligned(tensors + (dq, dk, dv, delta), "flash_attention_bwd_cuda")
    scale = float(scale if scale is not None else D ** -0.5)
    lib = build.load("flash_attention")
    fn = lib.flash_attention_bwd
    fn.argtypes = build.c_args("p", "p", "p", "p", "p", "p", "p", "p", "p",
                               "p", "i", "i", "i", "i", "i", "i", "f", "i",
                               "i", "i", "i", "p")
    fn.restype = build.ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq,
                 Sk, D, scale, int(bool(causal)), int(window or 0),
                 int(q_offset), _DTYPES[q.dtype], stream)
    build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def _forward(q, k, v, return_lse: bool, **kw):
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, return_lse=return_lse, **kw)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, return_lse=return_lse, **kw)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0,
                        scale: Optional[float] = None):
    """GQA attention backward: the kernels on CUDA, the plain version on CPU."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    if q.is_cuda:
        return flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")


flash_attention_bwd.launches = 0
"""Backward launches so far; a caller resets it to 0 around the run it counts."""


class FlashAttention(torch.autograd.Function):
    """Attention whose backward is :func:`flash_attention_bwd` (the
    reference's custom VJP, ``ops._attention_pallas``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  scale=scale)
        out, lse = _forward(q, k, v, True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: Optional[float] = None):
    """GQA attention forward: the kernel on CUDA, the plain version on CPU;
    differentiable through :class:`FlashAttention` when grad is wanted."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, q_offset, scale)
    return _forward(q, k, v, False, causal=causal, window=window,
                    q_offset=q_offset, scale=scale)


flash_attention.launches = 0
"""Forward kernel launches so far; a caller resets it to 0 around the run it
counts."""
