"""RWKV-6 WKV recurrence: the Hopper kernels' wrapper and its plain version.

Counterpart of :mod:`repro.kernels.rwkv6` (``wkv6_pallas``).  The CUDA
source is ``csrc/wkv6.cu``; see its header for the bound and the design.
:func:`wkv6` launches the kernels for CUDA tensors (or raises) and runs
:func:`wkv6_plain` only for tensors that lie on the CPU.

One entry point, ``wkv6_fwd``, runs one of two forms, picked here by dtype
and T (:func:`uses_chunked_form`):

* bf16 r/k/v with T >= 64 (the prefill): the chunked form in three kernels:
  each chunk's state update ``U = k~^T v`` and decay ``2^G`` (one block a
  chunk, ``mma.sync`` tensor cores), an elementwise scan over the chunks
  (``S_in[c] = S``, ``S <- 2^G S + U``) and the output (one block a chunk:
  inter, off-diagonal and diagonal terms, ``out = inter + A v``).  U and
  S_in live in a scratch that this wrapper allocates.  Every decay factor is
  referenced to the boundary between the two positions it joins, so it is at
  most 1 and nothing overflows; the plain mirror of its arithmetic is
  ``ref.wkv6_subchunked``.
* fp32, or T < 64 (decode runs T = 1): the serial form over B·H x 4 blocks
  of 16 state columns.

At the serving prefill ([1, 32, 2048, 64] bf16, w fp32) the call must move
51.4 MB, 15.3 us at 3.35 TB/s: bound by bytes.

r/k/w: [B, H, T, K]; v: [B, H, T, V]; u: [H, K]; s0: [B, H, K, V] fp32.
Returns (out [B, H, T, V] in r's dtype, state_T [B, H, K, V] fp32).  The
kernels take K = V = 64 (RWKV-6's head size) and any T >= 1; the plain
version takes any K and V.  One call counts one launch, whichever form runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZE = 64
CHUNK = 64
# scratch floats a chunk of the chunked form: S_in and U (64 x 64 fp32
# each) and the chunk's decay 2^G (64 fp32)
SCRATCH_PER_CHUNK = 2 * HEAD_SIZE * HEAD_SIZE + HEAD_SIZE


def uses_chunked_form(dtype: torch.dtype, T: int) -> bool:
    """The chunked form for bf16 r/k/v with T >= 64; :func:`wkv6_cuda` passes
    ``wkv6_fwd`` a scratch exactly then, which selects that form."""
    return dtype == torch.bfloat16 and T >= CHUNK


def wkv6_plain(r, k, v, w, u, s0):
    """The sequential recurrence in fp32 (ref.wkv6), out cast to r's dtype."""
    out, state = ref.wkv6(r, k, v, w, u, s0)
    return out.to(r.dtype), state


def check_inputs(r, k, v, w, u, s0) -> None:
    """The kernel's contract on dtype, shape and layout (any device)."""
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6 kernel takes float32 or bfloat16 r/k/v of one "
                        f"dtype, got {r.dtype}/{k.dtype}/{v.dtype}")
    if w.dtype not in (torch.float32, r.dtype):
        raise TypeError(f"wkv6 kernel takes w in float32 or r's dtype, got "
                        f"{w.dtype}")
    if u.dtype != torch.float32 or s0.dtype != torch.float32:
        raise TypeError(f"wkv6 kernel takes float32 u and s0, got "
                        f"{u.dtype}/{s0.dtype}")
    if r.dim() != 4:
        raise ValueError("wkv6 kernel needs 4-d [B, H, T, K] tensors")
    B, H, T, K = r.shape
    n = HEAD_SIZE
    if (K != n or k.shape != r.shape or w.shape != r.shape
            or v.shape != (B, H, T, n) or u.shape != (H, n)
            or s0.shape != (B, H, n, n) or T < 1):
        raise ValueError(
            f"wkv6 kernel: bad shapes r {tuple(r.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} w {tuple(w.shape)} u {tuple(u.shape)} s0 "
            f"{tuple(s0.shape)} (want K = V = {n}, T >= 1)")
    if B * H > 2 ** 31 - 1:
        raise ValueError(f"wkv6 kernel: B * H = {B * H} blocks is too many")
    if not all(t.is_contiguous() for t in (r, k, v, w, u, s0)):
        raise ValueError("wkv6 kernel needs contiguous r, k, v, w, u, s0")


def wkv6_cuda(r, k, v, w, u, s0):
    """Launch ``csrc/wkv6.cu``; returns (out in r.dtype, state_T fp32)."""
    tensors = (r, k, v, w, u, s0)
    if not all(t.is_cuda and t.device == r.device for t in tensors):
        raise ValueError("wkv6_cuda needs r, k, v, w, u, s0 on one CUDA "
                         "device")
    check_inputs(r, k, v, w, u, s0)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("wkv6 kernel needs 16-byte aligned tensors")
    B, H, T, _ = r.shape
    out = torch.empty_like(v)
    state = torch.empty_like(s0)
    scratch = None
    if uses_chunked_form(r.dtype, T):
        scratch = torch.empty(B * H * -(-T // CHUNK) * SCRATCH_PER_CHUNK,
                              dtype=torch.float32, device=r.device)
    lib = build.load("wkv6")
    fn = lib.wkv6_fwd
    fn.argtypes = build.c_args("p", "p", "p", "p", "p", "p", "p", "p", "p",
                               "i", "i", "i", "i", "i", "p")
    fn.restype = build.ctypes.c_int
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), out.data_ptr(),
                 state.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), B, H, T,
                 _DTYPES[r.dtype], _DTYPES[w.dtype], stream)
    build.check(err, "wkv6_fwd")
    wkv6.launches += 1
    return out, state


def wkv6(r, k, v, w, u, s0):
    """WKV-6 forward from state ``s0``: the kernel on CUDA, plain on CPU."""
    if r.is_cuda:
        return wkv6_cuda(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0)
    raise ValueError(f"wkv6: unsupported device {r.device}")


wkv6.launches = 0
"""Kernel launches so far; a caller resets it to 0 around the run it counts."""
