"""RWKV-6 WKV recurrence: the Hopper kernels' wrappers, their plain versions
and the autograd Function that joins them.

Counterpart of :mod:`repro.kernels.rwkv6` (``wkv6_pallas``) and of the
reference's custom VJP around it (``repro.kernels.ops``, whose backward is
the VJP of the sequential ``ref.wkv6``).  The CUDA source is
``csrc/wkv6.cu``; see its header for the bounds and the design.
:func:`wkv6` and :func:`wkv6_bwd` launch the kernels for CUDA tensors (or
raise) and run the plain versions only for tensors that lie on the CPU.
When grad mode is on and an input requires grad, the forward goes through
:class:`WKV6`, whose backward is :func:`wkv6_bwd` on either device.

The forward entry point, ``wkv6_fwd``, runs one of two forms, picked here by
dtype and T (:func:`uses_chunked_form`):

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

The backward entry point, ``wkv6_bwd``, picks its form by the same rule
(the wrapper passes ``chunked``).  w may underflow to 0, so neither form
gets a state back by dividing by w:

* bf16 with T >= 64 (the training call): the chunked form in six launches,
  the longest serial chain a chunk's 64 steps: each chunk's contributions
  to the state and, backwards in time, to dL/dS (tensor-core products), the
  state entering every chunk and dL/dS leaving every chunk with ds0 (the
  forward's elementwise scan, forwards from s0 and backwards from dS_T), dv
  (the forward's output pass backwards in time on (k, r, dout)), then one
  block a chunk for dr, dk, dw and du's partials: the states at each
  16-step sub-chunk's edges by tensor-core products, their products with
  dout and v, and the sums within a sub-chunk in fp32 with decays as
  running products of w; du summed last, in order (no atomics).  Its
  scratch holds both chunk states, the decays and du's partials; the plain
  mirror of its arithmetic is ``ref.wkv6_subchunked_bwd``.
* fp32, or T < 64: the serial form, fp32 math on the CUDA cores in four
  launches: a checkpoint of the state every 64 steps, the dv / ds0 pass
  (the recurrence backwards in time on the cotangents), the rows pass (dr,
  dk, dw, recomputing the state forward within each chunk from its
  checkpoint) and du's sum over the batch.  Its scratch holds the
  checkpoints.

At the training call ([2, 32, 4096, 64] bf16, w fp32) a backward must move
~372 MB (111 us at 3.35 TB/s); the chunked form's products are ten 64 x 64
x 64 a chunk (21.7 us of bf16 tensor-core time), the serial form's six
64 x 64 FMA sweeps a step and head (12.9 GFLOP, 192 us on the 67 TFLOP/s
fp32 CUDA cores).

r/k/w: [B, H, T, K]; v: [B, H, T, V]; u: [H, K]; s0: [B, H, K, V] fp32.
Returns (out [B, H, T, V] in r's dtype, state_T [B, H, K, V] fp32).  The
kernels take K = V = 64 (RWKV-6's head size) and any T >= 1; the plain
version takes any K and V.  One call counts one launch, whichever form runs,
forward or backward.
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
# the chunked backward's: U then S_in, W then G_out (64 x 64 fp32 each), the
# decay 2^G and du's partial (64 fp32 each)
BWD_SCRATCH_PER_CHUNK = 2 * HEAD_SIZE * HEAD_SIZE + 2 * HEAD_SIZE


def uses_chunked_form(dtype: torch.dtype, T: int) -> bool:
    """The chunked forms for bf16 r/k/v with T >= 64, forward and backward;
    :func:`wkv6_cuda` passes ``wkv6_fwd`` a scratch exactly then, which
    selects that form, and :func:`wkv6_bwd_cuda` passes ``chunked``."""
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
    build.on_one_card(tensors, "wkv6_cuda")
    check_inputs(r, k, v, w, u, s0)
    build.aligned(tensors, "wkv6_cuda")
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


def wkv6_bwd_plain(r, k, v, w, u, s0, dout, dsT=None):
    """(dr, dk, dv, dw, du, ds0) in the inputs' dtypes: autograd through
    the plain forward (the reference's rule: the VJP of ``ref.wkv6``)."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_() for t in (r, k, v, w, u, s0)]
        out, state = ref.wkv6(*xs)
        out = out.to(r.dtype)
        outs, cots = [out], [dout]
        if dsT is not None:
            outs.append(state)
            cots.append(dsT)
        # without dsT, w's last step reaches nothing: its gradient is 0
        return torch.autograd.grad(outs, xs, cots, allow_unused=True,
                                   materialize_grads=True)


def wkv6_bwd_cuda(r, k, v, w, u, s0, dout, dsT=None):
    """Launch ``csrc/wkv6.cu``'s backward (six kernels in the chunked form,
    four in the serial one; one launch counted); returns (dr, dk, dv,
    dw, du, ds0) in the dtypes of r, k, v, w, u and s0.  ``dsT`` (the final
    state's cotangent) may be None."""
    tensors = (r, k, v, w, u, s0, dout) + (() if dsT is None else (dsT,))
    build.on_one_card(tensors, "wkv6_bwd_cuda")
    check_inputs(r, k, v, w, u, s0)
    if dout.shape != v.shape or dout.dtype != v.dtype \
            or not dout.is_contiguous():
        raise ValueError(f"wkv6 backward: dout {tuple(dout.shape)} "
                         f"{dout.dtype} must be a contiguous tensor like v "
                         f"{tuple(v.shape)} {v.dtype}")
    if dsT is not None and (dsT.shape != s0.shape or dsT.dtype != s0.dtype
                            or not dsT.is_contiguous()):
        raise ValueError(f"wkv6 backward: dsT {tuple(dsT.shape)} "
                         f"{dsT.dtype} must be a contiguous tensor like s0")
    B, H, T, _ = r.shape
    grads = [torch.empty_like(t) for t in (r, k, v, w, u, s0)]
    chunked = uses_chunked_form(r.dtype, T)
    n = -(-T // CHUNK)
    size = (n * BWD_SCRATCH_PER_CHUNK if chunked
            else n * HEAD_SIZE * HEAD_SIZE + HEAD_SIZE)
    scratch = torch.empty(B * H * size, dtype=torch.float32, device=r.device)
    build.aligned(tensors + tuple(grads) + (scratch,), "wkv6_bwd_cuda")
    lib = build.load("wkv6")
    fn = lib.wkv6_bwd
    fn.argtypes = build.c_args(*"p" * 15, *"i" * 6, "p")
    fn.restype = build.ctypes.c_int
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in (r, k, v, w, u, s0, dout)),
                 None if dsT is None else dsT.data_ptr(),
                 *(g.data_ptr() for g in grads), scratch.data_ptr(),
                 B, H, T, _DTYPES[r.dtype], _DTYPES[w.dtype], int(chunked),
                 stream)
    build.check(err, "wkv6_bwd")
    wkv6_bwd.launches += 1
    return tuple(grads)


def _forward(r, k, v, w, u, s0):
    if r.is_cuda:
        return wkv6_cuda(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0)
    raise ValueError(f"wkv6: unsupported device {r.device}")


def wkv6_bwd(r, k, v, w, u, s0, dout, dsT=None):
    """WKV-6 backward: the kernels on CUDA, the plain version on CPU."""
    if r.is_cuda:
        return wkv6_bwd_cuda(r, k, v, w, u, s0, dout, dsT)
    if r.device.type == "cpu":
        return wkv6_bwd_plain(r, k, v, w, u, s0, dout, dsT)
    raise ValueError(f"wkv6_bwd: unsupported device {r.device}")


wkv6_bwd.launches = 0
"""Backward launches so far; a caller resets it to 0 around the run it counts."""


class WKV6(torch.autograd.Function):
    """WKV-6 whose backward is :func:`wkv6_bwd`: it saves only the inputs
    (the kernel recomputes the states it needs), and an input that does not
    require grad gets None."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        return _forward(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, dout, dsT):
        r, k, v, w, u, s0 = ctx.saved_tensors
        dout = (torch.zeros_like(v) if dout is None
                else dout.to(v.dtype).contiguous())
        dsT = None if dsT is None else dsT.float().contiguous()
        grads = wkv6_bwd(r, k, v, w, u, s0, dout, dsT)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def wkv6(r, k, v, w, u, s0):
    """WKV-6 forward from state ``s0``: the kernel on CUDA, plain on CPU;
    differentiable through :class:`WKV6` when grad is wanted."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, s0)):
        return WKV6.apply(r, k, v, w, u, s0)
    return _forward(r, k, v, w, u, s0)


wkv6.launches = 0
"""Forward kernel launches so far; a caller resets it to 0 around the run it
counts."""
