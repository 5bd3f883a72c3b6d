"""Fused RMSNorm: the Hopper kernels' wrappers, their plain versions and the
autograd Function that joins them.

Counterpart of :mod:`repro.kernels.rmsnorm` (``rmsnorm_pallas``, which has
no reverse-mode rule in the reference: the gradient here is that of its
plain ``ref.rmsnorm``).  The CUDA source is ``csrc/rmsnorm.cu``; see its
header for the bound and the design.  :func:`rmsnorm` and
:func:`rmsnorm_bwd` launch the kernels for CUDA tensors (or raise) and run
the plain versions only for tensors that lie on the CPU.  When grad mode is
on and x or scale requires grad, the forward goes through :class:`RMSNorm`,
whose backward is :func:`rmsnorm_bwd` on either device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_MIN_ROWS_PER_BLOCK = 16     # rows a block of the backward takes, at least
BWD_BLOCKS_PER_SM = 2           # resident blocks of 8 warps the grid aims at


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * scale`` in fp32, output in ``x.dtype``."""
    return ref.rmsnorm(x, scale, eps)


def rmsnorm_bwd_plain(x, scale, dy, eps: float = 1e-6):
    """(dx, dscale) in fp32 math (ref.rmsnorm_bwd)."""
    return ref.rmsnorm_bwd(x, scale, dy, eps)


def check_inputs(x: torch.Tensor, scale: torch.Tensor) -> None:
    """The kernel's contract on dtype, shape and layout (any device)."""
    if x.dtype not in _DTYPES or scale.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16 x with a "
                        f"scale of the same dtype, got {x.dtype}/{scale.dtype}")
    d = x.shape[-1]
    vec = 16 // x.element_size()
    if scale.shape != (d,) or d % vec:
        raise ValueError(f"rmsnorm kernel needs scale [{d}] and D % {vec} == 0,"
                         f" got x {tuple(x.shape)}, scale {tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and scale")


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """Launch ``csrc/rmsnorm.cu``'s forward on ``x`` [..., D], ``scale`` [D]."""
    build.on_one_card((x, scale), "rmsnorm_cuda")
    check_inputs(x, scale)
    d = x.shape[-1]
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    build.aligned((x, scale, out), "rmsnorm_cuda")
    lib = build.load("rmsnorm")
    fn = lib.rmsnorm_fwd
    fn.argtypes = build.c_args("p", "p", "p", "i", "i", "f", "i", "p")
    fn.restype = build.ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                 float(eps), _DTYPES[x.dtype], stream)
    build.check(err, "rmsnorm_fwd")
    rmsnorm.launches += 1
    return out


def rmsnorm_bwd_cuda(x, scale, dy, eps: float = 1e-6):
    """Launch ``csrc/rmsnorm.cu``'s backward (two kernels, one launch
    counted); returns (dx, dscale) in the dtypes of x and scale."""
    build.on_one_card((x, scale, dy), "rmsnorm_bwd_cuda")
    check_inputs(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"rmsnorm backward: dy {tuple(dy.shape)} {dy.dtype} "
                         f"must be a contiguous tensor like x "
                         f"{tuple(x.shape)} {x.dtype}")
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_blocks = min(BWD_BLOCKS_PER_SM * sms,
                   -(-rows // BWD_MIN_ROWS_PER_BLOCK))
    partial = torch.empty((n_blocks, d), dtype=torch.float32, device=x.device)
    build.aligned((x, scale, dy, dx, dscale, partial), "rmsnorm_bwd_cuda")
    lib = build.load("rmsnorm")
    fn = lib.rmsnorm_bwd
    fn.argtypes = build.c_args("p", "p", "p", "p", "p", "p", "i", "i", "i",
                               "f", "i", "p")
    fn.restype = build.ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 dscale.data_ptr(), partial.data_ptr(), n_blocks, rows, d,
                 float(eps), _DTYPES[x.dtype], stream)
    build.check(err, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx, dscale


def _forward(x, scale, eps):
    if x.is_cuda:
        return rmsnorm_cuda(x, scale, eps)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    raise ValueError(f"rmsnorm: unsupported device {x.device}")


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-6):
    """RMSNorm backward: the kernels on CUDA, the plain version on CPU."""
    if x.is_cuda:
        return rmsnorm_bwd_cuda(x, scale, dy, eps)
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(x, scale, dy, eps)
    raise ValueError(f"rmsnorm_bwd: unsupported device {x.device}")


rmsnorm_bwd.launches = 0
"""Backward launches so far; a caller resets it to 0 around the run it counts."""


class RMSNorm(torch.autograd.Function):
    """RMSNorm whose backward is :func:`rmsnorm_bwd` (rstd recomputed)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMSNorm over the last axis: the kernel on CUDA, the plain version on
    CPU; differentiable through :class:`RMSNorm` when grad is wanted."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x, scale, eps)
    return _forward(x, scale, eps)


rmsnorm.launches = 0
"""Forward kernel launches so far; a caller resets it to 0 around the run it
counts."""
