"""Fused RMSNorm: the Hopper kernel's wrapper and its plain version.

Counterpart of :mod:`repro.kernels.rmsnorm` (``rmsnorm_pallas``).  The CUDA
source is ``csrc/rmsnorm.cu``; see its header for the bound and the design.
:func:`rmsnorm` launches the kernel for a CUDA tensor (or raises) and runs
:func:`rmsnorm_plain` only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * scale`` in fp32, output in ``x.dtype``."""
    return ref.rmsnorm(x, scale, eps)


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
    """Launch ``csrc/rmsnorm.cu`` on ``x`` [..., D] and ``scale`` [D]."""
    if not (x.is_cuda and scale.is_cuda and x.device == scale.device):
        raise ValueError("rmsnorm_cuda needs x and scale on one CUDA device")
    check_inputs(x, scale)
    d = x.shape[-1]
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    if (x.data_ptr() | scale.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("rmsnorm_cuda needs 16-byte aligned tensors")
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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMSNorm over the last axis: the kernel on CUDA, the plain version on CPU."""
    if x.is_cuda:
        return rmsnorm_cuda(x, scale, eps)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    raise ValueError(f"rmsnorm: unsupported device {x.device}")


rmsnorm.launches = 0
"""Kernel launches so far; a caller resets it to 0 around the run it counts."""
