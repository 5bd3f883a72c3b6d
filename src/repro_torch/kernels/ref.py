"""Plain PyTorch oracles for the kernels (counterpart of ``repro.kernels.ref``).

* :func:`mha_naive` materializes the full [*, Sq, Sk] score matrix: the
  ground-truth oracle for tests.
* :func:`mha_blocked` is the flash-attention recurrence over key/value
  blocks with an online softmax, forward only: the plain version the CPU
  path runs and the kernel is held against on the card.
* :func:`rmsnorm` with fp32 math and the input dtype kept for the output.

GQA convention everywhere: q is [B, Hq, Sq, D]; k/v are [B, Hkv, Sk, D] with
Hq % Hkv == 0 (kv heads broadcast over Hq // Hkv query groups).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _expand_kv(k: torch.Tensor, hq: int) -> torch.Tensor:
    hkv = k.shape[1]
    if hkv == hq:
        return k
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    return torch.repeat_interleave(k, hq // hkv, dim=1)


def attention_mask(sq: int, sk: int, *, causal: bool, window: int = 0,
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """[Sq, Sk] boolean mask; ``q_offset`` positions queries within the key
    timeline."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= ki <= qi
    if window and window > 0:
        m &= ki > qi - window
    return m


def mha_naive(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, scale: Optional[float] = None):
    """Ground-truth attention oracle (materializes scores)."""
    B, Hq, Sq, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    k = _expand_kv(k, Hq)
    v = _expand_kv(v, Hq)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = attention_mask(Sq, k.shape[2], causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def mha_blocked(q, k, v, *, causal: bool = True, window: int = 0,
                q_offset: int = 0, scale: Optional[float] = None,
                block_k: int = 512):
    """Flash-attention forward in plain torch: loop over KV blocks with the
    online-softmax recurrence, fp32 running max / sum / accumulator.

    ``window`` 0 means unlimited.  A row whose keys are all masked in a
    visited block takes the same values the recurrence gives in the
    reference (the -1e30 fill keeps ``exp(m_prev - m_new)`` finite)."""
    B, Hq, Sq, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    k = _expand_kv(k, Hq)
    v = _expand_kv(v, Hq)
    Sk, Dv = k.shape[2], v.shape[-1]
    bk = min(block_k, Sk)
    qf = q.float() * scale
    qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
    acc = torch.zeros((B, Hq, Sq, Dv), dtype=torch.float32, device=q.device)
    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
    for start in range(0, Sk, bk):
        # the tail block is padded in the reference; padded keys are masked,
        # which the slice below reproduces exactly except for a row that is
        # masked in every block (not a case the kernels' callers produce)
        kb = k[:, :, start:start + bk].float()
        vb = v[:, :, start:start + bk].float()
        ki = torch.arange(start, start + kb.shape[2], device=q.device)[None, :]
        msk = torch.ones((Sq, kb.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            msk &= ki <= qi
        if window and window > 0:
            msk &= ki > qi - window
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
        s = torch.where(msk[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return (acc / l[..., None]).to(q.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
