"""Plain PyTorch oracles for the kernels (counterpart of ``repro.kernels.ref``).

* :func:`mha_naive` materializes the full [*, Sq, Sk] score matrix: the
  ground-truth oracle for tests.
* :func:`mha_blocked` is the flash-attention recurrence over key/value
  blocks with an online softmax, forward only: the plain version the CPU
  path runs and the kernel is held against on the card.
* :func:`rmsnorm` with fp32 math and the input dtype kept for the output.
* :func:`wkv6` is the RWKV-6 recurrence one step at a time: the oracle, and
  the plain version the CPU path runs; :func:`wkv6_chunked` is the chunked
  algorithm of the TPU kernel, held against it in the tests.

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


# ---------------------------------------------------------------------------
# RWKV-6 (Finch) WKV recurrence
# ---------------------------------------------------------------------------

def wkv6(r, k, v, w, u, state0=None):
    """RWKV-6 recurrence, sequential oracle (fp32 math).

    Shapes: r/k/w [B, H, T, K]; v [B, H, T, V]; u [H, K]; state [B, H, K, V].
      out_t  = r_t · (state_t + u ⊙ k_t ⊗ v_t)
      state' = diag(w_t) state_t + k_t ⊗ v_t            (w data-dependent)
    Returns (out [B, H, T, V] fp32, state_T fp32).
    """
    B, H, T, K = r.shape
    V = v.shape[-1]
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()[None, :, :, None]
    s = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    outs = []
    for t in range(T):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]            # [B,H,K,V]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t], s + u * kv))
        s = w[:, :, t, :, None] * s + kv
    out = (torch.stack(outs, 2) if outs
           else torch.zeros((B, H, 0, V), dtype=torch.float32, device=r.device))
    return out, s


def wkv6_chunked(r, k, v, w, u, state0=None, *, chunk: int = 64):
    """Chunked WKV-6: T/C sequential steps, C x C parallel work per chunk.

    The algorithm of the TPU kernel: within a chunk, with cumulative
    log-decays cum_t = sum_{s<=t} log w_s,
      out_t = r_t·(exp(cum_{t-1}) S_in) + sum_{i<t} exp(cum_{t-1} - cum_i)
              (r_t·k_i) v_i + (r_t·(u ⊙ k_t)) v_t
      S_out = exp(cum_C) S_in + sum_i exp(cum_C - cum_i) k_i ⊗ v_i
    Needs T % min(chunk, T) == 0 and w bounded away from 0."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    C = min(chunk, T)
    if T % C:
        raise ValueError(f"T={T} not divisible by chunk={C}")
    n = T // C
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()
    s = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    logw = torch.log(torch.clamp(w, min=1e-30)).reshape(B, H, n, C, K)
    rc = r.reshape(B, H, n, C, K)
    kc = k.reshape(B, H, n, C, K)
    vc = v.reshape(B, H, n, C, V)
    cum = torch.cumsum(logw, dim=3)                           # [B,H,n,C,K]
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    outs = []
    for c in range(n):
        rC, kC, vC, cumC, logwC = (x[:, :, c] for x in (rc, kc, vc, cum,
                                                         logw))
        totC = cumC[:, :, -1]                                 # [B,H,K]
        qd = cumC - logwC                                     # cum_{t-1}
        inter = torch.einsum("bhck,bhkv->bhcv", rC * torch.exp(qd), s)
        att = torch.einsum(
            "bhctk->bhct",
            rC[:, :, :, None, :] * kC[:, :, None, :, :]
            * torch.exp(qd[:, :, :, None, :] - cumC[:, :, None, :, :]))
        att = torch.where(tri[None, None], att, torch.zeros_like(att))
        bonus = torch.einsum("bhck,bhck->bhc", rC, kC * u[None, :, None, :])
        outs.append(inter + torch.einsum("bhct,bhtv->bhcv", att, vC)
                    + bonus[..., None] * vC)
        kdecay = torch.exp(totC[:, :, None, :] - cumC)       # prod_{j>i} w_j
        s = torch.exp(totC)[..., None] * s + torch.einsum(
            "bhck,bhcv->bhkv", kC * kdecay, vC)
    return torch.stack(outs, 2).reshape(B, H, T, V), s
