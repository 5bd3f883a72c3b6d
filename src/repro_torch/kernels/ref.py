"""Plain PyTorch oracles for the kernels (counterpart of ``repro.kernels.ref``).

* :func:`mha_naive` materializes the full [*, Sq, Sk] score matrix: the
  ground-truth oracle for tests.
* :func:`mha_blocked_fwd` is the flash-attention recurrence over key/value
  blocks with an online softmax (the reference's ``mha_blocked`` forward),
  returning the output and the per-row log-sum-exp: the plain forward the
  CPU path runs and the kernel is held against on the card;
  :func:`mha_blocked_bwd` is the blocked backward of the reference's
  ``_mha_core_bwd`` (P recomputed from the log-sum-exp, never the whole
  [Sq, Sk] matrix).
* :func:`rmsnorm` with fp32 math and the input dtype kept for the output;
  :func:`rmsnorm_bwd` its gradient (the reference has no rule of its own:
  this is the VJP of its plain ``ref.rmsnorm``).
* :func:`wkv6` is the RWKV-6 recurrence one step at a time: the oracle, and
  the plain version the CPU path runs; :func:`wkv6_chunked` is the chunked
  algorithm of the TPU kernel, held against it in the tests;
  :func:`wkv6_subchunked` mirrors the arithmetic of the Hopper kernel's
  chunked form (tests only: nothing on the path calls it).

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


def _key_mask(qi, start: int, n: int, *, causal: bool, window: int,
              device) -> torch.Tensor:
    """[Sq, n] mask of keys ``start .. start + n`` for query positions ``qi``."""
    ki = torch.arange(start, start + n, device=device)[None, :]
    msk = torch.ones((qi.shape[0], n), dtype=torch.bool, device=device)
    if causal:
        msk &= ki <= qi
    if window and window > 0:
        msk &= ki > qi - window
    return msk


def mha_blocked_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: Optional[float] = None,
                    block_k: int = 512):
    """Flash-attention forward in plain torch: loop over KV blocks with the
    online-softmax recurrence, fp32 running max / sum / accumulator.

    Returns ``(out in q.dtype, lse [B, Hq, Sq] fp32)`` with the natural-log
    ``lse = m + log(max(l, 1e-30))`` (the reference's
    ``_mha_blocked_fwd_pass``).  ``window`` 0 means unlimited.  A row whose
    keys are all masked in a visited block takes the same values the
    recurrence gives in the reference (the -1e30 fill keeps
    ``exp(m_prev - m_new)`` finite)."""
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
        msk = _key_mask(qi, start, kb.shape[2], causal=causal, window=window,
                        device=q.device)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
        s = torch.where(msk[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def mha_blocked_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                    window: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None, block_k: int = 512):
    """Flash-attention backward (the reference's ``_mha_core_bwd``).

    Per KV block, P is recomputed from the saved log-sum-exp,
    ``delta = rowsum(dO * O)``, ``dS = P (dO V^T - delta) * scale``;
    dq accumulates over blocks, dk = dS^T q and dv = P^T dO per block, all in
    fp32.  GQA: dk and dv are summed over each kv head's query group.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    ke = _expand_kv(k, Hq)
    ve = _expand_kv(v, Hq)
    bk = min(block_k, Sk)
    qf = q.float()
    dof = dout.float()
    delta = (dof * out.float()).sum(-1)                      # [B, Hq, Sq]
    qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
    dq = torch.zeros((B, Hq, Sq, D), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for start in range(0, Sk, bk):
        kb = ke[:, :, start:start + bk].float()
        vb = ve[:, :, start:start + bk].float()
        msk = _key_mask(qi, start, kb.shape[2], causal=causal, window=window,
                        device=q.device)
        s = torch.einsum("bhqd,bhkd->bhqk", qf * scale, kb)
        s = torch.where(msk[None, None], s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse[..., None])
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, dof))
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qf))
    g = Hq // Hkv
    dk = torch.cat(dks, 2).reshape(B, Hkv, g, Sk, -1).sum(2)
    dv = torch.cat(dvs, 2).reshape(B, Hkv, g, Sk, -1).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6):
    """Gradient of :func:`rmsnorm` in fp32: with ``xhat = x * rstd`` and
    ``g = dy * scale``, ``dx = rstd * (g - xhat * mean(g * xhat))`` and
    ``dscale = sum over rows of dy * xhat``; results in the dtypes of x and
    scale."""
    x32 = x.float()
    dy32 = dy.float()
    rstd = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    xhat = x32 * rstd
    g = dy32 * scale.float()
    dx = rstd * (g - xhat * torch.mean(g * xhat, dim=-1, keepdim=True))
    dscale = (dy32 * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


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


def _split_bf16(x: torch.Tensor):
    """x as a bf16 pair hi + lo (both returned in fp32): hi = bf16(x),
    lo = bf16(x - hi), as the kernel feeds one fp32 operand to the tensor
    cores."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def wkv6_subchunked(r, k, v, w, u, state0=None, *, split_bf16: bool = False):
    """The chunked form of ``csrc/wkv6.cu`` in plain fp32 torch (tests only).

    Chunks of 64 steps, each cut into four sub-chunks of 16; the last chunk
    is masked past T (k = v = 0, log w = 0, nothing stored).  Log-decays are
    ``lw = log2(max(w, 1e-30))``.  Every decay factor is referenced to the
    boundary between the two positions it joins, so it is ``2^x`` with
    ``x <= 0``: nothing overflows and w = 0 gives no NaN.

    State, per chunk: ``S <- 2^G S + U`` with ``U = sum_i (k_i 2^{D_i})
    v_i^T``, ``D_i`` the sum of lw after step i in the chunk and ``G`` the
    chunk's sum.
    Output pass, per sub-chunk p (rows t) with ``c'`` the inclusive prefix of
    lw within each sub-chunk, ``x_t = c'_{t-1}`` (0 at its first row), ``C_p``
    the sum of lw of the sub-chunks before p and ``G_m`` each sub-chunk's sum:
      inter    (r_t 2^{x_t} 2^{C_p}) S_in
      off-diag keys i of sub-chunk q < p: (r_t 2^{x_t}) . (k_i 2^{E_i}),
               E_i = (G_q - c'_i) + sum_{q<m<p} G_m
      diagonal 16 x 16: its lower-left 8 x 8 quadrant as the product
               (r_t 2^{x_t - c'_7}) . (k_i 2^{c'_7 - c'_i}); the rest pairwise,
               sum_k r_t k_i 2^{x_t - c'_i} for i < t, and the bonus
               r_t . (u * k_t) at i = t
    out = inter + A v.  ``split_bf16`` rounds each tensor-core operand to a
    bf16 hi + lo pair and forms hi*hi + hi*lo + lo*hi in fp32, as the kernel
    does; the output is then rounded once to bf16.  Returns (out, state_T)
    like :func:`wkv6`, out in fp32 (bf16-rounded values with ``split_bf16``).
    """
    C, P = 64, 16
    B, H, T, K = r.shape
    V = v.shape[-1]
    n = -(-T // C)
    pad = n * C - T
    r, k, v = (torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
               for x in (r, k, v))
    lw = torch.nn.functional.pad(
        torch.log2(torch.clamp(w.float(), min=1e-30)), (0, 0, 0, pad))
    u = u.float()[None]                                       # [1, H, K]
    s = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())

    def tc(eq, a, b):
        """A tensor-core product: fp32, or bf16 hi/lo operand pairs."""
        if not split_bf16:
            return torch.einsum(eq, a, b)
        (ah, al), (bh, bl) = _split_bf16(a), _split_bf16(b)
        return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl)
                + torch.einsum(eq, al, bh))

    outs = []
    for c in range(n):
        sl = slice(c * C, (c + 1) * C)
        rc, kc, vc, lc = r[:, :, sl], k[:, :, sl], v[:, :, sl], lw[:, :, sl]
        # sub-chunk prefixes: c' inclusive, x exclusive; G per sub-chunk
        lsub = lc.reshape(B, H, C // P, P, K)
        cin = torch.cumsum(lsub, dim=3)
        cex = torch.nn.functional.pad(cin[:, :, :, :-1],
                                      (0, 0, 1, 0)).reshape(B, H, C, K)
        G = cin[:, :, :, -1]                                  # [B,H,4,K]
        cin = cin.reshape(B, H, C, K)
        out_c = []
        for p in range(C // P):
            rows = slice(p * P, (p + 1) * P)
            rt, xt = rc[:, :, rows], cex[:, :, rows]
            Cp = G[:, :, :p].sum(2, keepdim=True)             # [B,H,1,K]
            rhat = rt * torch.exp2(xt)
            acc = tc("bhtk,bhkv->bhtv", rhat * torch.exp2(Cp), s)
            blocks = []
            for q in range(p):
                keys = slice(q * P, (q + 1) * P)
                E = G[:, :, q:q + 1] - cin[:, :, keys]
                for m in range(q + 1, p):
                    E = E + G[:, :, m:m + 1]
                blocks.append(tc("bhtk,bhik->bhti", rhat,
                                 kc[:, :, keys] * torch.exp2(E)))
            kd, cd = kc[:, :, rows], cin[:, :, rows]
            diag = torch.zeros((B, H, P, P), dtype=torch.float32,
                               device=r.device)
            h = P // 2       # lower-left quadrant, referenced at step h - 1
            mid = cd[:, :, h - 1:h]
            diag[:, :, h:, :h] = tc(
                "bhtk,bhik->bhti", rt[:, :, h:] * torch.exp2(xt[:, :, h:] - mid),
                kd[:, :, :h] * torch.exp2(mid - cd[:, :, :h]))
            for t in range(P):
                for i in range(h if t >= h else 0, t):
                    fac = torch.exp2(torch.clamp(xt[:, :, t] - cd[:, :, i],
                                                 max=0.0))
                    diag[:, :, t, i] = (rt[:, :, t] * kd[:, :, i]
                                        * fac).sum(-1)
                diag[:, :, t, t] = (rt[:, :, t] * u * kd[:, :, t]).sum(-1)
            blocks.append(diag)
            att = torch.cat(blocks, dim=3)                    # [B,H,P,16(p+1)]
            acc = acc + tc("bhti,bhiv->bhtv", att, vc[:, :, :(p + 1) * P])
            out_c.append(acc)
        outs.append(torch.cat(out_c, dim=2))
        # state pass: D_i = sum of lw after step i within the chunk
        D = torch.nn.functional.pad(
            torch.flip(torch.cumsum(torch.flip(lc[:, :, 1:], [2]), 2), [2]),
            (0, 0, 0, 1))
        Gc = lc.sum(2)                                        # [B,H,K]
        s = torch.exp2(Gc)[..., None] * s + tc(
            "bhtk,bhtv->bhkv", kc * torch.exp2(D), vc)
    out = torch.cat(outs, dim=2)[:, :, :T]
    if split_bf16:
        out = out.to(torch.bfloat16).float()
    return out, s
