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
                    scale: Optional[float] = None, block_k: int = 512,
                    head_slices: int = 1):
    """Flash-attention backward (the reference's ``_mha_core_bwd``).

    Per KV block, P is recomputed from the saved log-sum-exp,
    ``delta = rowsum(dO * O)``, ``dS = P (dO V^T - delta) * scale``;
    dq accumulates over blocks, dk = dS^T q and dv = P^T dO per block, all in
    fp32.  GQA: dk and dv are summed over each kv head's query group; with
    ``head_slices`` > 1 as the bf16 D-256 kernel sums them (its
    ``flash_attention_bwd_slices``): the group cut into that many runs of
    heads (run s from s * g // n), each run summed, then the runs in order.
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
    if g % head_slices:
        raise ValueError(f"head_slices {head_slices} must divide the group "
                         f"{g}")
    cuts = [s * g // head_slices for s in range(head_slices + 1)]

    def group_sum(parts):
        per_head = torch.cat(parts, 2).reshape(B, Hkv, g, Sk, -1)
        total = per_head[:, :, cuts[0]:cuts[1]].sum(2)
        for lo, hi in zip(cuts[1:-1], cuts[2:]):
            total = total + per_head[:, :, lo:hi].sum(2)
        return total

    dk, dv = group_sum(dks), group_sum(dvs)
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


def _tensor_core(split_bf16: bool):
    """A tensor-core product ``tc(eq, a, b)``: fp32, or with each operand
    split into a bf16 hi/lo pair and hi*hi + hi*lo + lo*hi summed in fp32
    (an operand exact in bf16 has lo = 0), as the kernels form it."""
    def tc(eq, a, b):
        if not split_bf16:
            return torch.einsum(eq, a, b)
        (ah, al), (bh, bl) = _split_bf16(a), _split_bf16(b)
        return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl)
                + torch.einsum(eq, al, bh))
    return tc


def _chunk_update(kc, vc, lc, s, tc):
    """One chunk of the state scan: ``2^G s + (k 2^D)^T v`` with ``D_i`` the
    sum of lw after step i within the chunk (a direct suffix sum) and ``G``
    the chunk's sum (the kernels' update and scan passes)."""
    D = torch.nn.functional.pad(
        torch.flip(torch.cumsum(torch.flip(lc[:, :, 1:], [2]), 2), [2]),
        (0, 0, 0, 1))
    return torch.exp2(lc.sum(2))[..., None] * s + tc(
        "bhtk,bhtv->bhkv", kc * torch.exp2(D), vc)


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

    tc = _tensor_core(split_bf16)
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
        s = _chunk_update(kc, vc, lc, s, tc)
    out = torch.cat(outs, dim=2)[:, :, :T]
    if split_bf16:
        out = out.to(torch.bfloat16).float()
    return out, s


def wkv6_subchunked_bwd(r, k, v, w, u, s0, dout, dsT=None, *,
                        split_bf16: bool = False):
    """The chunked backward of ``csrc/wkv6.cu`` in plain fp32 torch (tests
    only): (dr, dk, dv, dw, du, ds0), the VJP of :func:`wkv6` from
    cotangents ``dout`` and ``dsT`` (None: zero).

    Time is cut into chunks of 64 steps, padded past T with k = v = r =
    dout = 0 and w = 1.  With S_t the state before step t and G_t = dL/dS_t
    (G_T = dsT), per chunk:

    * ``S_in`` (the state entering each chunk) by the forward's chunk update
      and scan (:func:`_chunk_update`); ``G_out`` (G leaving each chunk) and
      ds0 by the same run backwards in time on (r, dout) from dsT, and dv by
      the forward's chunked form backwards in time on (k, r, dout): ``G_t =
      w_t G_{t+1} + r_t dout_t^T`` is the forward's recurrence there, its
      output dv and its final state ds0.
    * Sub-chunks p of 16 steps, with the products of w over them (no log,
      no division): ``x_t`` over the steps of p before t, ``y_t`` over
      those after t, ``g_p`` over all 16, ``D[t,i]`` over the steps
      strictly between i and t.  The states at p's edges, ``S_p`` entering
      it and ``Γ_p`` leaving it, follow from S_in and G_out by
      ``S_{p+1} = g_p S_p + (k y)_p^T v_p`` and
      ``Γ_{p-1} = g_p Γ_p + (r x)_p^T dout_p`` (tensor-core products).
      Then with ``Z_t = S_p dout_t``, ``X_t = Γ_p v_t``,
      ``A[t,i] = dout_t · v_i`` (products) and ``c_p = rowsum(S_p ⊙ Γ_p)``:
        dr_t = x_t Z_t + sum_{i<t} A[t,i] D[t,i] k_i + u k_t A[t,t]
        dk_t = y_t X_t + sum_{j>t} A[j,t] D[j,t] r_j + u r_t A[t,t]
        dw_t = x_t y_t c_p + y_t sum_{i<t} D[t,i] k_i X_i
               + x_t sum_{j>t} D[j,t] r_j Z_j
               + sum_{i<t<j} D[t,i] D[j,t] k_i r_j A[j,i]
        du  += r_t k_t A[t,t]
      the sums over i and j within p in fp32, by recurrences in t (the sum
      over i < t as ``M[j] <- w_t M[j] + k_t A[j,t]``, the sum over i < t of
      dw's second term likewise): dw_t = rowsum(G_{t+1} ⊙ S_t)
      with ``S_t = x_t S_p + sum_{i<t} D[t,i] k_i v_i^T`` and
      ``G_{t+1} = y_t Γ_p + sum_{j>t} D[j,t] r_j dout_j^T``, never by
      dividing by w (it underflows to 0).

    ``split_bf16`` forms each product as the kernels do (an fp32 operand as
    a bf16 hi/lo pair) and rounds dr, dk and dv to bf16.  Returns fp32
    tensors of the shapes of r, k, v, w, u and s0."""
    C, P = 64, 16
    B, H, T, K = r.shape
    V = v.shape[-1]
    n = -(-T // C)
    pad = (0, 0, 0, n * C - T)
    r, k, v, do = (torch.nn.functional.pad(x.float(), pad)
                   for x in (r, k, v, dout))
    w = torch.nn.functional.pad(w.float(), pad, value=1.0)
    lw = torch.log2(torch.clamp(w, min=1e-30))
    u = u.float()[None]                                       # [1, H, K]
    gT = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
          if dsT is None else dsT.float())
    tc = _tensor_core(split_bf16)

    def chunks(x):
        return [x[:, :, c * C:(c + 1) * C] for c in range(n)]

    s_in, s = [], s0.float()
    for kc, vc, lc in zip(chunks(k), chunks(v), chunks(lw)):
        s_in.append(s)
        s = _chunk_update(kc, vc, lc, s, tc)
    g_out, g = [None] * n, gT
    for c in reversed(range(n)):
        g_out[c] = g
        rc, dc, lc = (torch.flip(x[:, :, c * C:(c + 1) * C], [2])
                      for x in (r, do, lw))
        g = _chunk_update(rc, dc, lc, g, tc)
    ds0 = g
    flip = lambda x: torch.flip(x, [2])                       # noqa: E731
    dv, _ = wkv6_subchunked(flip(k), flip(r), flip(do), flip(w), u[0], gT,
                            split_bf16=split_bf16)
    dv = flip(dv)

    dr, dk, dw = (torch.zeros_like(r) for _ in range(3))
    du = torch.zeros((B, H, K), dtype=torch.float32, device=r.device)
    for c in range(n):
        S, Gam = s_in[c], g_out[c]
        sub = [slice(c * C + p * P, c * C + (p + 1) * P) for p in range(C // P)]
        wp = [w[:, :, sl] for sl in sub]
        ones = torch.ones_like(wp[0][:, :, 0])
        x, y, g = [], [], []
        for ws in wp:                    # exclusive prefix / suffix products
            xs, ys, a, b = [], [None] * P, ones, ones
            for l in range(P):
                xs.append(a)
                a = a * ws[:, :, l]
            for l in reversed(range(P)):
                ys[l] = b
                b = b * ws[:, :, l]
            x.append(torch.stack(xs, 2))
            y.append(torch.stack(ys, 2))
            g.append(a)
        Ss, Gs = [S], [None] * 4
        for p in range(3):
            Ss.append(g[p][..., None] * Ss[-1] + tc(
                "bhtk,bhtv->bhkv", k[:, :, sub[p]] * y[p], v[:, :, sub[p]]))
        Gs[3] = Gam
        for p in (3, 2, 1):
            Gs[p - 1] = g[p][..., None] * Gs[p] + tc(
                "bhtk,bhtv->bhkv", r[:, :, sub[p]] * x[p], do[:, :, sub[p]])
        for p, sl in enumerate(sub):
            rp, kp, vp, dp, ws = r[:, :, sl], k[:, :, sl], v[:, :, sl],                 do[:, :, sl], w[:, :, sl]
            Z = tc("bhtv,bhkv->bhtk", dp, Ss[p])
            X = tc("bhtv,bhkv->bhtk", vp, Gs[p])
            cp = (Ss[p] * Gs[p]).sum(-1)
            A = torch.einsum("bhtv,bhiv->bhti", dp, vp)
            # by recurrences in t, as the kernel runs them: M[j] = sum_{i<t}
            # D[t,i] k_i A[j,i] (j >= t), yf = sum_{i<t} D[t,i] k_i X_i,
            # xt = x_t; F[j] = D[j,t] r_j (j > t) by a running product that
            # ends at y_t
            zeros = torch.zeros_like(ones)
            M, yf, xt = [zeros] * P, zeros, ones
            for t in range(P):
                F, f = {}, ones
                for j in range(t + 1, P):
                    F[j] = f * rp[:, :, j]
                    f = f * ws[:, :, j]
                att = A[:, :, t, t][..., None]
                rt, kt, wt = rp[:, :, t], kp[:, :, t], ws[:, :, t]
                drt = xt * Z[:, :, t] + (M[t] + u * kt * att)
                dkt = f * X[:, :, t] + u * rt * att
                sb, lt = zeros, zeros
                for j in range(t + 1, P):
                    a = A[:, :, j, t][..., None]
                    dkt = dkt + a * F[j]
                    sb = sb + F[j] * Z[:, :, j]
                    lt = lt + F[j] * M[j]
                    M[j] = wt * M[j] + kt * a
                dwt = xt * f * cp + (f * yf + (xt * sb + lt))
                dr[:, :, sl.start + t] = drt
                dk[:, :, sl.start + t] = dkt
                dw[:, :, sl.start + t] = dwt
                du = du + rt * kt * att
                yf = wt * yf + kt * X[:, :, t]
                xt = xt * wt
    dr, dk, dv, dw = (x[:, :, :T] for x in (dr, dk, dv, dw))
    if split_bf16:
        dr, dk, dv = (x.to(torch.bfloat16).float() for x in (dr, dk, dv))
    return dr, dk, dv, dw, du.sum(0), ds0
