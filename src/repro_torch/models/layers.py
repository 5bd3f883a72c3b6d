"""Model primitives: norms, RoPE, attention (self and cross), the MLPs,
the MoE dispatch and the selective SSM.

Counterpart of :mod:`repro.models.layers`.  Per-layer constants
(identity-pad mask, window, causal flag) are host values here: the port
runs each layer eagerly, so what the reference keeps as traced data is a
Python scalar.

Tensor parallelism (Megatron's splits, which the reference's sharding
constraints ask GSPMD for): given a ``tp`` axis (``p2p.AxisGroup``), a
layer runs its own heads, columns of the MLP or experts on weights that
are already this rank's block, takes its input through
:func:`tp_copy` (forward the identity, backward the sum over ``tp``) and
returns its output through :func:`tp_reduce` (forward the sum over
``tp``, backward the identity).  Each sum folds in tp-rank order, through
the host, so every rank holds the same bits.  Without ``tp`` every layer
is the single-device one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionConfig, MoEConfig, SSMConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, _expand_kv


def _check_kind(what: str, got: str, ported: tuple) -> None:
    if got not in ported:
        raise NotImplementedError(
            f"{what}={got!r} is not ported (only {ported}): no arch of "
            "the reference uses it")


# ---------------------------------------------------------------------------
# Tensor parallelism: the tp collectives as autograd functions
# ---------------------------------------------------------------------------

TP_SUM = "tp_sum"            # collective classes (``AxisGroup.stats``)
TP_GATHER = "tp_gather"


@dataclass(frozen=True)
class LayerMesh:
    """What a block's layers see of the mesh: the ``tp`` axis for each
    sub-module whose work splits over it (None: the whole module on every
    rank) and the data-parallel replicas, which a MoE dispatch group must
    not straddle."""
    attn: Any = None
    mlp: Any = None
    moe: Any = None
    replicas: int = 1


class _CopyToTP(torch.autograd.Function):
    """A replicated value each tp rank uses for its own part of the work:
    forward the identity, backward the sum of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, tp, x):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.tp.sum(g.contiguous(), TP_SUM)


class _ReduceFromTP(torch.autograd.Function):
    """The sum of the tp ranks' partial outputs: forward the sum, backward
    the identity (every rank holds the whole cotangent)."""

    @staticmethod
    def forward(ctx, tp, x):
        return tp.sum(x.contiguous(), TP_SUM)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _GatherTP(torch.autograd.Function):
    """A leaf whose blocks lie over ``tp``, joined along ``dim`` for compute;
    backward this rank's block of the cotangent, summed over ``tp`` first
    when the ranks use the joined leaf for different work (``partial``)."""

    @staticmethod
    def forward(ctx, tp, x, dim, partial):
        ctx.tp, ctx.dim, ctx.partial = tp, dim, partial
        return tp.cat(x.contiguous(), dim, TP_GATHER)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.partial:
            g = ctx.tp.sum(g, TP_SUM)
        return None, ctx.tp.block(g, ctx.dim).contiguous(), None, None


def tp_copy(tp, x):
    return x if tp is None or x is None else _CopyToTP.apply(tp, x)


def tp_reduce(tp, x):
    return x if tp is None else _ReduceFromTP.apply(tp, x)


def tp_gather(tp, x, dim: int, partial: bool):
    return _GatherTP.apply(tp, x, dim, partial)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def _draw(sample, generator: torch.Generator, shape, device: torch.device):
    """fp32 draws of ``sample`` from ``generator``, placed on ``device``.

    Drawn on the generator's own device (a CUDA generator for weights on the
    card), so one seed gives one set of weights wherever they land."""
    if device.type == "meta":
        return torch.empty(shape, device=device)
    x = sample(shape, generator=generator, device=generator.device)
    return x.to(device)


def randn(generator: torch.Generator, shape, device: torch.device):
    """Standard normal draws (see :func:`_draw`)."""
    return _draw(torch.randn, generator, shape, device)


def uniform(generator: torch.Generator, shape, device: torch.device):
    """Uniform [0, 1) draws (see :func:`_draw`)."""
    return _draw(torch.rand, generator, shape, device)


def dense_init(generator, din: int, dout: int, dtype, device, scale=1.0):
    std = scale * din ** -0.5
    return (randn(generator, (din, dout), device) * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(d: int, kind: str, dtype, device):
    _check_kind("norm", kind, ("rms", "ln"))
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(p, x, kind: str, eps: float = 1e-6):
    """RMSNorm through the kernel, or LayerNorm with bias in fp32 (plain
    torch, as the reference is plain jnp there); output in x's dtype."""
    _check_kind("norm", kind, ("rms", "ln"))
    if kind == "rms":
        return ops.rmsnorm(x, p["scale"], eps)
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                        p["bias"].float(), eps).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, pos, theta: float):
    """x: [B, S, H, hd]; pos: [S] or [B, S] (int).

    As in the reference, the rotation is computed in fp32 (a bf16 x times
    the fp32 cos/sin promotes) and the result is cast back to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    if pos.dim() == 1:
        ang = pos.float()[:, None] * freq[None, :]               # [S, half]
        ang = ang[None, :, None, :]
    else:
        ang = pos.float()[..., None] * freq                       # [B,S,half]
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (self / cross; train / prefill / decode)
# ---------------------------------------------------------------------------

def attn_init(generator, d: int, a: AttentionConfig, dtype, device, *,
              out_scale=1.0):
    return {
        "wq": dense_init(generator, d, a.n_heads * a.head_dim, dtype, device),
        "wk": dense_init(generator, d, a.n_kv_heads * a.head_dim, dtype, device),
        "wv": dense_init(generator, d, a.n_kv_heads * a.head_dim, dtype, device),
        "wo": dense_init(generator, a.n_heads * a.head_dim, d, dtype, device,
                         out_scale),
    }


def _qkv(p, x, kv_src, a: AttentionConfig):
    B, S, _ = x.shape
    Sk = kv_src.shape[1]
    q = (x @ p["wq"]).reshape(B, S, a.n_heads, a.head_dim)
    k = (kv_src @ p["wk"]).reshape(B, Sk, a.n_kv_heads, a.head_dim)
    v = (kv_src @ p["wv"]).reshape(B, Sk, a.n_kv_heads, a.head_dim)
    return q, k, v


def attn_apply(p, x, a: AttentionConfig, *, memory=None, window=None,
               causal=None, pos=None, kv_len=None, tp=None):
    """Full-sequence attention (train / prefill); window 0/None = unlimited.

    With ``memory`` it is a cross-attention: K and V come from ``memory``
    and take no RoPE.  ``causal`` is a host value (the layer's flag).
    With ``tp`` the weights are this rank's heads (``a`` counts them) and
    the output is summed over ``tp``."""
    x, memory = tp_copy(tp, x), tp_copy(tp, memory)
    B, S, D = x.shape
    kv_src = memory if memory is not None else x
    q, k, v = _qkv(p, x, kv_src, a)
    if a.use_rope and memory is None:
        pq = torch.arange(S, device=x.device) if pos is None else pos
        q = rope(q, pq, a.rope_theta)
        k = rope(k, pq, a.rope_theta)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    eff_causal = a.causal if causal is None else causal
    eff_window = window
    if eff_window is None and a.kind == "swa":
        eff_window = a.window
    out = ops.attention(qt, kt, vt, causal=eff_causal, window=eff_window,
                        kv_len=kv_len)
    out = out.transpose(1, 2).reshape(B, S, a.n_heads * a.head_dim)
    return tp_reduce(tp, out @ p["wo"])


def attn_decode(p, x, cache, a: AttentionConfig, *,
                window: Optional[int] = None, cross: bool = False, tp=None):
    """One-token decode against a ring cache, updated in place.

    x: [B, 1, D]; cache: {"k","v": [B, slots, Hkv, hd], "len": 0-d int32}.
    The new KV pair lands at ``len % slots`` and ``len`` advances by one;
    the reference returns a new cache instead, the port writes the slot in
    place to keep one copy of the cache.  Validity comes from ring distance
    exactly as in the reference, so one code path serves full attention
    (slots >= seq) and SWA rings.  With ``cross`` the cache holds the
    memory's K and V, is never advanced, and is valid below ``len``.
    Plain torch, as the reference is plain jnp here.  Returns (out
    [B, 1, D], cache).  With ``tp`` as in :func:`attn_apply`: the cache
    holds this rank's kv heads.
    """
    x = tp_copy(tp, x)
    B = x.shape[0]
    q = (x @ p["wq"]).reshape(B, 1, a.n_heads, a.head_dim)
    ln = cache["len"]
    slots = cache["k"].shape[1]
    ki = torch.arange(slots, device=x.device)
    if cross:
        if a.use_rope:
            q = rope(q, ln.to(torch.int32).expand(B, 1), a.rope_theta)
        valid = ki < ln
    else:
        k1 = (x @ p["wk"]).reshape(B, 1, a.n_kv_heads, a.head_dim)
        v1 = (x @ p["wv"]).reshape(B, 1, a.n_kv_heads, a.head_dim)
        if a.use_rope:
            posv = ln.to(torch.int32).expand(B, 1)
            q = rope(q, posv, a.rope_theta)
            k1 = rope(k1, posv, a.rope_theta)
        slot = (ln % slots).long().reshape(1)
        cache["k"].index_copy_(1, slot, k1.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v1.to(cache["v"].dtype))
        dist = (slot - ki) % slots         # 0 = newest, 1 = previous, ...
        w_eff = slots if window is None else min(int(window), slots)
        valid = (dist < w_eff) & (dist <= ln)
        ln.add_(1)
    qt = q.transpose(1, 2).float() * a.head_dim ** -0.5
    kt = _expand_kv(cache["k"].transpose(1, 2), a.n_heads).float()
    vt = _expand_kv(cache["v"].transpose(1, 2), a.n_heads).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qt, kt)
    s = torch.where(valid[None, None, None, :], s, torch.full_like(s, NEG_INF))
    pw = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", pw, vt).to(x.dtype)
    out = out.transpose(1, 2).reshape(B, 1, a.n_heads * a.head_dim)
    return tp_reduce(tp, out @ p["wo"]), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

MLP_ACTS = ("silu", "geglu", "gelu")


def mlp_init(generator, d: int, f: int, act: str, dtype, device, *,
             out_scale=1.0):
    """SwiGLU's and GeGLU's three matrices, or GELU's two (``wu``,
    ``wd``)."""
    _check_kind("act", act, MLP_ACTS)
    if act in ("silu", "geglu"):
        return {"wg": dense_init(generator, d, f, dtype, device),
                "wu": dense_init(generator, d, f, dtype, device),
                "wd": dense_init(generator, f, d, dtype, device, out_scale)}
    return {"wu": dense_init(generator, d, f, dtype, device),
            "wd": dense_init(generator, f, d, dtype, device, out_scale)}


def mlp_apply(p, x, act: str, tp=None):
    """SwiGLU, (silu(x wg) * (x wu)) wd; GeGLU (gemma), (gelu(x wg) *
    (x wu)) wd; or gelu(x wu) wd.  GELU takes its tanh approximation
    (``jax.nn.gelu``'s default, which the reference takes).  With ``tp``
    the weights are this rank's columns of ``wg`` / ``wu`` and rows of
    ``wd``, and the output is summed over ``tp``."""
    _check_kind("act", act, MLP_ACTS)
    x = tp_copy(tp, x)
    if act == "silu":
        y = (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    elif act == "geglu":
        y = (F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wu"])) \
            @ p["wd"]
    else:
        y = F.gelu(x @ p["wu"], approximate="tanh") @ p["wd"]
    return tp_reduce(tp, y)


# ---------------------------------------------------------------------------
# MoE (top-k router + capacity dispatch)
# ---------------------------------------------------------------------------

def moe_init(generator, d: int, f: int, m: MoEConfig, dtype, device, *,
             out_scale=1.0):
    """The router [d, E] (fp32 whatever the model dtype, as in the
    reference) and the experts' SwiGLU matrices [E, d, f], [E, f, d]."""
    E, std = m.n_experts, d ** -0.5
    return {
        "router": dense_init(generator, d, E, torch.float32, device),
        "wg": (randn(generator, (E, d, f), device) * std).to(dtype),
        "wu": (randn(generator, (E, d, f), device) * std).to(dtype),
        "wd": (randn(generator, (E, f, d), device) * std * out_scale
               ).to(dtype),
    }


def moe_capacity(g: int, m: MoEConfig) -> int:
    """Slots an expert takes a group of ``g`` tokens: ``g k cf / E`` by
    Python's ``round`` (half to even), at least 1."""
    return int(max(1, round(g * m.top_k * m.capacity_factor / m.n_experts)))


def moe_group(T: int, group_size: int) -> int:
    """Tokens a dispatch group holds: the largest divisor of ``T`` that is
    at most ``group_size``."""
    g = max(1, min(group_size, T))
    while T % g:
        g -= 1
    return g


def moe_apply(p, x, m: MoEConfig, *, group_size: int = 512, tp=None,
              replicas: int = 1):
    """Capacity-factor token dispatch (reference ``layers.moe_apply``).

    The B * S tokens form groups of :func:`moe_group` tokens; in each group
    the fp32 router's softmax picks the top-k experts of a token (ties to
    the lower index, as ``jax.lax.top_k``), their weights renormalised to
    sum 1; an expert takes :func:`moe_capacity` tokens, slot 0 of every
    token first, then slot 1, in token order, and drops the rest.  The
    dispatch and combine are the reference's dense one-hot products
    ([G, g, E, cap]): batched matrix products, so the backward is
    deterministic on the card (no atomic scatter).  Returns (out [B, S, D]
    in x's dtype, router logits [G, g, E] fp32).

    Over ``replicas`` data-parallel replicas the groups are cut from the
    whole micro-batch, ``replicas`` times these tokens (``group_size``
    counts it too), and each must lie whole inside one replica's slice,
    or the capacity drops would differ from the reference's: that
    raises.  With ``tp`` the experts are this rank's block of them
    (``wg`` leads with ``E / tp``), every rank routes the whole group with
    the whole fp32 router, runs its own experts and the combine is summed
    over ``tp``."""
    x = tp_copy(tp, x)
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    g = moe_group(B * S * replicas, group_size)
    if (B * S) % g:
        raise NotImplementedError(
            f"a MoE dispatch group of {g} tokens straddles the "
            f"{replicas} data-parallel replicas' slices of {B * S} tokens: "
            "its capacity drops would differ from the reference's (ROADMAP "
            "A9b); use a sequence the group divides, or data=1")
    G = B * S // g
    xt = x.reshape(G, g, D)
    cap = moe_capacity(g, m)

    logits = xt.float() @ p["router"].float()
    gates = torch.softmax(logits, -1)                           # [G, g, E]
    # a stable descending sort keeps the lower expert first among equals
    idx = torch.sort(gates.detach(), stable=True, dim=-1,
                     descending=True).indices[..., :k]          # [G, g, k]
    vals = torch.gather(gates, -1, idx)
    vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)

    slots = torch.arange(cap, device=x.device)
    combine = torch.zeros((G, g, E, cap), dtype=torch.float32,
                          device=x.device)
    counts = torch.zeros((G, E), dtype=torch.float32, device=x.device)
    for slot in range(k):
        oh = F.one_hot(idx[..., slot], E).float()               # [G, g, E]
        pos_all = oh.cumsum(1) - oh + counts[:, None, :]
        pos = (oh * pos_all).sum(-1)                            # [G, g]
        keep = (pos < cap).float()
        counts = counts + (oh * keep[..., None]).sum(1)
        ohc = (pos.long()[..., None] == slots).float()          # [G, g, cap]
        combine = combine + (vals[..., slot] * keep)[..., None, None] \
            * (oh[..., :, None] * ohc[..., None, :])
    if tp is not None:                 # this rank's experts
        n = p["wg"].shape[0]
        combine = combine[:, :, tp.rank * n:(tp.rank + 1) * n]
    dispatch = (combine > 0).to(x.dtype)                        # [G,g,E,cap]

    ein = torch.einsum("gsec,gsd->gecd", dispatch, xt)
    h = F.silu(torch.einsum("gecd,edf->gecf", ein, p["wg"])) \
        * torch.einsum("gecd,edf->gecf", ein, p["wu"])
    eo = torch.einsum("gecf,efd->gecd", h, p["wd"])
    out = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), eo)
    return tp_reduce(tp, out.reshape(B, S, D)), logits


def moe_aux_loss(logits, m: MoEConfig):
    """Switch-style load-balancing loss: E * sum(mean gate * top-1 share).
    No block calls it, as in the reference."""
    gates = torch.softmax(logits.float(), -1)
    dims = tuple(range(gates.dim() - 1))
    me = gates.mean(dim=dims)
    ce = F.one_hot(gates.argmax(-1), m.n_experts).float().mean(dim=dims)
    return m.n_experts * (me * ce).sum()


# ---------------------------------------------------------------------------
# Selective SSM (Mamba-style head group; hymba's SSM half)
# ---------------------------------------------------------------------------

SSM_CHUNK = 32      # time steps a chunk of the scan combines in closed form


def ssm_heads(d: int, s: SSMConfig) -> int:
    return s.n_heads or d // s.head_dim


def ssm_init(generator, d: int, s: SSMConfig, dtype, device):
    """The reference's tree; ``a_log`` [H, N] and ``dskip`` [H, 1] fp32."""
    H = ssm_heads(d, s)
    return {
        "w_in": dense_init(generator, d, H * s.head_dim, dtype, device),
        "w_bc": dense_init(generator, d, H * 2 * s.state_dim, dtype, device),
        "w_dt": dense_init(generator, d, H, dtype, device),
        "a_log": torch.zeros((H, s.state_dim), dtype=torch.float32,
                             device=device),
        "w_out": dense_init(generator, H * s.head_dim, d, dtype, device),
        "dskip": torch.full((H, 1), 0.1, dtype=torch.float32, device=device),
    }


def _ssm_inputs(p, x, s: SSMConfig):
    """Projections of x [B, S, D]: xh [B, S, H, hd] fp32, B and C [B, S, H,
    N] fp32, dt [B, S, H] fp32 (softplus), in the reference's dtypes."""
    B, S, D = x.shape
    H, hd, N = ssm_heads(D, s), s.head_dim, s.state_dim
    xh = (x @ p["w_in"]).reshape(B, S, H, hd).float()
    bc = (x @ p["w_bc"]).reshape(B, S, H, 2 * N).float()
    dt = F.softplus((x @ p["w_dt"]).float())
    return xh, bc[..., :N], bc[..., N:], dt


def _segsum(x):
    """x [..., T] -> [..., T, T]: sum_{j < k <= i} x[k] at [i, j] where
    i >= j, else 0.  Summed afresh for each j (a masked cumsum), not as a
    difference of two running sums, which would cancel."""
    T = x.shape[-1]
    strict = torch.ones((T, T), dtype=torch.bool, device=x.device).tril(-1)
    return x[..., :, None].expand(*x.shape, T).masked_fill(
        ~strict, 0.0).cumsum(-2)


def ssm_scan(p, x, s: SSMConfig, state0=None):
    """x: [B, S, D] -> (y [B, S, D], state [B, H, hd, N] fp32).

    The recurrence h_t = exp(-dt_t A) h_{t-1} + dt_t x_t B_t^T (A =
    exp(a_log), a decay per head and state entry), y_t = h_t C_t + dskip
    x_t of the reference (whose associative scan this replaces), in fp32
    and in chunks of ``SSM_CHUNK`` steps: inside a chunk the steps combine
    in closed form (the Mamba-2 "SSD" form): the decay from step s to step
    t is exp(-A sum_{s<k<=t} dt_k), and since its log factors into A times
    a sum of dt, the sums are taken over dt alone ([L, L] a chunk and head)
    and only the decays carry the state axis N.  Each chunk's end state,
    and from them every chunk's start state, come the same way over
    chunks, so there is no loop over time.  S need not divide by the
    chunk: the tail is padded with dt = 0 (decay 1, no input).  Memory: a
    few [B, H, S, L, N] fp32 tensors a call, two of them kept for the
    backward (the reference keeps the [B, S, H, hd, N] scan)."""
    B, S, D = x.shape
    H, hd, N = ssm_heads(D, s), s.head_dim, s.state_dim
    xh, Bm, Cm, dt = _ssm_inputs(p, x, s)
    L = SSM_CHUNK
    nc = -(-S // L)
    pad = nc * L - S

    def chunks(t):          # [B, S, H, X] -> [B, H, nc, L, X]
        t = F.pad(t, (0, 0, 0, 0, 0, pad))
        return t.reshape(B, nc, L, H, -1).permute(0, 3, 1, 2, 4)

    neg_a = -torch.exp(p["a_log"])[:, None, None, :]      # [H, 1, 1, N]
    dtc = chunks(dt[..., None])[..., 0]               # [B, H, nc, L]
    xc = chunks(xh)                                   # [B, H, nc, L, hd]
    bdt = chunks(Bm * dt[..., None])                  # [B, H, nc, L, N]
    cc = chunks(Cm)
    tril = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    # inside a chunk: y_t += sum_{s<=t} (sum_n C_t decay(s -> t) B_s dt_s) x_s,
    # the state axis ahead of (t, s) so the sum over it is a sum of rows
    decay = torch.exp(_segsum(dtc)[:, :, :, None]
                      * neg_a[..., 0, :, None, None])  # [B, H, nc, N, L, L]
    pair = cc.transpose(3, 4)[..., :, None] * bdt.transpose(3, 4)[..., None, :]
    mix = (decay * pair).sum(3)
    y = torch.einsum("bhcts,bhcsd->bhctd", mix.masked_fill(~tril, 0.0), xc)
    # each chunk's own contribution to the state at its end
    own = torch.einsum("bhcns,bhcsd->bhcdn",
                       decay[..., -1, :] * bdt.transpose(3, 4), xc)
    # across chunks: the state at each chunk's end, then at its start
    cum = dtc.cumsum(3)
    tot = cum[..., -1]                                # [B, H, nc]
    lower = torch.ones((nc, nc), dtype=torch.bool,
                       device=x.device).tril()[..., None]
    carry = torch.exp(_segsum(tot)[..., None] * neg_a) * lower
    end = torch.einsum("bhcjn,bhjdn->bhcdn", carry, own)
    start = F.pad(end[:, :, :-1], (0, 0, 0, 0, 1, 0))
    last = end[:, :, -1]
    if state0 is not None:
        before = F.pad(tot.cumsum(2), (1, 0))[..., None] * neg_a[:, 0]
        start = start + torch.exp(before[:, :, :-1])[..., None, :] \
            * state0[:, :, None]
        last = last + torch.exp(before[:, :, -1])[..., None, :] * state0
    y = y + torch.einsum("bhctn,bhcdn->bhctd",
                         cc * torch.exp(cum[..., None] * neg_a), start)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, nc * L, H, hd)[:, :S]
    y = y + xh * p["dskip"]
    y = y.reshape(B, S, H * hd).to(x.dtype)
    return y @ p["w_out"], last


def ssm_decode(p, x, state, s: SSMConfig):
    """One step of the recurrence. x: [B, 1, D]; state: [B, H, hd, N]
    fp32.  Returns (y [B, 1, D], the new state)."""
    B = x.shape[0]
    xh, Bm, Cm, dt = _ssm_inputs(p, x, s)
    decay = torch.exp(-dt[..., None] * torch.exp(p["a_log"]))[:, 0]
    inc = (dt[..., None, None] * xh[..., :, None] * Bm[..., None, :])[:, 0]
    state = decay[..., None, :] * state + inc
    y = torch.einsum("bhdn,bhn->bhd", state, Cm[:, 0]) + xh[:, 0] * p["dskip"]
    y = y.reshape(B, 1, -1).to(x.dtype)
    return y @ p["w_out"], state
