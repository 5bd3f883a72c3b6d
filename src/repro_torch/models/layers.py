"""Model primitives: norms, RoPE, attention (self and cross), MLP.

Counterpart of :mod:`repro.models.layers` (the dense, enc-dec and ssm
subset).  Per-layer constants (identity-pad mask, window, causal flag) are
host values here: the port runs each layer eagerly, so what the reference
keeps as traced data is a Python scalar.  The reference's sharding
constraints have no counterpart on one card and are left out.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, _expand_kv


def _check_kind(what: str, got: str, ported: tuple) -> None:
    if got not in ported:
        raise NotImplementedError(
            f"{what}={got!r} is not ported (only {ported}): no arch of "
            "the reference uses it")


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
               causal=None, pos=None, kv_len=None):
    """Full-sequence attention (train / prefill); window 0/None = unlimited.

    With ``memory`` it is a cross-attention: K and V come from ``memory``
    and take no RoPE.  ``causal`` is a host value (the layer's flag)."""
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
    return out @ p["wo"]


def attn_decode(p, x, cache, a: AttentionConfig, *,
                window: Optional[int] = None, cross: bool = False):
    """One-token decode against a ring cache, updated in place.

    x: [B, 1, D]; cache: {"k","v": [B, slots, Hkv, hd], "len": 0-d int32}.
    The new KV pair lands at ``len % slots`` and ``len`` advances by one;
    the reference returns a new cache instead, the port writes the slot in
    place to keep one copy of the cache.  Validity comes from ring distance
    exactly as in the reference, so one code path serves full attention
    (slots >= seq) and SWA rings.  With ``cross`` the cache holds the
    memory's K and V, is never advanced, and is valid below ``len``.
    Plain torch, as the reference is plain jnp here.  Returns (out
    [B, 1, D], cache).
    """
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
    return out @ p["wo"], cache


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


def mlp_apply(p, x, act: str):
    """SwiGLU, (silu(x wg) * (x wu)) wd; GeGLU (gemma), (gelu(x wg) *
    (x wu)) wd; or gelu(x wu) wd.  GELU takes its tanh approximation
    (``jax.nn.gelu``'s default, which the reference takes)."""
    _check_kind("act", act, MLP_ACTS)
    if act == "silu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    if act == "geglu":
        return (F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wu"])) \
            @ p["wd"]
    return F.gelu(x @ p["wu"], approximate="tanh") @ p["wd"]
