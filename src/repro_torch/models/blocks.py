"""Blocks of every family of the reference: ``dense`` (and ``vlm``,
``encdec``), ``moe``, ``ssm`` (RWKV-6) and ``hybrid`` (counterpart of
``repro.models.blocks``).

A family exposes init / apply / decode / cache_proto / prefill so the LM
assembly and the pipeline stage program stay family-agnostic.  ``consts``
is the per-layer constant record (identity mask, window, causal and cross
flags) as host scalars.  Prefill and decode write each layer's cache in
place: the stage program hands them views into the resident caches and
drops what they return.  The encoder-decoder (whisper) shares the dense
functions, as in the reference: a layer with ``cross`` set also attends to
the encoder ``memory``; so does the vlm (pixtral), whose vision stub is
the embedding's (``LMModel.embed_inputs``).  Every layer reads its
window from ``consts`` as a host int (:func:`layer_windows`'s rule),
where the reference traces it for an arch with per-layer windows.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


GLOBAL_WINDOW = 32768
"""The window of a hybrid arch's 'global' attention layers (the
reference's ``blocks.GLOBAL_WINDOW``): per-stage caches are stacked, so
every layer's ring takes one shape and the global layers share the SWA
ring layout with this larger window.  Exact up to 32k positions."""


def _res(h, mask, delta):
    """Residual add gated by the identity-padding mask (dtype-preserving)."""
    return h + (delta.float() * mask).to(h.dtype)


def layer_windows(arch: ArchConfig, n_layers: int) -> np.ndarray:
    """Each layer's attention window (0 = unlimited), the reference's rule
    (``LMModel.consts``): the arch's window on every layer of an SWA or
    mixed layout, ``GLOBAL_WINDOW`` on a mixed layout's ``global_layers``."""
    window = np.zeros(n_layers, np.int32)
    a = arch.attn
    if a is not None and (a.kind == "swa" or a.global_layers):
        window[:] = a.window
        for g in a.global_layers:
            if g < n_layers:
                window[g] = GLOBAL_WINDOW
    return window


def _window_arg(consts):
    """The layer's window as a host int, None where unlimited (0): the
    ``consts["window"]`` that :func:`layer_windows` gave the layer."""
    return int(consts["window"]) or None


def _tp(consts, part: str):
    """The ``tp`` axis ``part`` (``attn``, ``mlp``, ``moe``) splits over
    (``consts["mesh"]``, a :class:`layers.LayerMesh`), or None."""
    lm = consts.get("mesh")
    return None if lm is None else getattr(lm, part)


def _replicas(consts) -> int:
    lm = consts.get("mesh")
    return 1 if lm is None else lm.replicas


# ---------------------------------------------------------------------------
# Dense (smollm / gemma / llama3 / deepseek / pixtral) and enc-dec (whisper)
# ---------------------------------------------------------------------------

def dense_init(generator, arch: ArchConfig, dtype, device):
    out_scale = (2 * (arch.n_layers + arch.enc_layers)) ** -0.5
    p = {
        "ln1": L.norm_init(arch.d_model, arch.norm, dtype, device),
        "attn": L.attn_init(generator, arch.d_model, arch.attn, dtype, device,
                            out_scale=out_scale),
        "ln2": L.norm_init(arch.d_model, arch.norm, dtype, device),
        "mlp": L.mlp_init(generator, arch.d_model, arch.d_ff, arch.act, dtype,
                          device, out_scale=out_scale),
    }
    if arch.is_encdec:
        p["lnx"] = L.norm_init(arch.d_model, arch.norm, dtype, device)
        p["xattn"] = L.attn_init(generator, arch.d_model, arch.attn, dtype,
                                 device, out_scale=out_scale)
    return p


def _cross(consts, memory) -> bool:
    """Whether this layer runs its cross-attention.  The reference runs it
    on every enc-dec layer and gates the residual by ``cross``; on an
    encoder layer (``cross`` 0) that adds exact zeros, so it is skipped."""
    if not consts.get("cross"):
        return False
    if memory is None:
        raise RuntimeError("a cross-attention layer got no encoder memory")
    return True


def dense_apply(p, h, consts, arch: ArchConfig, memory=None):
    a = arch.attn
    mask = consts["mask"]
    causal = consts["causal"] if arch.is_encdec else None
    win = _window_arg(consts)
    attn = L.attn_apply(p["attn"], L.norm_apply(p["ln1"], h, arch.norm), a,
                        window=win, causal=causal, tp=_tp(consts, "attn"))
    h = _res(h, mask, attn)
    if arch.is_encdec and _cross(consts, memory):
        x = L.attn_apply(p["xattn"], L.norm_apply(p["lnx"], h, arch.norm), a,
                         memory=memory, causal=0, tp=_tp(consts, "attn"))
        h = _res(h, mask * consts["cross"], x)
    mlp = L.mlp_apply(p["mlp"], L.norm_apply(p["ln2"], h, arch.norm), arch.act,
                      tp=_tp(consts, "mlp"))
    return _res(h, mask, mlp)


def dense_decode(p, h, consts, arch: ArchConfig, cache):
    a = arch.attn
    mask = consts["mask"]
    win = _window_arg(consts)
    attn, cache["self"] = L.attn_decode(
        p["attn"], L.norm_apply(p["ln1"], h, arch.norm), cache["self"], a,
        window=win, tp=_tp(consts, "attn"))
    h = _res(h, mask, attn)
    if arch.is_encdec and consts.get("cross"):
        x, _ = L.attn_decode(p["xattn"], L.norm_apply(p["lnx"], h, arch.norm),
                             cache["cross"], a, cross=True,
                             tp=_tp(consts, "attn"))
        h = _res(h, mask * consts["cross"], x)
    mlp = L.mlp_apply(p["mlp"], L.norm_apply(p["ln2"], h, arch.norm), arch.act,
                      tp=_tp(consts, "mlp"))
    return _res(h, mask, mlp), cache


def dense_cache_proto(arch: ArchConfig, batch: int, max_len: int, dtype
                      ) -> Dict[str, Any]:
    """Per-layer cache leaves as ``(shape, dtype)`` pairs; an enc-dec layer
    also holds the memory's K and V (``cross``, ``enc_len`` or ``max_len``
    slots)."""
    a = arch.attn
    slots = min(max_len, a.window) if a.kind == "swa" else max_len
    kv = ((batch, slots, a.n_kv_heads, a.head_dim), dtype)
    c = {"self": {"k": kv, "v": kv, "len": ((), torch.int32)}}
    if arch.is_encdec:
        xkv = ((batch, arch.enc_len or max_len, a.n_kv_heads, a.head_dim),
               dtype)
        c["cross"] = {"k": xkv, "v": xkv, "len": ((), torch.int32)}
    return c


# ---------------------------------------------------------------------------
# Prefill: full-sequence forward + cache population
# ---------------------------------------------------------------------------

def _ring_fill(seq_kv, slots: int):
    """Place the last min(S, slots) positions of [B, S, H, hd] into ring
    order: ring[s] holds position p ≡ s (mod slots), the largest such p < S."""
    S = seq_kv.shape[1]
    if S <= slots:
        return seq_kv, S
    s = torch.arange(slots, device=seq_kv.device)
    p = s + ((S - 1 - s) // slots) * slots
    return seq_kv.index_select(1, p), slots


def _fill_kv(cache, k, v):
    """Write [B, S, Hkv, hd] K and V into a cache's ring in place; len := S."""
    slots = cache["k"].shape[1]
    for name, val in (("k", k), ("v", v)):
        ring, n = _ring_fill(val, slots)
        cache[name][:, :n].copy_(ring)
        cache[name][:, n:].zero_()
    cache["len"].fill_(k.shape[1])
    return cache


def _fill_self_cache(p, h_normed, a, cache):
    """Write the prompt's K/V into the ring cache in place; len := S."""
    B, S, _ = h_normed.shape
    k = (h_normed @ p["wk"]).reshape(B, S, a.n_kv_heads, a.head_dim)
    v = (h_normed @ p["wv"]).reshape(B, S, a.n_kv_heads, a.head_dim)
    if a.use_rope:
        k = L.rope(k, torch.arange(S, device=h_normed.device), a.rope_theta)
    return _fill_kv(cache, k, v)


def dense_prefill(p, h, consts, arch: ArchConfig, cache, memory=None
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The layer's forward, its self cache filled from the prompt and, on a
    cross-attention layer, its cross cache from ``memory`` (an encoder
    layer's stays empty: decode never runs it)."""
    hn = L.norm_apply(p["ln1"], h, arch.norm)
    cache["self"] = _fill_self_cache(p["attn"], hn, arch.attn, cache["self"])
    h2 = dense_apply(p, h, consts, arch, memory=memory)
    if arch.is_encdec and _cross(consts, memory):
        a = arch.attn
        Bm, Sm, _ = memory.shape
        mk = (memory @ p["xattn"]["wk"]).reshape(Bm, Sm, a.n_kv_heads,
                                                 a.head_dim)
        mv = (memory @ p["xattn"]["wv"]).reshape(Bm, Sm, a.n_kv_heads,
                                                 a.head_dim)
        cache["cross"] = _fill_kv(cache["cross"], mk, mv)
    return h2, cache


# ---------------------------------------------------------------------------
# MoE (mixtral / dbrx): dense attention + routed experts
# ---------------------------------------------------------------------------

def moe_init(generator, arch: ArchConfig, dtype, device):
    out_scale = (2 * arch.n_layers) ** -0.5
    return {
        "ln1": L.norm_init(arch.d_model, arch.norm, dtype, device),
        "attn": L.attn_init(generator, arch.d_model, arch.attn, dtype, device,
                            out_scale=out_scale),
        "ln2": L.norm_init(arch.d_model, arch.norm, dtype, device),
        "moe": L.moe_init(generator, arch.d_model, arch.d_ff, arch.moe, dtype,
                          device, out_scale=out_scale),
    }


def moe_apply(p, h, consts, arch: ArchConfig, memory=None):
    mask = consts["mask"]
    attn = L.attn_apply(p["attn"], L.norm_apply(p["ln1"], h, arch.norm),
                        arch.attn, window=_window_arg(consts),
                        tp=_tp(consts, "attn"))
    h = _res(h, mask, attn)
    out, _ = L.moe_apply(p["moe"], L.norm_apply(p["ln2"], h, arch.norm),
                         arch.moe, tp=_tp(consts, "moe"),
                         replicas=_replicas(consts))
    return _res(h, mask, out)


def moe_decode(p, h, consts, arch: ArchConfig, cache):
    """One token; the experts' groups are the whole micro-batch (B * 1
    tokens), as in the reference."""
    mask = consts["mask"]
    attn, cache["self"] = L.attn_decode(
        p["attn"], L.norm_apply(p["ln1"], h, arch.norm), cache["self"],
        arch.attn, window=_window_arg(consts), tp=_tp(consts, "attn"))
    h = _res(h, mask, attn)
    n = _replicas(consts)
    out, _ = L.moe_apply(p["moe"], L.norm_apply(p["ln2"], h, arch.norm),
                         arch.moe, group_size=h.shape[0] * h.shape[1] * n,
                         tp=_tp(consts, "moe"), replicas=n)
    return _res(h, mask, out), cache


def moe_prefill(p, h, consts, arch: ArchConfig, cache, memory=None):
    hn = L.norm_apply(p["ln1"], h, arch.norm)
    cache["self"] = _fill_self_cache(p["attn"], hn, arch.attn, cache["self"])
    return moe_apply(p, h, consts, arch), cache


moe_cache_proto = dense_cache_proto


# ---------------------------------------------------------------------------
# RWKV-6 (Finch)
# ---------------------------------------------------------------------------

RWKV_HEAD = 64
RWKV_LORA = 64


def rwkv_init(generator, arch: ArchConfig, dtype, device):
    """The reference's tree; ``tm/w_base`` and ``tm/u`` stay fp32."""
    d, f = arch.d_model, arch.d_ff
    H = d // RWKV_HEAD
    out_scale = (2 * arch.n_layers) ** -0.5

    def dense(din, dout, scale=1.0):
        return L.dense_init(generator, din, dout, dtype, device, scale)

    return {
        "ln1": L.norm_init(d, arch.norm, dtype, device),
        "tm": {
            "mu": (L.uniform(generator, (5, d), device) * 0.5).to(dtype),
            "wr": dense(d, d),
            "wk": dense(d, d),
            "wv": dense(d, d),
            "wg": dense(d, d),
            "w_base": torch.zeros((d,), dtype=torch.float32, device=device),
            "ww1": dense(d, RWKV_LORA),
            "ww2": dense(RWKV_LORA, d, 0.1),
            "u": L.randn(generator, (H, RWKV_HEAD), device) * 0.1,
            "gn_scale": torch.ones((d,), dtype=dtype, device=device),
            "wo": dense(d, d, out_scale),
        },
        "ln2": L.norm_init(d, arch.norm, dtype, device),
        "cm": {
            "mu": (L.uniform(generator, (2, d), device) * 0.5).to(dtype),
            "wk": dense(d, f),
            "wv": dense(f, d, out_scale),
            "wr": dense(d, d),
        },
    }


def _token_shift(x, last=None):
    """Previous-token features: shift right by one along S."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _rwkv_time_mix(tm, x, state0=None, last=None):
    """Returns (out [B, S, D], state_T fp32, x's last row)."""
    B, S, D = x.shape
    H = D // RWKV_HEAD
    xs = _token_shift(x, last)
    mu = tm["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + mu[i] * (xs - x) for i in range(5))

    def heads(y):                       # [B, S, D] -> [B, H, S, hd] (a view)
        return y.reshape(B, S, H, RWKV_HEAD).transpose(1, 2)

    r, k, v = heads(xr @ tm["wr"]), heads(xk @ tm["wk"]), heads(xv @ tm["wv"])
    g = F.silu(xg @ tm["wg"])
    wlog = tm["w_base"] + torch.tanh(xw @ tm["ww1"]) @ tm["ww2"]
    w = heads(torch.exp(-torch.exp(wlog.float())))
    out, state = ops.wkv6(r, k, v, w, tm["u"], state0)
    out = out.transpose(1, 2).reshape(B, S, D)
    out = ops.rmsnorm(out.to(x.dtype), tm["gn_scale"])
    return (out * g.to(out.dtype)) @ tm["wo"], state, x[:, -1:]


def _rwkv_channel_mix(cm, x, last=None):
    xs = _token_shift(x, last)
    mu = cm["mu"].to(x.dtype)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    k = torch.square(torch.relu(xk @ cm["wk"]))
    return torch.sigmoid(xr @ cm["wr"]) * (k @ cm["wv"]), x[:, -1:]


def rwkv_apply(p, h, consts, arch: ArchConfig, memory=None):
    mask = consts["mask"]
    tmix, _, _ = _rwkv_time_mix(p["tm"], L.norm_apply(p["ln1"], h, arch.norm))
    h = _res(h, mask, tmix)
    cmix, _ = _rwkv_channel_mix(p["cm"], L.norm_apply(p["ln2"], h, arch.norm))
    return _res(h, mask, cmix)


def _rwkv_step(p, h, consts, arch: ArchConfig, cache, *, carried: bool):
    """One block over h, from the cached state (``carried``) or from zero;
    the new state and the last normed rows are copied into ``cache``."""
    mask = consts["mask"]
    x1 = L.norm_apply(p["ln1"], h, arch.norm)
    tmix, state, last = _rwkv_time_mix(
        p["tm"], x1, state0=cache["state"] if carried else None,
        last=cache["last_tm"] if carried else None)
    cache["state"].copy_(state)
    cache["last_tm"].copy_(last)
    h = _res(h, mask, tmix)
    x2 = L.norm_apply(p["ln2"], h, arch.norm)
    cmix, last2 = _rwkv_channel_mix(
        p["cm"], x2, last=cache["last_cm"] if carried else None)
    cache["last_cm"].copy_(last2)
    return _res(h, mask, cmix), cache


def rwkv_decode(p, h, consts, arch: ArchConfig, cache):
    return _rwkv_step(p, h, consts, arch, cache, carried=True)


def rwkv_prefill(p, h, consts, arch: ArchConfig, cache, memory=None):
    return _rwkv_step(p, h, consts, arch, cache, carried=False)


def rwkv_cache_proto(arch: ArchConfig, batch: int, max_len: int, dtype
                     ) -> Dict[str, Any]:
    d = arch.d_model
    H = d // RWKV_HEAD
    return {"state": ((batch, H, RWKV_HEAD, RWKV_HEAD), torch.float32),
            "last_tm": ((batch, 1, d), dtype),
            "last_cm": ((batch, 1, d), dtype)}


# ---------------------------------------------------------------------------
# Hybrid (hymba): parallel attention + SSM heads, then MLP
# ---------------------------------------------------------------------------

def hybrid_init(generator, arch: ArchConfig, dtype, device):
    out_scale = (2 * arch.n_layers) ** -0.5
    return {
        "ln1": L.norm_init(arch.d_model, arch.norm, dtype, device),
        "attn": L.attn_init(generator, arch.d_model, arch.attn, dtype, device,
                            out_scale=out_scale),
        "ssm": L.ssm_init(generator, arch.d_model, arch.ssm, dtype, device),
        "ln2": L.norm_init(arch.d_model, arch.norm, dtype, device),
        "mlp": L.mlp_init(generator, arch.d_model, arch.d_ff, arch.act, dtype,
                          device, out_scale=out_scale),
    }


def _hybrid_mix(p, h, mask, attn, ssm, arch: ArchConfig):
    """The mean of the attention and SSM halves as the residual, then the
    MLP."""
    h = _res(h, mask, 0.5 * (attn.float() + ssm.float()))
    mlp = L.mlp_apply(p["mlp"], L.norm_apply(p["ln2"], h, arch.norm), arch.act)
    return _res(h, mask, mlp)


def hybrid_apply(p, h, consts, arch: ArchConfig, memory=None):
    x = L.norm_apply(p["ln1"], h, arch.norm)
    attn = L.attn_apply(p["attn"], x, arch.attn,
                        window=_window_arg(consts))
    ssm, _ = L.ssm_scan(p["ssm"], x, arch.ssm)
    return _hybrid_mix(p, h, consts["mask"], attn, ssm, arch)


def hybrid_decode(p, h, consts, arch: ArchConfig, cache):
    x = L.norm_apply(p["ln1"], h, arch.norm)
    attn, cache["self"] = L.attn_decode(p["attn"], x, cache["self"],
                                        arch.attn,
                                        window=_window_arg(consts))
    ssm, state = L.ssm_decode(p["ssm"], x, cache["state"], arch.ssm)
    cache["state"].copy_(state)
    return _hybrid_mix(p, h, consts["mask"], attn, ssm, arch), cache


def hybrid_prefill(p, h, consts, arch: ArchConfig, cache, memory=None):
    x = L.norm_apply(p["ln1"], h, arch.norm)
    cache["self"] = _fill_self_cache(p["attn"], x, arch.attn, cache["self"])
    attn = L.attn_apply(p["attn"], x, arch.attn,
                        window=_window_arg(consts))
    ssm, state = L.ssm_scan(p["ssm"], x, arch.ssm)
    cache["state"].copy_(state)
    return _hybrid_mix(p, h, consts["mask"], attn, ssm, arch), cache


def hybrid_cache_proto(arch: ArchConfig, batch: int, max_len: int, dtype
                       ) -> Dict[str, Any]:
    """A ring of min(max_len, the largest window) slots (GLOBAL_WINDOW where
    the arch has global layers) and the SSM state [batch, H, hd, N] fp32."""
    a, s = arch.attn, arch.ssm
    slots = min(max_len, max(a.window, GLOBAL_WINDOW) if a.global_layers
                else (a.window or max_len))
    kv = ((batch, slots, a.n_kv_heads, a.head_dim), dtype)
    return {"self": {"k": kv, "v": kv, "len": ((), torch.int32)},
            "state": ((batch, L.ssm_heads(arch.d_model, s), s.head_dim,
                       s.state_dim), torch.float32)}


FAMILIES = {
    "dense": (dense_init, dense_apply, dense_decode, dense_cache_proto,
              dense_prefill),
    "encdec": (dense_init, dense_apply, dense_decode, dense_cache_proto,
               dense_prefill),
    "vlm": (dense_init, dense_apply, dense_decode, dense_cache_proto,
            dense_prefill),
    "moe": (moe_init, moe_apply, moe_decode, moe_cache_proto, moe_prefill),
    "ssm": (rwkv_init, rwkv_apply, rwkv_decode, rwkv_cache_proto,
            rwkv_prefill),
    "hybrid": (hybrid_init, hybrid_apply, hybrid_decode, hybrid_cache_proto,
               hybrid_prefill),
}
