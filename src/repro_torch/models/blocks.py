"""Transformer blocks: the ``dense`` family (counterpart of ``repro.models.blocks``).

A family exposes init / apply / decode / cache_proto / prefill so the LM
assembly and the pipeline stage program stay family-agnostic.  ``consts``
is the per-layer constant record (identity mask, window, ...) as host
scalars.  The other families (moe, ssm, hybrid, encdec, vlm) are later
slices of the port (ROADMAP A6 and A8).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L


def _res(h, mask, delta):
    """Residual add gated by the identity-padding mask (dtype-preserving)."""
    return h + (delta.float() * mask).to(h.dtype)


def _window_arg(arch: ArchConfig, consts):
    """Static int window for uniform layouts (mixed layouts: ROADMAP A8)."""
    a = arch.attn
    if a is None:
        return None
    if a.global_layers:
        raise NotImplementedError("per-layer attention windows (hymba) are "
                                  "not ported yet: ROADMAP A8")
    return int(a.window) if a.kind == "swa" else None


def check_ported(arch: ArchConfig):
    """Raise for an architecture this slice of the port cannot run."""
    if arch.family not in FAMILIES:
        raise NotImplementedError(
            f"{arch.name}: the {arch.family!r} family is not ported yet "
            "(ROADMAP A6 / A8); the port runs the dense family")
    if arch.frontend != "none" or arch.name.startswith("gemma"):
        raise NotImplementedError(
            f"{arch.name}: frontend stubs and gemma's embedding scale are "
            "not ported yet (ROADMAP A8)")


# ---------------------------------------------------------------------------
# Dense (smollm / llama3 / deepseek)
# ---------------------------------------------------------------------------

def dense_init(generator, arch: ArchConfig, dtype, device):
    out_scale = (2 * (arch.n_layers + arch.enc_layers)) ** -0.5
    return {
        "ln1": L.norm_init(arch.d_model, arch.norm, dtype, device),
        "attn": L.attn_init(generator, arch.d_model, arch.attn, dtype, device,
                            out_scale=out_scale),
        "ln2": L.norm_init(arch.d_model, arch.norm, dtype, device),
        "mlp": L.mlp_init(generator, arch.d_model, arch.d_ff, arch.act, dtype,
                          device, out_scale=out_scale),
    }


def dense_apply(p, h, consts, arch: ArchConfig):
    a = arch.attn
    mask = consts["mask"]
    win = _window_arg(arch, consts)
    attn = L.attn_apply(p["attn"], L.norm_apply(p["ln1"], h, arch.norm), a,
                        window=win)
    h = _res(h, mask, attn)
    mlp = L.mlp_apply(p["mlp"], L.norm_apply(p["ln2"], h, arch.norm), arch.act)
    return _res(h, mask, mlp)


def dense_decode(p, h, consts, arch: ArchConfig, cache):
    a = arch.attn
    mask = consts["mask"]
    win = _window_arg(arch, consts)
    attn, cache["self"] = L.attn_decode(
        p["attn"], L.norm_apply(p["ln1"], h, arch.norm), cache["self"], a,
        window=win)
    h = _res(h, mask, attn)
    mlp = L.mlp_apply(p["mlp"], L.norm_apply(p["ln2"], h, arch.norm), arch.act)
    return _res(h, mask, mlp), cache


def dense_cache_proto(arch: ArchConfig, batch: int, max_len: int, dtype
                      ) -> Dict[str, Any]:
    """Per-layer cache leaves as ``(shape, dtype)`` pairs."""
    a = arch.attn
    slots = min(max_len, a.window) if a.kind == "swa" else max_len
    kv = ((batch, slots, a.n_kv_heads, a.head_dim), dtype)
    return {"self": {"k": kv, "v": kv, "len": ((), torch.int32)}}


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


def _fill_self_cache(p, h_normed, a, cache):
    """Write the prompt's K/V into the ring cache in place; len := S."""
    B, S, _ = h_normed.shape
    k = (h_normed @ p["wk"]).reshape(B, S, a.n_kv_heads, a.head_dim)
    v = (h_normed @ p["wv"]).reshape(B, S, a.n_kv_heads, a.head_dim)
    if a.use_rope:
        k = L.rope(k, torch.arange(S, device=h_normed.device), a.rope_theta)
    slots = cache["k"].shape[1]
    for name, val in (("k", k), ("v", v)):
        ring, n = _ring_fill(val, slots)
        cache[name][:, :n].copy_(ring)
        cache[name][:, n:].zero_()
    cache["len"].fill_(S)
    return cache


def dense_prefill(p, h, consts, arch: ArchConfig, cache
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    hn = L.norm_apply(p["ln1"], h, arch.norm)
    cache["self"] = _fill_self_cache(p["attn"], hn, arch.attn, cache["self"])
    return dense_apply(p, h, consts, arch), cache


FAMILIES = {
    "dense": (dense_init, dense_apply, dense_decode, dense_cache_proto,
              dense_prefill),
}
