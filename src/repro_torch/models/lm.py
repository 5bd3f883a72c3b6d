"""LM assembly: params, stacked stages, embed / head, caches.

Counterpart of :mod:`repro.models.lm` for the dense and ssm families.  Blocks are
stacked ``[n_stages, L_per_stage]`` for the pipeline (identity-padded per
:func:`repro_torch.core.stage.partition_layout`); embed and head run outside
the pipeline.  Parameters are nested dicts of tensors with the reference's
tree layout, so weights move across from JAX leaf for leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ParallelConfig, ShapeConfig
from repro_torch.core import stage as stage_lib
from repro_torch.core.pipeline import TickCtx
from repro_torch.devices import DeviceLike, resolve_device, stage_devices
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.tree import tree_map


def _embed_lookup(table, tokens, dtype):
    """Token-embedding gather through fp32, cast to ``dtype``.

    The reference upcasts the table before its gather (a workaround for an
    XLA CPU pass); gathering the rows and then upcasting gives the same
    values without an fp32 copy of the whole table on every call."""
    rows = table.index_select(0, tokens.reshape(-1)).float()
    return rows.reshape(tuple(tokens.shape) + (table.shape[1],)).to(dtype)


@dataclass
class LMModel:
    arch: ArchConfig
    pcfg: ParallelConfig
    dtype: torch.dtype = torch.bfloat16
    device: DeviceLike = "cuda"

    def __post_init__(self):
        a = self.arch
        B.check_ported(a)
        self.device = resolve_device(self.device)
        self.total_layers = a.n_layers + a.enc_layers
        self.n_stages = self.pcfg.pipe * self.pcfg.virtual_stages
        self.layout = stage_lib.partition_layout(
            self.total_layers, self.n_stages, self.pcfg.partition or None)
        self.L_per_stage = self.layout.L_per_stage
        self.layer_mask = self.layout.mask          # np [n_stages, L]
        (self.block_init, self.block_apply, self.block_decode,
         self.block_cache_proto, self.block_prefill) = B.FAMILIES[a.family]

    @property
    def stage_devices(self) -> List[torch.device]:
        """One device per stage (torchgpipe placement); all this model's."""
        return stage_devices(self.device, self.n_stages)

    # ------------------------------------------------------------------ params
    def init(self, generator: torch.Generator):
        """Random weights at the reference's scales, drawn from ``generator``."""
        a, dev = self.arch, self.device
        layer_ps = [self.block_init(generator, a, self.dtype, dev)
                    for _ in range(self.total_layers)]
        stages = stage_lib.stack_layer_params(layer_ps, self.n_stages,
                                              self.pcfg.partition or None)
        del layer_ps
        emb = {"tok": (L.randn(generator, (a.vocab, a.d_model), dev)
                       * a.d_model ** -0.5).to(self.dtype)}
        head = {"norm": L.norm_init(a.d_model, a.norm, self.dtype, dev)}
        if not a.tie_embeddings:
            head["w"] = (L.randn(generator, (a.d_model, a.vocab), dev)
                         * a.d_model ** -0.5).to(self.dtype)
        return {"embed": emb, "stages": stages, "head": head}

    # ------------------------------------------------------------ layer consts
    def consts(self) -> Dict[str, np.ndarray]:
        """Per-layer constants on the [n_stages, L_per_stage] slot grid.

        Host arrays: the port reads one scalar per layer.  Padding slots
        take the identity defaults (mask 0)."""
        a = self.arch
        window = np.zeros(self.total_layers, np.int32)
        if a.attn is not None and a.attn.kind == "swa":
            window[:] = a.attn.window
        sc = self.layout.scatter
        return {"mask": np.asarray(self.layer_mask, np.float32),
                "window": sc(window, 0)}

    def _layer_consts(self, consts, stage: int, slot: int) -> Dict[str, Any]:
        return {k: v[stage, slot].item() for k, v in consts.items()}

    # ------------------------------------------------------------------ embed
    def embed_inputs(self, emb, batch) -> Dict[str, torch.Tensor]:
        """batch -> fresh stage-0 input tree [B, ...]."""
        return {"h": _embed_lookup(emb["tok"], batch["tokens"], self.dtype)}

    def embed_decode(self, emb, tokens, pos):
        """Embed one decode token.  RoPE archs and the ssm family add no
        positions here, so ``pos`` matters only to the non-RoPE attention
        archs, whose sinusoidal positions are not ported yet."""
        a = self.arch
        if a.family != "ssm" and not (a.attn and a.attn.use_rope):
            raise NotImplementedError("sinusoidal positions (non-RoPE archs) "
                                      "are not ported yet: ROADMAP A6")
        return _embed_lookup(emb["tok"], tokens, self.dtype)

    # ------------------------------------------ stage fn (forward / prefill)
    def make_stage_apply(self, consts, *, prefill: bool = False):
        """stage_apply for the pipeline runner (forward, or prefill + caches).

        Prefill writes each layer's cache slice for ``ctx.micro`` in place
        (the reference returns an updated copy)."""
        model, a = self, self.arch

        def stage_apply(stage_params, carry, skips_in, resident,
                        ctx: TickCtx):
            h = ctx.fresh["h"] if ctx.stage == 0 else carry["h"]
            for l in range(model.L_per_stage):
                lp = tree_map(lambda x: x[l], stage_params)
                c = model._layer_consts(consts, ctx.stage, l)
                if prefill:
                    cache = tree_map(lambda x: x[l, ctx.micro], resident)
                    h, _ = model.block_prefill(lp, h, c, a, cache)
                else:
                    h = model.block_apply(lp, h, c, a)
            return {"h": h}, {}, resident

        return stage_apply

    # ------------------------------------------------------ stage fn (decode)
    def make_stage_apply_decode(self, consts):
        model, a = self, self.arch

        def stage_apply(stage_params, carry, skips_in, resident,
                        ctx: TickCtx):
            h = ctx.fresh["h"] if ctx.stage == 0 else carry["h"]   # [mb, 1, D]
            for l in range(model.L_per_stage):
                lp = tree_map(lambda x: x[l], stage_params)
                c = model._layer_consts(consts, ctx.stage, l)
                cache = tree_map(lambda x: x[l, ctx.micro], resident)
                h, _ = model.block_decode(lp, h, c, a, cache)
            return {"h": h}, {}, resident

        return stage_apply

    # ------------------------------------------------------------------- head
    def head_logits(self, params, h):
        hn = L.norm_apply(params["head"]["norm"], h, self.arch.norm)
        w = params["head"].get("w")
        if w is None:
            w = params["embed"]["tok"].T       # tied embeddings
        return hn @ w

    # ----------------------------------------------------------------- caches
    def cache_protos(self, shape: ShapeConfig, n_micro: int):
        """Stacked resident cache leaves as ``(shape, dtype)``:
        ``[n_stages, L_per_stage, m, mb, ...]``."""
        mb = shape.global_batch // n_micro
        slots_len = shape.seq_len + 64
        per_layer = self.block_cache_proto(self.arch, mb, slots_len, self.dtype)

        def stack(p):
            shp, dt = p
            return ((self.n_stages, self.L_per_stage, n_micro) + tuple(shp), dt)
        return _map_protos(stack, per_layer)

    def init_cache(self, shape: ShapeConfig, n_micro: int, *, filled: bool):
        """Zero caches on this model's device; ``filled`` marks them as
        already holding ``seq_len`` tokens."""
        def mk(p):
            shp, dt = p
            z = torch.zeros(shp, dtype=dt, device=self.device)
            if filled and dt == torch.int32 and len(shp) == 3:
                z.fill_(shape.seq_len)
            return z
        return _map_protos(mk, self.cache_protos(shape, n_micro))


def _map_protos(fn, protos):
    """Map over a tree whose leaves are ``(shape, dtype)`` pairs."""
    if isinstance(protos, dict):
        return {k: _map_protos(fn, v) for k, v in protos.items()}
    return fn(protos)
