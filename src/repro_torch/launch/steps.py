"""Step functions: prefill / serve through the GPipe forward pipeline.

Counterpart of :mod:`repro.launch.steps` (``build_prefill_step``,
``build_serve_step``).  Where the reference takes a mesh, the port takes the
stage placement: one device per stage, or one device for all of them.
Training (``build_train_step``) is the next slice (ROADMAP A2).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.core.pipeline import (last_stage_output, microbatch,
                                       pipeline_call, unmicrobatch)
from repro_torch.models.lm import LMModel


def build_prefill_step(model: LMModel, pcfg: ParallelConfig, devices: Any,
                       shape: ShapeConfig, *,
                       park_info: Optional[Dict[str, Any]] = None):
    """prefill_step(params, cache, batch) -> (last_token_logits, cache).

    ``cache`` (from ``model.init_cache``) is filled in place and returned."""
    consts = model.consts()
    stage_apply = model.make_stage_apply(consts, prefill=True)
    pipe = pipeline_call(stage_apply, cfg=pcfg, devices=devices,
                         park_info=park_info)

    def prefill_step(params, cache, batch):
        with torch.inference_mode():
            fresh = model.embed_inputs(params["embed"], batch)
            inputs_mb = microbatch(fresh, pcfg.n_micro)
            outs, cache = pipe(params["stages"], inputs_mb, cache)
            h = unmicrobatch(last_stage_output(outs)["h"])
            logits = model.head_logits(params, h[:, -1:, :])
        return logits, cache

    prefill_step.tplan = pipe.tplan
    return prefill_step


def build_serve_step(model: LMModel, pcfg: ParallelConfig, devices: Any,
                     shape: ShapeConfig, *,
                     park_info: Optional[Dict[str, Any]] = None):
    """serve_step(params, cache, tokens) -> (logits [B,1,V], cache).

    One decode tick: the request batch is micro-batched through the
    pipeline exactly like prefill (the paper's schedule reused for
    inference); each layer's ring cache advances in place."""
    consts = model.consts()
    stage_apply = model.make_stage_apply_decode(consts)
    pipe = pipeline_call(stage_apply, cfg=pcfg, devices=devices,
                         park_info=park_info)

    def serve_step(params, cache, tokens):
        with torch.inference_mode():
            h = model.embed_decode(params["embed"], tokens, pos=shape.seq_len)
            inputs_mb = microbatch({"h": h}, pcfg.n_micro)
            outs, cache = pipe(params["stages"], inputs_mb, cache)
            h1 = unmicrobatch(last_stage_output(outs)["h"])
            logits = model.head_logits(params, h1)
        return logits, cache

    serve_step.tplan = pipe.tplan
    return serve_step
