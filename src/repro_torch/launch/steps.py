"""Step functions: train / prefill / serve through the GPipe pipeline.

Counterpart of :mod:`repro.launch.steps` (``build_train_step``,
``build_prefill_step``, ``build_serve_step``).  Where the reference takes a
mesh, the port takes the stage placement: one device per stage, or one
device for all of them.  The serving steps run under
``torch.inference_mode()``; the train step runs the forward clock-cycle with
grad and lets autograd induce the reverse one.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.core.pipeline import (last_stage_output, microbatch,
                                       pipeline_call, unmicrobatch)
from repro_torch.models.lm import LMModel
from repro_torch.optim import optimizers as optim
from repro_torch.tree import tree_leaves, tree_map

FUSED_SCHEDULES = ("1f1b", "gpipe_tasked", "interleaved", "zb")


def build_train_step(model: LMModel, pcfg: ParallelConfig, devices: Any,
                     shape: ShapeConfig,
                     ocfg: Optional[optim.OptimizerConfig] = None):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``schedule="gpipe"`` (paper Algorithm 1): embed, micro-batch, the GPipe
    forward clock-cycle (:func:`pipeline_call`, each stage under
    ``pcfg.remat``), un-micro-batch, the chunked head loss; autograd then
    runs the reverse clock-cycle, ``torch.autograd.grad`` collects every
    parameter leaf's gradient and :func:`optim.apply` updates.  With
    ``ocfg.dynamic_loss_scale`` the loss is multiplied by the state's scale
    before autograd and ``optim.apply`` unscales.  ``batch`` holds
    ``tokens`` and ``labels`` [B, S] on the model's device; metrics are 0-d
    tensors (reading one waits for the step)."""
    ocfg = ocfg or optim.OptimizerConfig()
    spec = pcfg.schedule_spec
    if spec.base in FUSED_SCHEDULES:
        raise NotImplementedError(
            f"schedule {pcfg.schedule!r} runs the fused F+B executor, which "
            "is not ported yet: ROADMAP A3; use schedule='gpipe'")
    if spec.base != "gpipe":
        raise ValueError(f"unknown schedule {pcfg.schedule!r}")
    if pcfg.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={pcfg.grad_compression!r} is not ported yet: "
            "ROADMAP A7")
    loss_fn = build_loss_fn(model, pcfg, devices)

    def train_step(params, opt_state, batch):
        grad_params = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = loss_fn(grad_params, batch)
            scaled = loss * opt_state.scale if ocfg.dynamic_loss_scale else loss
            flat = iter(torch.autograd.grad(scaled, tree_leaves(grad_params)))
        grads = tree_map(lambda _: next(flat), params)
        params2, opt2, metrics = optim.apply(ocfg, opt_state, params, grads,
                                             loss=scaled.detach())
        metrics["loss"] = loss.detach()
        return params2, opt2, metrics

    train_step.tplan = loss_fn.tplan
    return train_step


def build_loss_fn(model: LMModel, pcfg: ParallelConfig, devices: Any):
    """loss_fn(params, batch) -> mean token cross-entropy (0-d fp32): embed,
    micro-batch, the GPipe forward clock-cycle, un-micro-batch, the chunked
    head loss.  Differentiable: the loss of :func:`build_train_step`."""
    pipe = pipeline_call(model.make_stage_apply(model.consts()), cfg=pcfg,
                         devices=devices)

    def loss_fn(params, batch):
        fresh = model.embed_inputs(params["embed"], batch)
        outs, _ = pipe(params["stages"], microbatch(fresh, pcfg.n_micro))
        h = unmicrobatch(last_stage_output(outs)["h"])
        return model.head_loss(params, h, batch["labels"])

    loss_fn.tplan = pipe.tplan
    return loss_fn


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
