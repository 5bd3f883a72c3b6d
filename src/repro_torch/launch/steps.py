"""Step functions: train / prefill / serve through the pipeline executors.

Counterpart of :mod:`repro.launch.steps` (``build_train_step``,
``build_prefill_step``, ``build_serve_step``).  Where the reference takes a
mesh, the port takes the stage placement: one device per stage, or one
device for all of them, or a model on a mesh (``LMModel(...,
mesh=...)``), one rank per process.  The serving steps run under
``torch.inference_mode()``.  The train step runs the forward clock-cycle
with grad and lets autograd induce the reverse one (``schedule="gpipe"``),
or runs the fused F+B scheduler, which computes its own gradients
(``1f1b``, ``gpipe_tasked``, ``interleaved:v``, ``zb``).

On a mesh each data-parallel replica runs its batch slice through its pipe
group; the step joins the FSDP blocks (once a step with
``gather_weights_once``, else at each stage application), takes the mean
gradient over the replicas in replica order, through the host (each FSDP
block folded on its owner alone, a reduce-scatter; a leaf without one
folded on every replica, with the same bits on each), applies ``int8_ef``
to that reduced gradient as the reference does, takes the norm and the
finite flag over one model copy and updates each rank's blocks.  A pipe
group is the mesh with every other degree 1.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.core import checkpointing
from repro_torch.core import p2p
from repro_torch.core.pipeline import (check_plan, last_stage_output,
                                       microbatch, pipeline_call,
                                       pipeline_grad_call, unmicrobatch)
from repro_torch.launch import sharding
from repro_torch.models.lm import LMModel
from repro_torch.optim import optimizers as optim
from repro_torch.runtime.compression import EFCompressor, ef_quantize
from repro_torch.tree import tree_leaves, tree_map

FUSED_SCHEDULES = ("1f1b", "gpipe_tasked", "interleaved", "zb")
GRAD_COMPRESSION_RANGE = "grad_compression"   # profiler range of the codec
DATA_REDUCE = "data_reduce"        # collective classes of the mesh step
EF_GATHER = "ef_gather"


def _pipe_group(model: LMModel) -> Optional[p2p.PipeGroup]:
    """The pipe group the executors run on: the mesh's pipe axis, or None
    (every stage in this process: no mesh, or pipe 1)."""
    if model.mesh is None:
        return None
    pipe = model.mesh.pipe
    return pipe if pipe.size > 1 else None


def _standin(leaf, spec, mesh):
    """The memory-free stand-in of a stage leaf's whole over its FSDP axis
    (the leaf itself where it has none)."""
    fg = sharding.fsdp_group(spec)
    if fg is None:
        return leaf
    d, group = fg
    shape = list(leaf.shape)
    shape[d] *= mesh.axes[group].size
    return torch.zeros((), dtype=leaf.dtype, device=leaf.device).expand(shape)


def _data_reduce(g, spec, mesh):
    """The mean of a gradient leaf over the replicas, in replica order:
    this rank's FSDP block of it, folded on its owner alone (a
    reduce-scatter), or the whole leaf where it has no FSDP axis.  A leaf
    over ``data`` alone on a mesh of pods is reduced whole, then cut."""
    rep, fg = mesh.axes["replica"], sharding.fsdp_group(spec)
    if fg is None:
        return rep.sum(g, DATA_REDUCE, mean=True)
    d, group = fg
    if mesh.axes[group].size == rep.size:
        return rep.reduce_scatter(g, d, DATA_REDUCE, mean=True)
    return mesh.axes[group].block(rep.sum(g, DATA_REDUCE, mean=True), d)


def _compress(pcfg: ParallelConfig, model: LMModel, grads, opt_state):
    """int8-EF of the reduced gradient (``grad_compression="int8_ef"``,
    reference ``steps._maybe_compress_grads``): each leaf, with its
    residual folded in, quantized and dequantized on the blocks of 256 of
    the WHOLE flattened leaf before the optimizer.  On a mesh the leaf's
    FSDP and ``tp`` blocks and the residual's are joined first (exact), so
    the result does not depend on the placement, and the rank keeps its
    blocks of both.  Returns the rewritten (fp32) grads and the new
    residual tree."""
    if pcfg.grad_compression != "int8_ef":
        return grads, opt_state.ef
    if opt_state.ef == ():
        raise ValueError(
            "grad_compression='int8_ef' needs the error-feedback residual "
            "on the optimizer state: initialize it with "
            "optim.init(ocfg, params, with_ef=True)")
    mesh, block = model.mesh, EFCompressor().block
    if mesh is None:
        with torch.profiler.record_function(GRAD_COMPRESSION_RANGE):
            return EFCompressor().compress_reduce(grads, opt_state.ef)
    tp = mesh.axes["tp"]

    def one(g, e, spec):
        td, fg = sharding.axis_dim(spec, "tp"), sharding.fsdp_group(spec)
        if fg is not None:
            ax = mesh.axes[fg[1]]
            g, e = ax.cat(g, fg[0], EF_GATHER), ax.cat(e, fg[0], EF_GATHER)
        if td is not None:
            g, e = tp.cat(g, td, EF_GATHER), tp.cat(e, td, EF_GATHER)
        _, _, deq, resid = ef_quantize(g, e, block)
        if td is not None:
            deq, resid = tp.block(deq, td), tp.block(resid, td)
        if fg is not None:
            ax = mesh.axes[fg[1]]
            deq = ax.block(deq, fg[0]).contiguous()
            resid = ax.block(resid, fg[0])
        return deq, resid

    with torch.profiler.record_function(GRAD_COMPRESSION_RANGE):
        pairs = tree_map(one, grads, opt_state.ef, model.specs)
    return (tree_map(lambda _, p: p[0], grads, pairs),
            tree_map(lambda _, p: p[1], grads, pairs))


def norm_terms(model: LMModel, grads) -> list:
    """This rank's terms of the global norm over one model copy, in fold
    order (``optim.apply``'s ``norm_terms``), from its reduced ``grads``.
    Each leaf counts once in the model: a leaf whole over ``tp`` on tp
    rank 0 alone, a copy of another pipe rank's leaf (the last rank's tied
    embedding) never.  A counted leaf splits into the blocks the
    placement with FSDP on gives it (one where it has none), and replica
    ``j`` computes block ``j`` (None elsewhere): its own block under FSDP,
    a cut of its whole leaf without; so the norm's bits do not depend on
    ``pcfg.fsdp``."""
    mesh = model.mesh
    pipe = mesh.pipe
    dup = model.replicas(pipe.rank) if pipe.size > 1 else ()
    tp0, replica = mesh.coords["tp"] == 0, mesh.replica
    out = []
    for k in grads:
        for g, spec, full in zip(tree_leaves(grads[k]),
                                 tree_leaves(model.specs[k]),
                                 tree_leaves(model.fsdp_specs[k])):
            if k in dup or not (tp0 or sharding.axis_dim(spec, "tp")
                                is not None):
                continue
            fg = sharding.fsdp_group(full)
            n = 1 if fg is None else mesh.axes[fg[1]].size
            for j in range(n):
                if j != replica:
                    out.append(None)
                elif n == 1 or sharding.fsdp_group(spec) is not None:
                    out.append(g)
                else:
                    out.append(mesh.axes[fg[1]].block(g, fg[0]).contiguous())
    return out


def _gate_ef(metrics: Dict[str, Any], new_ef, old_ef):
    """Write the new residual into ``old_ef`` in place, except on a step
    the non-finite guard skipped (reference ``steps._gate_ef``): the
    compressor ran before the optimizer saw the grads, so without the gate
    a NaN batch would poison the residual of a discarded step."""
    if new_ef is old_ef:                      # no compression
        return old_ef
    fin = metrics.get("finite")
    with torch.no_grad():
        for new, old in zip(tree_leaves(new_ef), tree_leaves(old_ef)):
            old.copy_(new if fin is None else torch.where(fin > 0, new, old))
    return old_ef


def build_train_step(model: LMModel, pcfg: ParallelConfig, devices: Any,
                     shape: ShapeConfig,
                     ocfg: Optional[optim.OptimizerConfig] = None):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``pcfg.schedule`` selects the execution order (:func:`build_grad_fn`);
    :func:`optim.apply` then updates.  With ``ocfg.dynamic_loss_scale``
    every gradient carries the state's scale and ``optim.apply`` unscales.
    ``batch`` holds ``tokens`` and ``labels`` [B, S] on the model's device;
    metrics are 0-d tensors (reading one waits for the step).
    With ``pcfg.grad_compression="int8_ef"`` the grads pass the int8
    error-feedback compressor first, whose residual rides
    ``opt_state.ef`` (build the state with ``optim.init(...,
    with_ef=True)``) and keeps its old value on a skipped step.
    ``train_step.tplan`` is the plan the executor runs and
    ``train_step.park_info`` its buffer high-water per rank, refreshed by
    each step.

    On a mesh (the model's, :class:`LMModel` ``mesh``; a pipe group is
    the mesh with every other degree 1) the step runs one rank of its
    schedule (:func:`build_grad_fn`): ``params`` and ``opt_state`` are
    this rank's blocks (``model.init``), ``batch`` its replica's slice
    (``data.pipeline.make_sharded_loader``), and the step runs as the
    module docstring says: the optimizer's global norm and its
    finiteness decision are agreed over the mesh, each element of one
    model copy counted once (:func:`norm_terms`), and every rank's
    metrics carry the mean loss over the replicas."""
    ocfg = ocfg or optim.OptimizerConfig()
    # gate known config smells at selection time, as the reference does
    for msg in pcfg.advisories():
        warnings.warn(msg, stacklevel=2)
    grad_fn = build_grad_fn(model, pcfg, devices)
    mesh = model.mesh

    def train_step(params, opt_state, batch):
        scale = opt_state.scale if ocfg.dynamic_loss_scale else None
        loss, grads = grad_fn(params, batch, scale)
        scaled = loss * scale if scale is not None else loss
        grads, new_ef = _compress(pcfg, model, grads, opt_state)
        on_mesh = {} if mesh is None else dict(
            group=mesh.axes["model"], replica_group=mesh.axes["replica"],
            norm_terms=norm_terms(model, grads))
        params2, opt2, metrics = optim.apply(ocfg, opt_state, params, grads,
                                             loss=scaled, **on_mesh)
        opt2 = opt2._replace(ef=_gate_ef(metrics, new_ef, opt_state.ef))
        metrics["loss"] = loss
        return params2, opt2, metrics

    train_step.tplan = grad_fn.tplan
    train_step.park_info = grad_fn.park_info
    return train_step


def build_grad_fn(model: LMModel, pcfg: ParallelConfig, devices: Any):
    """grad_fn(params, batch, loss_scale=None) -> (loss, grads).

    ``loss`` is the mean token cross-entropy (0-d fp32, unscaled); ``grads``
    mirror ``params`` and carry ``loss_scale`` when it is given.

    ``schedule="gpipe"`` (paper Algorithm 1): embed, micro-batch, the GPipe
    forward clock-cycle (:func:`build_loss_fn`, each stage under
    ``pcfg.remat``), the chunked head loss; autograd runs the reverse
    clock-cycle and ``torch.autograd.grad`` collects every leaf.  The fused
    schedules (reference ``_build_train_step_fused``): embed with grad,
    micro-batch tokens and labels, :func:`pipeline_grad_call` with one
    micro-batch's head loss on the last stage, then the embed VJP on the
    input cotangents plus the tied embedding's gradient through the head.

    On a mesh with pipe > 1 this process runs one pipe rank: ``params``
    is its share (``LMModel.init``) and so are the grads.  Rank 0
    embeds and takes the embed's gradient, the last rank runs the head
    and its loss; a tied embedding's head part goes from the last rank to
    rank 0, which adds it in the single-process order and sends the sum
    back, so both copies get the same gradient.  Every rank returns the
    loss.  Under ``"gpipe"`` the hops carry their cotangents back
    (:class:`p2p.Backprop`), so autograd's reverse clock-cycle runs across
    the processes.
    """
    checkpointing.check_policy(pcfg.remat)
    group = _pipe_group(model)
    base = pcfg.schedule_spec.base
    if base == "gpipe":
        fn = _build_grad_fn_gpipe(model, pcfg, devices, group)
    elif base in FUSED_SCHEDULES:
        fn = _build_grad_fn_fused(model, pcfg, devices, group)
    else:
        raise ValueError(f"unknown schedule {pcfg.schedule!r}; want 'gpipe',"
                         " 'gpipe_tasked', '1f1b', 'interleaved:v', or 'zb'")
    return fn if model.mesh is None else _on_mesh(model, pcfg, fn)


def _on_mesh(model: LMModel, pcfg: ParallelConfig, inner):
    """``inner`` (one replica's grad fn on whole-over-data weights) on the
    rank's blocks: the embedding joined over its FSDP axis; the stage
    weights joined once (``gather_weights_once``, or no stage leaf has an
    FSDP axis) or stood in for and joined at each stage application
    (``model.bind_fsdp``); then the loss and every gradient leaf averaged
    over the replicas, in replica order (:func:`_data_reduce`).  The
    gradients come back as the rank's blocks."""
    mesh = model.mesh
    rep = mesh.axes["replica"]

    def grad_fn(params, batch, loss_scale=None):
        specs = model.specs
        full = dict(params)
        if "embed" in params:
            full["embed"] = sharding.gather_stage_weights(
                params["embed"], specs["embed"], mesh)
        zero3 = not pcfg.gather_weights_once and any(
            sharding.fsdp_group(sp) is not None
            for sp in tree_leaves(specs["stages"]))
        if zero3:
            full["stages"] = tree_map(lambda a, sp: _standin(a, sp, mesh),
                                      params["stages"], specs["stages"])
            model.bind_fsdp(params["stages"])
        else:
            full["stages"] = sharding.gather_stage_weights(
                params["stages"], specs["stages"], mesh)
        try:
            loss, grads = inner(full, batch, loss_scale)
        finally:
            model.bind_fsdp(None)
        del full
        loss = rep.sum(loss.detach(), DATA_REDUCE, mean=True)
        return loss, tree_map(lambda g, sp: _data_reduce(g, sp, mesh),
                              grads, specs)

    grad_fn.tplan, grad_fn.park_info = inner.tplan, inner.park_info
    return grad_fn


def _build_grad_fn_gpipe(model, pcfg, devices, group=None):
    park_info: Dict[str, Any] = {}
    loss_fn = build_loss_fn(model, pcfg, devices, park_info=park_info)
    check_plan(loss_fn.tplan, pcfg, autograd=True)
    first = group is None or group.first
    last = group is None or group.last

    def grad_fn(params, batch, loss_scale=None):
        grad_params = tree_map(lambda p: p.detach().requires_grad_(), params)
        bp = p2p.Backprop()
        roots = []
        with torch.enable_grad():
            loss = loss_fn(grad_params, batch, backprop=bp)
            if last:
                roots = [loss * loss_scale if loss_scale is not None
                         else loss]
            flat = iter(bp.grad(roots, tree_leaves(grad_params)))
        grads = tree_map(lambda _: next(flat), params)
        if group is not None:
            hop = p2p.P2PHop(group)
            if model.arch.tie_embeddings and first != last:
                # the head's part (the last rank's copy) + the lookup's
                grads["embed"] = _tied_sum(group, hop, grads["embed"],
                                           first)
            hop.finish()
            park_info["hops"]["embed"] = hop.stats["embed"]
            loss = p2p.group_loss(group, loss)
        return loss.detach(), grads

    grad_fn.tplan, grad_fn.park_info = loss_fn.tplan, park_info
    return grad_fn


def _tied_sum(group: p2p.PipeGroup, hop: p2p.P2PHop, own, first: bool):
    """A tied embedding's gradient on rank 0 and the last rank: rank 0
    adds the last rank's head part to its own lookup part, in the
    single-process order, and sends the sum back."""
    if first:
        head = hop.recv_tree("embed", group.size - 1)[1]
        total = tree_map(lambda gl, gh: gl + gh, own, head)
        hop.send_tree("embed", group.size - 1, total)
        return total
    hop.send_tree("embed", 0, own)
    return hop.recv_tree("embed", 0)[1]


def _build_grad_fn_fused(model, pcfg, devices, group=None):
    def micro_loss(head_ps, carry, largs):
        return model.head_loss(head_ps, carry["h"], largs["labels"])

    park_info: Dict[str, Any] = {}
    pipe_grad, tplan = pipeline_grad_call(
        model.make_stage_apply(model.consts()), cfg=pcfg, loss_fn=micro_loss,
        devices=devices, skips=model.skips(), park_info=park_info,
        group=group)
    m, tied = pcfg.n_micro, model.arch.tie_embeddings
    # one process runs the first and the last stage
    first = group is None or group.first
    last = group is None or group.last

    def grad_fn(params, batch, loss_scale=None):
        inputs_mb = labels_mb = head_ps = None
        if first:
            emb = tree_map(lambda p: p.detach().requires_grad_(),
                           params["embed"])
            with torch.enable_grad():
                fresh = model.embed_inputs(emb, batch)
            inputs_mb = microbatch(tree_map(torch.Tensor.detach, fresh), m)
        if last:
            labels_mb = microbatch({"labels": batch["labels"]}, m)
            head_ps = {"head": params["head"]}
            if "embed" in params:           # the last rank's: a tied copy
                head_ps["embed"] = params["embed"]
        loss, g_stage, g_head, ig = pipe_grad(
            params["stages"], head_ps, inputs_mb, labels_mb,
            loss_scale=1.0 if loss_scale is None else loss_scale)
        grads = {"stages": g_stage}
        if last:
            grads["head"] = g_head["head"]
        hop = None if group is None else p2p.P2PHop(group)
        if first:
            # every fresh leaf with a parameter behind it (an enc-dec's
            # frames have none); dec_h's cotangent came back through stage
            # 0's B tick
            outs = [(x, g) for x, g in zip(tree_leaves(fresh),
                                           tree_leaves(unmicrobatch(ig)))
                    if x.requires_grad]
            flat = iter(torch.autograd.grad([x for x, _ in outs],
                                            tree_leaves(emb),
                                            [g for _, g in outs]))
            own = tree_map(lambda _: next(flat), params["embed"])
            if tied and not last:
                grads["embed"] = _tied_sum(group, hop, own, True)
            else:
                # the head's part: the last stage's (zeros, as autograd
                # gives an unused input, when untied)
                head = (g_head["embed"] if last
                        else tree_map(torch.zeros_like, own))
                grads["embed"] = tree_map(lambda gl, gh: gl + gh, own, head)
        elif last and tied:                 # the last rank's copy
            grads["embed"] = _tied_sum(group, hop, g_head["embed"], False)
        if group is not None:
            hop.finish()
            park_info["hops"]["embed"] = hop.stats["embed"]
            loss = p2p.group_loss(group, loss)
        return loss, {k: grads[k] for k in params}

    grad_fn.tplan, grad_fn.park_info = tplan, park_info
    return grad_fn


def build_loss_fn(model: LMModel, pcfg: ParallelConfig, devices: Any, *,
                  park_info: Optional[Dict[str, Any]] = None):
    """loss_fn(params, batch, backprop=None) -> mean token cross-entropy
    (0-d fp32): embed, micro-batch, the GPipe forward clock-cycle,
    un-micro-batch, the chunked head loss.  Differentiable: the loss of the
    ``gpipe`` train step, which passes a :class:`p2p.Backprop` and
    differentiates with it.  On a mesh with pipe > 1 this process runs
    one pipe rank: ``params`` is its share, rank 0 embeds ``batch``, the
    last rank returns the loss (None elsewhere), and under grad the
    ``backprop`` is required (:func:`pipeline_call`)."""
    group = _pipe_group(model)
    pipe = pipeline_call(model.make_stage_apply(model.consts()), cfg=pcfg,
                         devices=devices, skips=model.skips(),
                         park_info=park_info, group=group)
    first = group is None or group.first
    last = group is None or group.last

    def loss_fn(params, batch, backprop: Optional[p2p.Backprop] = None):
        inputs_mb = None
        if first:
            fresh = model.embed_inputs(params["embed"], batch)
            inputs_mb = microbatch(fresh, pcfg.n_micro)
        outs, _ = pipe(params["stages"], inputs_mb, backprop=backprop)
        if not last:
            return None
        h = unmicrobatch(last_stage_output(outs)["h"])
        return model.head_loss(params, h, batch["labels"])

    loss_fn.tplan = pipe.tplan
    return loss_fn


def build_prefill_step(model: LMModel, pcfg: ParallelConfig, devices: Any,
                       shape: ShapeConfig, *,
                       park_info: Optional[Dict[str, Any]] = None):
    """prefill_step(params, cache, batch) -> (last_token_logits, cache).

    ``cache`` (from ``model.init_cache``) is filled in place and returned.
    ``batch`` holds ``tokens`` (and a vision stub's ``patches``), or an
    enc-dec's ``frames`` and ``dec_tokens``; the encoder memory reaches the
    decoder stages as skips
    (``model.skips()``).  On a mesh (the model's) ``params`` are the
    rank's, whole over data (``model.gather_fsdp``), ``batch`` the
    replica's slice, ``cache`` its kv heads and slice
    (``model.init_cache``), and the logits whole over the vocab; with
    pipe > 1 rank 0 embeds ``batch`` and the last rank returns the
    logits (None elsewhere)."""
    group = _pipe_group(model)
    consts = model.consts()
    stage_apply = model.make_stage_apply(consts, prefill=True)
    pipe = pipeline_call(stage_apply, cfg=pcfg, devices=devices,
                         skips=model.skips(), park_info=park_info,
                         group=group)

    def prefill_step(params, cache, batch):
        logits = inputs_mb = None
        with torch.inference_mode():
            if group is None or group.first:
                fresh = model.embed_inputs(params["embed"], batch)
                inputs_mb = microbatch(fresh, pcfg.n_micro)
            outs, cache = pipe(params["stages"], inputs_mb, cache)
            if group is None or group.last:
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
    inference); each layer's ring cache advances in place.  No skip runs
    here: an enc-dec's decoder reads the encoder memory from its cross
    caches, which prefill filled.  Every step embeds its token at position
    ``shape.seq_len``, as the reference does.  On a mesh as in
    :func:`build_prefill_step`: with pipe > 1 rank 0 embeds ``tokens``
    (None elsewhere) and the last rank returns the logits."""
    group = _pipe_group(model)
    consts = model.consts()
    stage_apply = model.make_stage_apply_decode(consts)
    pipe = pipeline_call(stage_apply, cfg=pcfg, devices=devices,
                         park_info=park_info, group=group)

    def serve_step(params, cache, tokens):
        logits = inputs_mb = None
        with torch.inference_mode():
            if group is None or group.first:
                h = model.embed_decode(params["embed"], tokens,
                                       pos=shape.seq_len)
                inputs_mb = microbatch({"h": h}, pcfg.n_micro)
            outs, cache = pipe(params["stages"], inputs_mb, cache)
            if group is None or group.last:
                h1 = unmicrobatch(last_stage_output(outs)["h"])
                logits = model.head_logits(params, h1)
        return logits, cache

    serve_step.tplan = pipe.tplan
    return serve_step
