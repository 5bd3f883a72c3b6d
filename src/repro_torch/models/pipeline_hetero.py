"""Heterogeneous pipeline programs: U-Net and AmoebaNet-D.

Counterpart of :mod:`repro.models.pipeline_hetero`.  LM stages are
homogeneous (stacked parameters); conv nets change channel counts and
resolutions from stage to stage, so each stage runs its own run of layers
(``model.bounds``) on its own parameter tree.  The executors take the
stage parameters as a sequence of per-stage trees and return gradients in
that form, and a boundary carries a dict of tensors.  The reference packs
both into flat padded fp32 buffers because ``lax.switch`` needs one shape
for every branch; nothing here does.

Skip connections crossing stage boundaries follow paper §3.3:
  * ``portals=True``: each crossing skip is a ``SkipSpec`` edge, and the
    executor's route sends it straight from its producing stage to its
    consuming stage;
  * ``portals=False``: the live crossing skips ride in the carry,
    ``{"x": ..., "s<k>": ...}``, through every stage in between.

On one card both do the same work (the hop is ``.to()`` onto the same
device); what portals save, copies on the cards in between, needs stages on
several cards.  Every schedule also runs one rank of a ``(data, pipe)``
mesh per process (``hetero_grad_call(..., mesh_view=...)``).

The programs compute in fp32: :func:`hetero_forward` and the call of
:func:`hetero_grad_call` run under :func:`fp32_math`, TF32 off in cuDNN and
cuBLAS, whatever the process has set (PyTorch lets cuDNN use TF32 by
default).  A backward taken later through ``hetero_forward``'s output runs
under the process's flags.

    prog = build_hetero_program(model, params, pcfg, device="cuda")
    y = hetero_forward(prog, pcfg, x)                 # x [B, C, H, W]
    loss, grads = hetero_grad_call(prog, pcfg)(prog.stage_params, x, y)
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.core import p2p
from repro_torch.core.p2p import PipeGroup
from repro_torch.core.pipeline import (last_stage_output, microbatch,
                                       pipeline_call, pipeline_grad_call,
                                       unmicrobatch)
from repro_torch.core.skip import SkipSpec
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class HeteroProgram:
    stage_params: List[Dict[str, Any]]  # per stage: {str(layer): its tree}
    stage_apply: Callable               # pipeline StageApplyFn
    skips: List[SkipSpec]               # portal edges (none without portals)
    device: torch.device


def build_hetero_program(model, params, pcfg: ParallelConfig,
                         device: DeviceLike = "cuda") -> HeteroProgram:
    """Compile a layer-list model (``UNetModel`` / ``AmoebaNetModel``:
    ``layers``, ``bounds``, ``n_stages``, ``layer_apply(i, p, x, skips)``)
    and its per-layer ``params`` into a pipeline program on ``device``.

    ``model.skip_edges()`` names the skips that cross stages, each with
    one destination.  ``model.n_stages`` must be the global stage count, ``pcfg.pipe`` times
    the virtual stages of an interleaved schedule.  ``pcfg.portals`` picks
    how crossing skips travel (module docstring)."""
    n = model.n_stages
    if n != pcfg.pipe * pcfg.virtual_stages:
        raise ValueError(f"model has {n} stages; pcfg runs pipe="
                         f"{pcfg.pipe} x {pcfg.virtual_stages} chunks")
    if len(params) != len(model.layers):
        raise ValueError(f"{len(params)} layer trees for "
                         f"{len(model.layers)} layers")
    dev = resolve_device(device)
    bounds = model.bounds
    crossing = model.skip_edges()
    edges = crossing if pcfg.portals else []

    def carried_into(s: int) -> List[str]:
        """Crossing skips the carry holds into stage ``s`` (portals off)."""
        if pcfg.portals:
            return []
        return [e.name for e in crossing if e.src_stage < s <= e.dsts[0]]

    stage_params = [{str(li): tree_map(lambda a: a.to(dev), params[li])
                     for li in range(bounds[s], bounds[s + 1])}
                    for s in range(n)]

    def stage_apply(p, carry, skips_in, resident, ctx):
        s = ctx.stage
        store = dict(carry if s else ctx.fresh)
        x = store.pop("x")
        store.update(skips_in)
        for li in range(bounds[s], bounds[s + 1]):
            x = model.layer_apply(li, p[str(li)], x, store)
        skips_out = {e.name: store[e.name] for e in edges
                     if e.src_stage == s}
        carry_out = {"x": x, **{k: store[k] for k in carried_into(s + 1)}}
        return carry_out, skips_out, resident

    return HeteroProgram(stage_params, stage_apply, edges, dev)


@contextlib.contextmanager
def fp32_math():
    """TF32 off in cuDNN and cuBLAS while the block runs, the process's
    flags restored after: TF32 keeps 10 mantissa bits, fp32 23."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def micro_loss(head_params, carry, largs) -> torch.Tensor:
    """One micro-batch's loss: the MSE of the last stage's output against
    ``y`` (fp32)."""
    return torch.mean((carry["x"].float() - largs["y"].float()) ** 2)


@fp32_math()
def hetero_forward(program: HeteroProgram, pcfg: ParallelConfig, x_batch):
    """The pipelined forward (GPipe clock-cycle): ``x [B, ...]`` -> the last
    stage's output ``[B, ...]``.  Differentiable under grad mode."""
    pipe = pipeline_call(program.stage_apply, cfg=pcfg,
                         devices=program.device, skips=program.skips)
    outs, _ = pipe(program.stage_params, microbatch({"x": x_batch},
                                                    pcfg.n_micro))
    return unmicrobatch(last_stage_output(outs))["x"]


def hetero_grad_call(program: HeteroProgram, pcfg: ParallelConfig,
                     park_info: Optional[Dict[str, Any]] = None, *,
                     mesh_view=None):
    """Training call for a hetero program under ``pcfg.schedule``.

    Returns ``call(stage_params, x [B, ...], y [B, ...]) -> (loss, grads)``:
    ``loss`` is the mean over micro-batches of each one's MSE against
    ``y`` (:func:`micro_loss`), and ``grads`` mirror ``stage_params`` (a
    list of per-stage trees).  ``"gpipe"`` runs the clock-cycle forward
    under autograd (each stage under ``pcfg.remat``) and lets autograd
    run the reverse one; the fused schedules (``gpipe_tasked``, ``1f1b``,
    ``interleaved:v``, ``zb`` with ``pcfg.residuals``) run the F+B
    executor; both in fp32 (:func:`fp32_math`).  ``call.tplan`` is the
    plan; ``park_info`` (a dict) receives each call's buffer and route
    high-water.

    On a mesh (``mesh_view``, data and pipe parallelism) each replica
    passes its slice of the batch and runs its pipe group.  With pipe > 1
    the call runs one pipe rank: it takes that rank's stage trees in
    chunk order (``program.stage_params[rank::pipe]``) and returns their
    grads, and the loss on the last rank (None on the others); under
    ``"gpipe"`` the skips' and the chain's cotangents cross the processes
    through :class:`p2p.Backprop`.  With data > 1 the loss and every
    gradient leaf are then averaged over the replicas, summed in replica
    order (``AxisGroup.sum``), so every replica gets the same bits.
    """
    if mesh_view is None:
        return _grad_call(program, pcfg, park_info, None)
    if mesh_view.shape["tp"] > 1:
        raise NotImplementedError(
            "tp > 1 for the heterogeneous models: their layers have no "
            "tensor-parallel split (the reference's has none either)")
    pipe = mesh_view.pipe
    inner = _grad_call(program, pcfg, park_info,
                       pipe if pipe.size > 1 else None)
    rep = mesh_view.axes["replica"]
    if rep.size == 1:
        return inner

    def mean_call(stage_params, x_batch, y_batch):
        loss, grads = inner(stage_params, x_batch, y_batch)
        if loss is not None:
            loss = rep.sum(loss, "data_reduce", mean=True)
        return loss, [tree_map(lambda g: rep.sum(g, "data_reduce",
                                                 mean=True), p)
                      for p in grads]

    mean_call.tplan = inner.tplan
    return mean_call


def _grad_call(program: HeteroProgram, pcfg: ParallelConfig,
               park_info: Optional[Dict[str, Any]],
               group: Optional[PipeGroup]):
    """:func:`hetero_grad_call` of one replica: every stage in this
    process, or (``group``) one pipe rank's."""
    m = pcfg.n_micro
    first = group is None or group.first
    last = group is None or group.last
    if pcfg.schedule_spec.base == "gpipe":
        pipe = pipeline_call(program.stage_apply, cfg=pcfg,
                             devices=program.device, skips=program.skips,
                             park_info=park_info, group=group)

        @fp32_math()
        def call(stage_params, x_batch, y_batch):
            ps = [tree_map(lambda a: a.detach().requires_grad_(), p)
                  for p in stage_params]
            bp = p2p.Backprop()
            loss, roots = None, []
            with torch.enable_grad():
                inputs_mb = microbatch({"x": x_batch}, m) if first else None
                outs, _ = pipe(ps, inputs_mb, backprop=bp)
                if last:
                    out = last_stage_output(outs)["x"]
                    y_mb = microbatch({"y": y_batch}, m)
                    loss = torch.zeros((), dtype=torch.float32,
                                       device=out.device)
                    for i in range(m):            # ascending micro order
                        loss = loss + micro_loss(None, {"x": out[i]},
                                                 {"y": y_mb["y"][i]})
                    loss = loss / m
                    roots = [loss]
                # the U-Net head's norm is never applied: zeros
                flat = iter(bp.grad(roots, [leaf for p in ps
                                            for leaf in tree_leaves(p)]))
            return (None if loss is None else loss.detach(),
                    [tree_map(lambda _: next(flat), p) for p in stage_params])

        call.tplan = pipe.tplan
        return call

    pipe_grad, tplan = pipeline_grad_call(
        program.stage_apply, cfg=pcfg, loss_fn=micro_loss,
        devices=program.device, skips=program.skips, park_info=park_info,
        group=group)

    @fp32_math()
    def call(stage_params, x_batch, y_batch):
        loss, g_stage, _, _ = pipe_grad(stage_params, {},
                                        microbatch({"x": x_batch}, m),
                                        microbatch({"y": y_batch}, m))
        return loss, g_stage

    call.tplan = tplan
    return call


def layer_list(model, stage_trees) -> List[Any]:
    """Per-stage trees (parameters or gradients) -> the per-layer list."""
    return [stage_trees[s][str(li)] for s in range(model.n_stages)
            for li in range(model.bounds[s], model.bounds[s + 1])]
