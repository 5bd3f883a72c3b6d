"""Training entry point for the heterogeneous pipelines: U-Net and
AmoebaNet-D (paper §4.2) through the GPipe clock-cycle (autograd backward)
or the fused F+B scheduler, with skip routes for U-Net's crossing skips.

A model trains from random weights on one fixed seeded batch against a
seeded random target (MSE), with SGD and momentum 0.9 at a constant lr, in
fp32 (the program turns TF32 off while it runs:
``pipeline_hetero.fp32_math``).  All stages sit on one device, in one
process or, given a mesh view (:mod:`repro_torch.launch.mesh`), one rank
of ``(data, pipe)`` in each process: each pipe rank's stages in its own,
each data-parallel replica training on its slice of the batch.
``PAPER`` holds the paper's speed settings, U-Net (B, C) = (5, 64) at
192 x 192 and AmoebaNet-D (L, F) = (18, 256) at 224 x 224:

    res = train_hetero(PAPER["unet"], ParallelConfig(pipe=8, tp=1, data=1,
                       n_micro=8, schedule="1f1b"), batch=32, steps=5)
    res["summary"]      # step ms, samples/s, counted fp32 TFLOP/s, peak
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.core import p2p
from repro_torch.devices import resolve_device
from repro_torch.models import pipeline_hetero as PH
from repro_torch.models.amoebanet import AmoebaConfig, AmoebaNetModel
from repro_torch.models.unet import UNetConfig, UNetModel
from repro_torch.optim import optimizers as optim

ModelConfig = Union[UNetConfig, AmoebaConfig]

#: the paper's speed settings
PAPER = {"unet": UNetConfig(B=5, C=64, levels=5, img=192),
         "amoebanet": AmoebaConfig(L=18, F=256, img=224, n_classes=1000)}


def target_shape(mcfg: ModelConfig, batch: int):
    """U-Net regresses an image, AmoebaNet-D a vector of class scores."""
    if isinstance(mcfg, UNetConfig):
        return (batch, mcfg.out_ch, mcfg.img, mcfg.img)
    return (batch, mcfg.n_classes)


def sgd(lr: float) -> optim.OptimizerConfig:
    """SGD with momentum 0.9 at a constant lr (the paper trains AmoebaNet
    with plain SGD)."""
    return optim.OptimizerConfig(name="sgd", lr=lr, momentum=0.9,
                                 warmup_steps=0, min_lr_ratio=1.0)


def _mesh_pipe(mesh_view) -> Optional[p2p.PipeGroup]:
    """The pipe group of a mesh (None: no mesh, or pipe 1)."""
    if mesh_view is None or mesh_view.pipe.size == 1:
        return None
    return mesh_view.pipe


def build_problem(mcfg: ModelConfig, pcfg: ParallelConfig, *, batch: int,
                  device="cuda", seed: int = 0, mesh_view=None):
    """The model (``n_stages = pcfg.pipe * pcfg.virtual_stages``), its
    program on random weights from ``seed``, one fixed batch and target
    from ``seed + 1``: ``(model, prog, stages, x, y)``.  ``stages`` are
    the stage trees this process trains: all of them, or on a mesh
    (``mesh_view``, on its device; ``device`` is ignored) its pipe rank's
    (``prog.stage_params[rank::pipe]``), every rank drawing the whole
    model and the batch and keeping its replica's rows of ``x`` and
    ``y``."""
    group = _mesh_pipe(mesh_view)
    dev = resolve_device(device) if mesh_view is None else mesh_view.device
    cls = UNetModel if isinstance(mcfg, UNetConfig) else AmoebaNetModel
    model = cls(mcfg, pcfg.pipe * pcfg.virtual_stages)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    prog = PH.build_hetero_program(model, params, pcfg, dev)
    stages = (prog.stage_params if group is None
              else prog.stage_params[group.rank::pcfg.pipe])
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn(batch, mcfg.in_ch, mcfg.img, mcfg.img, generator=g,
                    device=dev)
    y = torch.randn(target_shape(mcfg, batch), generator=g, device=dev)
    if mesh_view is not None:
        n = batch // mesh_view.replicas
        lo = mesh_view.replica * n
        x, y = x[lo:lo + n], y[lo:lo + n]
    return model, prog, stages, x, y


def build_train_step(mcfg: ModelConfig, pcfg: ParallelConfig, *, batch: int,
                     device="cuda", seed: int = 0,
                     ocfg: Optional[optim.OptimizerConfig] = None,
                     mesh_view=None):
    """The problem of :func:`build_problem` and its train step:
    ``(model, step)`` with ``step() -> (loss, grad_norm)`` updating the
    weights and SGD state in place.  ``step.tplan`` is the plan and
    ``step.park_info`` the executor's buffer and route high-water of the
    last step.

    On a mesh (``mesh_view``) this process trains its pipe rank's
    stages: the loss comes from the last pipe rank, the gradients are the
    replicas' mean (:func:`PH.hetero_grad_call`), and the grad norm and
    the finiteness decision are taken over one model copy (the mesh's
    ``model`` axis, ``optim.apply(..., group=)``)."""
    ocfg = ocfg or sgd(0.01)
    model, prog, stages, x, y = build_problem(
        mcfg, pcfg, batch=batch, device=device, seed=seed,
        mesh_view=mesh_view)
    tree = dict(enumerate(stages))                  # updated in place
    state = [optim.init(ocfg, tree)]
    info: Dict[str, Any] = {}
    call = PH.hetero_grad_call(prog, pcfg, info, mesh_view=mesh_view)
    pipe = _mesh_pipe(mesh_view)
    norm_group = None if mesh_view is None else mesh_view.axes["model"]

    def step():
        loss, grads = call(stages, x, y)
        if pipe is not None:
            loss = p2p.group_loss(pipe, loss)
        _, state[0], metrics = optim.apply(ocfg, state[0], tree,
                                           dict(enumerate(grads)),
                                           loss=loss, group=norm_group)
        return loss, metrics["grad_norm"]

    step.tplan, step.park_info = call.tplan, info
    return model, step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_hetero(mcfg: ModelConfig, pcfg: ParallelConfig, *, batch: int,
                 steps: int, device="cuda", seed: int = 0,
                 ocfg: Optional[optim.OptimizerConfig] = None,
                 trace: bool = False,
                 mesh_view=None) -> Dict[str, Any]:
    """Train ``steps`` steps on one fixed batch.  Returns one record per
    step (loss, grad norm, ``step_s`` on the host clock around the
    synchronized step), the buffer and route high-water of the last step
    and the plan's, and ``summary``: the median step of steps 2..n (step 1
    alone if there is one), its samples/s, the counted conv FLOPs of a step
    (3 x the forward's, ``model.conv_flops``; the recompute not counted)
    and their rate, and on a card the peak memory from the first step on.
    ``trace`` (a card only) runs one more step under the profiler
    (:func:`profile_serve.device_profile`); it is not in ``history``.

    On a mesh (``mesh_view``, or a pipe group's,
    :func:`repro_torch.launch.mesh.init_pipe_group`) this process trains
    its rank's stages on its replica's rows (:func:`build_train_step`):
    each record holds the mesh's loss and grad norm and this rank's
    ``step_s``, ``park_info`` is this rank's (``buffer_slots``,
    ``per_route``, per-class ``hops``) and every rank also gets
    ``ranks``: per rank of the world its ``park_info``, ``step_s`` and,
    on a card, its peak memory in GiB."""
    world = mesh_view
    dev = resolve_device(device) if world is None else world.device
    if trace and (dev.type != "cuda" or world is not None):
        raise ValueError("trace profiles the card from one process: pass a "
                         "CUDA device and no pipe group")
    model, step = build_train_step(mcfg, pcfg, batch=batch, device=dev,
                                   seed=seed, ocfg=ocfg, mesh_view=mesh_view)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    history = []
    for _ in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        loss, gn = step()
        rec = {"loss": float(loss), "grad_norm": float(gn)}   # waits
        rec["step_s"] = time.perf_counter() - t0
        history.append(rec)
    warm = sorted(r["step_s"] for r in history[1:]) or [history[0]["step_s"]]
    step_s = warm[len(warm) // 2]
    flops = 3 * model.conv_flops() * batch
    summary = {"step_ms_median_warm": step_s * 1e3,
               "samples_per_s": batch / step_s,
               "conv_flops_per_step": flops,
               "fp32_tflops": flops / step_s / 1e12}
    if dev.type == "cuda":
        summary["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    tplan = step.tplan
    out = {"history": history, "model": model, "summary": summary,
           "park_info": dict(step.park_info),
           "park_plan": tplan.per_stage_park,
           "route_plan": {rt.key: ({"depth": rt.depth, "g_depth": rt.g_depth}
                                   if tplan.has_backward
                                   else {"depth": rt.depth})
                          for rt in tplan.routes}}
    if trace:
        from repro_torch.launch.profile_serve import device_profile
        out["trace"] = device_profile(step, dev)
    if world is not None:
        import torch.distributed as dist
        mine = {"park_info": out["park_info"],
                "step_s": [rec["step_s"] for rec in history]}
        if "peak_mem_gib" in summary:
            mine["peak_mem_gib"] = summary["peak_mem_gib"]
        out["ranks"] = [None] * dist.get_world_size()
        dist.all_gather_object(out["ranks"], mine)
    return out
