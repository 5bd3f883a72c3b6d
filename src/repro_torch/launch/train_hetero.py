"""Training entry point for the heterogeneous pipelines: U-Net and
AmoebaNet-D (paper §4.2) through the GPipe clock-cycle (autograd backward)
or the fused F+B scheduler, with skip routes for U-Net's crossing skips.

A model trains from random weights on one fixed seeded batch against a
seeded random target (MSE), with SGD and momentum 0.9 at a constant lr, in
fp32 (the program turns TF32 off while it runs:
``pipeline_hetero.fp32_math``).  All stages sit on one device.
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


def build_train_step(mcfg: ModelConfig, pcfg: ParallelConfig, *, batch: int,
                     device="cuda", seed: int = 0,
                     ocfg: Optional[optim.OptimizerConfig] = None):
    """The model (``n_stages = pcfg.pipe * pcfg.virtual_stages``), random
    weights, one fixed batch and target from ``seed``, and its train step:
    ``(model, step)`` with ``step() -> (loss, grad_norm)`` updating the
    weights and SGD state in place.  ``step.tplan`` is the plan and
    ``step.park_info`` the executor's buffer and route high-water of the
    last step."""
    dev = resolve_device(device)
    ocfg = ocfg or sgd(0.01)
    cls = UNetModel if isinstance(mcfg, UNetConfig) else AmoebaNetModel
    model = cls(mcfg, pcfg.pipe * pcfg.virtual_stages)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    prog = PH.build_hetero_program(model, params, pcfg, dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn(batch, mcfg.in_ch, mcfg.img, mcfg.img, generator=g,
                    device=dev)
    y = torch.randn(target_shape(mcfg, batch), generator=g, device=dev)
    tree = dict(enumerate(prog.stage_params))       # updated in place
    state = [optim.init(ocfg, tree)]
    info: Dict[str, Any] = {}
    call = PH.hetero_grad_call(prog, pcfg, info)

    def step():
        loss, grads = call(prog.stage_params, x, y)
        _, state[0], metrics = optim.apply(ocfg, state[0], tree,
                                           dict(enumerate(grads)),
                                           loss=loss)
        return loss, metrics["grad_norm"]

    step.tplan, step.park_info = call.tplan, info
    return model, step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_hetero(mcfg: ModelConfig, pcfg: ParallelConfig, *, batch: int,
                 steps: int, device="cuda", seed: int = 0,
                 ocfg: Optional[optim.OptimizerConfig] = None,
                 trace: bool = False) -> Dict[str, Any]:
    """Train ``steps`` steps on one fixed batch.  Returns one record per
    step (loss, grad norm, ``step_s`` on the host clock around the
    synchronized step), the buffer and route high-water of the last step
    and the plan's, and ``summary``: the median step of steps 2..n (step 1
    alone if there is one), its samples/s, the counted conv FLOPs of a step
    (3 x the forward's, ``model.conv_flops``; the recompute not counted)
    and their rate, and on a card the peak memory from the first step on.
    ``trace`` (a card only) runs one more step under the profiler
    (:func:`profile_serve.device_profile`); it is not in ``history``."""
    dev = resolve_device(device)
    if trace and dev.type != "cuda":
        raise ValueError("trace profiles the card: pass a CUDA device")
    model, step = build_train_step(mcfg, pcfg, batch=batch, device=dev,
                                   seed=seed, ocfg=ocfg)
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
    return out
