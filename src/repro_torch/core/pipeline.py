"""GPipe forward clock-cycle executor on torch tensors (paper Algorithm 1).

Counterpart of :mod:`repro.core.pipeline` for forward-only event plans.  It
runs the SAME plan the JAX executor lowers, ``plan_for("gpipe_fwd", m, n)``
from :mod:`repro_torch.core.plan`: on tick ``t`` rank ``r`` runs the task in
``kind[t, r]`` on micro-batch ``micro[t, r]``; a boundary activation shipped
at the end of tick ``t - 1`` parks in slot ``park_recv[t, r]`` and the
consuming forward reads slot ``park_read[t, r]``.  Resident state (KV
caches) is read and updated on each rank's forward ticks, per micro-batch.

Placement follows torchgpipe: ``devices[s]`` holds stage ``s`` and the
boundary hop is ``.to(devices[s + 1])``, a no-op when every stage sits on
one card.  The whole tick loop runs in one process.

Training (``schedule="gpipe"``, paper Algorithm 1): with grad mode on, each
forward tick's stage application is wrapped by
:func:`repro_torch.core.checkpointing.wrap_stage_for_micro` under
``cfg.remat``: every micro-batch, the last one included, as the reference
wraps it, unless ``cfg.remat_last_micro`` is False (paper §2.1: each
stage's last micro-batch then runs bare).  Autograd induces the reverse
clock-cycle, recomputing each stage forward right before its backward.
Serving callers hold ``torch.inference_mode()`` themselves.
Plans with backward tasks, skip routes, stream injection or interleaved
chunks are later slices (ROADMAP A3-A6), and so are data and tensor
parallelism (A9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.core import checkpointing
from repro_torch.core import plan as plan_lib
from repro_torch.core.plan import FWD, NOP
from repro_torch.core.skip import SkipSpec
from repro_torch.devices import stage_devices
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class TickCtx:
    """Per-tick context handed to the stage function."""
    stage: int                # GLOBAL stage index
    micro: int                # micro-batch index of this rank's task
    valid: bool               # a real (scheduled) task
    t: int                    # tick counter
    fresh: Any                # stage-0 input tree slice for this micro-batch
    n_stages: int
    n_micro: int


# StageApplyFn signature:
#   stage_apply(stage_params, carry, skips_in: dict, resident, ctx: TickCtx)
#       -> (carry_out, skips_out: dict, resident_out)
# ``carry`` is None on stage 0, which reads ``ctx.fresh`` instead.
StageApplyFn = Callable[..., Tuple[Any, Dict[str, Any], Any]]


def check_single_replica(cfg: ParallelConfig) -> None:
    """The port runs one replica of one model copy: tp, data and pod 1."""
    if (cfg.tp, cfg.data, cfg.pod) != (1, 1, 1):
        raise NotImplementedError(
            f"tp={cfg.tp}, data={cfg.data}, pod={cfg.pod}: tensor and data "
            "parallelism are not ported yet (ROADMAP A9); pass tp=1, data=1, "
            "pod=1")


def _check_forward_plan(tplan: plan_lib.TaskPlan, cfg: ParallelConfig):
    if tplan.has_backward or (tplan.kind > FWD).any():
        raise NotImplementedError(
            "plans with backward tasks (gpipe_tasked / 1f1b / zb) are not "
            "ported yet: ROADMAP A3 (the port trains through gpipe_fwd with "
            "autograd)")
    if tplan.routes:
        raise NotImplementedError("skip routes / portals are not ported "
                                  "yet: ROADMAP A6")
    if cfg.stream_inputs and tplan.n_ranks > 1:
        raise NotImplementedError("stream_inputs ticks are not ported yet: "
                                  "ROADMAP A5")
    if tplan.n_chunks > 1:
        raise NotImplementedError("interleaved chunks (n_chunks > 1) are not "
                                  "ported yet: ROADMAP A5")


def run_pipeline_tasks(stage_apply: StageApplyFn,
                       stage_params,
                       inputs_mb,
                       cfg: ParallelConfig,
                       *,
                       tplan: plan_lib.TaskPlan,
                       devices: Any,
                       resident=None,
                       park_info: Optional[Dict[str, Any]] = None):
    """Execute one forward-only event plan for a mini-batch.

    ``devices`` is one device per stage (or one for all).
    ``stage_params`` and ``resident`` leaves carry a leading ``[n_stages]``
    axis, stage ``s``'s slice on ``devices[s]``; ``resident`` is updated in
    place by the stage functions.  ``inputs_mb`` leaves are ``[m, ...]``.
    Returns ``(outputs, resident)`` where ``outputs`` is a per-stage list
    holding the ``[m, ...]`` carry tree at the last stage and ``None``
    elsewhere (outputs are valid on the last rank, as in the reference).
    Pass a dict as ``park_info`` to receive ``per_stage_park``, the park
    slots each rank held at once at most in this run.  With grad mode on,
    every forward tick runs under ``cfg.remat`` (:mod:`checkpointing`).
    """
    check_single_replica(cfg)
    _check_forward_plan(tplan, cfg)
    remat = cfg.remat if torch.is_grad_enabled() else "none"
    R, m = tplan.n_ranks, tplan.n_micro
    if (R, m) != (cfg.pipe, cfg.n_micro):
        raise ValueError(f"plan is for pipe={R}, m={m}; config has "
                         f"pipe={cfg.pipe}, n_micro={cfg.n_micro}")
    devices = stage_devices(devices, R)
    resident = {} if resident is None else resident
    for leaf in tree_leaves(stage_params) + tree_leaves(resident):
        if leaf.shape[0] != R:
            raise ValueError(f"stacked leaf {tuple(leaf.shape)} does not "
                             f"lead with n_stages={R}")
    params_s = [tree_map(lambda a: a[s].to(devices[s]), stage_params)
                for s in range(R)]
    resident_s = [tree_map(lambda a: a[s], resident) for s in range(R)]
    for s in range(R):
        for leaf in tree_leaves(resident_s[s]):
            if leaf.device != devices[s]:
                raise ValueError(f"resident state of stage {s} lives on "
                                 f"{leaf.device}, stage on {devices[s]}")

    park: List[Dict[int, Any]] = [{} for _ in range(R)]
    high = [0] * R
    shipped: List[Any] = [None] * R       # each rank's boundary output, last tick
    outputs: List[Any] = [None] * m
    for t in range(tplan.n_ticks):
        # 1. arrivals: the previous tick's boundary outputs park in their slots
        for r in range(R):
            slot = int(tplan.park_recv[t, r])
            if slot < 0:
                continue
            if r == 0 or shipped[r - 1] is None:
                raise RuntimeError(f"tick {t}: rank {r} expects an arrival "
                                   f"that rank {r - 1} did not ship")
            park[r][slot] = tree_map(lambda a: a.to(devices[r]),
                                     shipped[r - 1])
            high[r] = max(high[r], len(park[r]))
        # 2. each rank runs at most one task
        sent: List[Any] = [None] * R
        for r in range(R):
            kind = int(tplan.kind[t, r])
            if kind == NOP:
                continue
            i = int(tplan.micro[t, r])
            slot = int(tplan.park_read[t, r])
            carry = park[r].pop(slot) if slot >= 0 else None
            fresh = tree_map(lambda a: a[i].to(devices[r]), inputs_mb)
            ctx = TickCtx(stage=r, micro=i, valid=True, t=t, fresh=fresh,
                          n_stages=tplan.n_stages, n_micro=m)
            wrapped = checkpointing.wrap_stage_for_micro(
                lambda p, c, si, rr, ctx=ctx: stage_apply(p, c, si, rr, ctx),
                remat, micro=i, n_micro=m,
                remat_last_micro=cfg.remat_last_micro)
            carry_out, skips_out, resident_s[r] = wrapped(
                params_s[r], carry, {}, resident_s[r])
            if skips_out:
                raise NotImplementedError("skip outputs need skip routes: "
                                          "ROADMAP A6")
            if r == R - 1:
                outputs[i] = carry_out
            else:
                sent[r] = carry_out
        shipped = sent
    if any(p for p in park):
        raise RuntimeError("park slots still hold values after the last tick")
    if park_info is not None:
        park_info["per_stage_park"] = tuple(high)
    stacked = tree_map(lambda *xs: torch.stack(xs), *outputs)
    return [None] * (R - 1) + [stacked], resident


def run_pipeline(stage_apply: StageApplyFn,
                 stage_params,
                 inputs_mb,
                 cfg: ParallelConfig,
                 *,
                 devices: Any,
                 skips: Sequence[SkipSpec] = (),
                 resident=None,
                 park_info: Optional[Dict[str, Any]] = None):
    """Lower the GPipe clock-cycle plan and run it."""
    tplan = plan_lib.plan_for("gpipe_fwd", cfg.n_micro, cfg.pipe,
                              skips=skips, portals=cfg.portals,
                              wire=cfg.wire)
    return run_pipeline_tasks(stage_apply, stage_params, inputs_mb, cfg,
                              tplan=tplan, devices=devices,
                              resident=resident, park_info=park_info)


def pipeline_call(stage_apply: StageApplyFn,
                  *,
                  cfg: ParallelConfig,
                  devices: Any = "cuda",
                  skips: Sequence[SkipSpec] = (),
                  park_info: Optional[Dict[str, Any]] = None):
    """Build ``(stage_params, inputs_mb, resident) -> (outputs, resident)``.

    ``devices`` is one device per stage (or one device for all).  Forward
    execution always runs the GPipe clock-cycle plan; the plan is lowered
    once here.  ``outputs[-1]`` is the last stage's ``[m, ...]`` collection
    (:func:`last_stage_output`).  The call is differentiable: under grad
    mode autograd records the clock-cycle and its backward is the reverse
    one, with each stage recomputed under ``cfg.remat``.
    """
    check_single_replica(cfg)
    if cfg.virtual_stages > 1:
        raise ValueError("interleaved schedules are train-only; forward "
                         "execution runs the clock-cycle plan")
    tplan = plan_lib.plan_for("gpipe_fwd", cfg.n_micro, cfg.pipe,
                              skips=skips, portals=cfg.portals, wire=cfg.wire)
    _check_forward_plan(tplan, cfg)

    def call(stage_params, inputs_mb, resident=None):
        return run_pipeline_tasks(stage_apply, stage_params, inputs_mb, cfg,
                                  tplan=tplan, devices=devices,
                                  resident=resident, park_info=park_info)

    call.tplan = tplan
    return call


def pipeline_grad_call(*args, **kwargs):
    """The fused scheduler's entry point (backward tasks inside the tick
    loop): not ported yet."""
    raise NotImplementedError(
        "pipeline_grad_call (fused F+B schedules gpipe_tasked / 1f1b / "
        "interleaved / zb) is not ported yet: ROADMAP A3; schedule='gpipe' "
        "trains through pipeline_call and autograd")


def last_stage_output(outputs):
    """The last stage's collected outputs: an ``[m, ...]`` tree."""
    return outputs[-1]


def microbatch(tree, n_micro: int):
    """Split leading batch dim B -> [n_micro, B // n_micro, ...]."""
    def f(a):
        b = a.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
        return a.reshape((n_micro, b // n_micro) + tuple(a.shape[1:]))
    return tree_map(f, tree)


def unmicrobatch(tree):
    return tree_map(
        lambda a: a.reshape((a.shape[0] * a.shape[1],) + tuple(a.shape[2:])),
        tree)
