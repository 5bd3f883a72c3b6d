"""Native optimizers: AdamW, SGD + momentum, global-norm clipping, warmup +
cosine schedule, the non-finite step guard and dynamic loss scaling.

Counterpart of :mod:`repro.optim.optimizers`.  Optimizer state mirrors the
parameter tree leaf for leaf (nested dicts of tensors on the parameters'
device); master weights and moments are fp32 whatever the parameter dtype.
Every value-dependent decision (the finiteness flag, the loss-scale update)
is a 0-d tensor consumed by ``torch.where``, so a step never waits on the
host.  ``OptState.ef`` holds the int8 error-feedback residual of DP
gradient compression (``grad_compression="int8_ef"``,
:mod:`repro_torch.runtime.compression`) when the state is built
``with_ef``; :func:`apply` carries it through untouched.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor       # int32 scalar: applied steps
    mu: Any                  # first moment (fp32), tree like params
    nu: Any                  # second moment (fp32); zeros for sgd
    master: Any              # fp32 master copy of params
    skipped: torch.Tensor    # int32 scalar: steps skipped by the guard
    good: torch.Tensor       # int32 scalar: consecutive finite steps
    scale: torch.Tensor      # fp32 scalar: current loss scale (1 if static)
    ef: Any = ()             # int8-EF gradient-compression residuals (fp32,
    #                          tree like params), or () without compression


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"          # adamw | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    momentum: float = 0.9        # sgd
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # Non-finite step guard: when any grad leaf (or the loss) is NaN/inf the
    # whole update is discarded (torch.where on one flag: params and every
    # moment stay bitwise unchanged) and the skip counter increments.
    skip_nonfinite: bool = True
    # AMP-style dynamic loss scaling: the caller multiplies the loss by
    # ``state.scale`` before autograd; grads are unscaled here after the
    # overflow check.  Overflow halves the scale (floored at min),
    # ``loss_scale_growth`` consecutive finite steps double it.
    dynamic_loss_scale: bool = False
    init_loss_scale: float = 2.0 ** 15
    loss_scale_factor: float = 2.0
    loss_scale_growth: int = 200
    min_loss_scale: float = 1.0


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio`` (fp32)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def _sum_sq(leaves) -> torch.Tensor:
    """Sum of squares over an iterable of tensors, in fp32 in order."""
    sums = [torch.sum(torch.square(leaf.float())) for leaf in leaves]
    if not sums:
        return torch.zeros(())
    return functools.reduce(torch.add, sums)


def _norm(leaves) -> torch.Tensor:
    """L2 norm over an iterable of tensors, summed in fp32 in order."""
    return torch.sqrt(_sum_sq(leaves))


def _over_group(group, x: torch.Tensor, op) -> torch.Tensor:
    """``op``-fold of every rank's 0-d ``x`` in rank order over ``group``
    (a pipe group, or a mesh axis): the same bits on every rank (gathered
    through the host: gloo)."""
    if group.size == 1:
        return x
    import torch.distributed as dist
    host = x.detach().reshape(1).cpu()
    parts = [torch.empty_like(host) for _ in range(group.size)]
    dist.all_gather(parts, host, group=group.group)
    return functools.reduce(op, parts)[0].to(x.device)


def global_norm(tree) -> torch.Tensor:
    return _norm(tree_leaves(tree))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


def init(cfg: OptimizerConfig, params, *, with_ef: bool = False) -> OptState:
    """fp32 master weights, zero moments and guard counters on the params'
    device; ``with_ef`` adds the zero error-feedback residual that
    ``grad_compression="int8_ef"`` needs."""
    dev = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=dev)
    scale0 = cfg.init_loss_scale if cfg.dynamic_loss_scale else 1.0
    i32 = dict(dtype=torch.int32, device=dev)
    return OptState(step=torch.zeros((), **i32),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    master=tree_map(lambda p: p.detach().float().clone(),
                                    params),
                    skipped=torch.zeros((), **i32),
                    good=torch.zeros((), **i32),
                    scale=torch.tensor(scale0, dtype=torch.float32,
                                       device=dev),
                    ef=tree_map(zeros, params) if with_ef else ())


def _all_finite(grads, loss=None) -> torch.Tensor:
    """0-d bool: every grad element (and the loss, if given) is finite."""
    flags = [torch.isfinite(g).all() for g in tree_leaves(grads)]
    if loss is not None:
        flags.append(torch.isfinite(loss).all())
    return functools.reduce(torch.logical_and, flags)


def apply(cfg: OptimizerConfig, state: OptState, params, grads, *,
          loss: Optional[torch.Tensor] = None, group=None,
          norm_terms: Optional[Sequence[Optional[torch.Tensor]]] = None,
          replica_group=None) -> Tuple[Any, OptState, dict]:
    """One optimizer step.  Returns (params, new_state, metrics).

    Params, master weights and moments are updated in place, one leaf at a
    time, so only one leaf's temporaries are alive beside the state; the
    returned ``params`` and the returned state's trees are the tensors
    passed in.  With ``cfg.skip_nonfinite`` (the default) or dynamic loss
    scaling the update is gated on one finiteness flag over the raw grads
    (and ``loss``, when the caller passes it): a non-finite step leaves
    params and every state tensor bitwise unchanged and increments
    ``state.skipped``.  With ``cfg.dynamic_loss_scale`` the incoming grads
    (and ``loss``) are scaled by ``state.scale``; overflow is detected on
    the scaled grads, which are then unscaled before clipping and the
    moments.

    The global norm folds, in order, the fp32 sums of squares of
    ``norm_terms`` (by default every leaf of ``grads``).  Across processes
    each rank passes its share of the params and grads, and its terms of
    one model copy: a term another replica computes is None here (0), and
    over ``replica_group`` (a mesh axis) the replicas' terms are added
    (exact: each is computed on one replica alone); the rank's fold is
    then summed over ``group`` (a pipe group, or the ranks of one model
    copy) in rank order.  The finiteness flag is the AND over both groups,
    so all ranks clip by one scale and skip or take a step together.  The
    norm then sums in another order than one process does."""
    if cfg.name not in ("adamw", "sgd"):
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    with torch.no_grad():
        return _apply(cfg, state, params, grads, loss, group, norm_terms,
                      replica_group)


def _apply(cfg, state, params, grads, loss, group=None, norm_terms=None,
           replica_group=None):
    dyn = cfg.dynamic_loss_scale
    finite = (_all_finite(grads, loss) if cfg.skip_nonfinite or dyn
              else None)
    if finite is not None:
        for g in (replica_group, group):
            if g is not None:
                finite = _over_group(g, finite.to(torch.int32),
                                     torch.minimum) > 0
    inv = 1.0 / state.scale if dyn else None

    def unscaled(g):
        g = g.float()
        return g * inv if dyn else g

    leaves = list(zip(tree_leaves(params), tree_leaves(grads),
                      tree_leaves(state.mu), tree_leaves(state.nu),
                      tree_leaves(state.master)))
    terms = tree_leaves(grads) if norm_terms is None else norm_terms
    zero = torch.zeros((), device=tree_leaves(grads)[0].device)
    sums = [zero if t is None else torch.sum(torch.square(unscaled(t)))
            for t in terms]
    if replica_group is not None and replica_group.size > 1 and sums:
        sums = list(replica_group.sum(torch.stack(sums), "norm").unbind())
    sq = functools.reduce(torch.add, sums) if sums else zero
    gn = torch.sqrt(sq if group is None else _over_group(group, sq,
                                                          torch.add))
    clip = _clip_scale(gn, cfg.clip_norm) if cfg.clip_norm > 0 else None
    step = state.step + 1
    lr = schedule(cfg, step)
    c1 = 1 - cfg.b1 ** step.float()
    c2 = 1 - cfg.b2 ** step.float()

    def commit(dst, new):
        # a skipped step writes back the old bits: bitwise a no-op
        dst.copy_(new if finite is None else torch.where(finite, new, dst))

    for p, g, m, v, p32 in leaves:
        g = unscaled(g)
        if clip is not None:
            g = g * clip
        if cfg.name == "adamw":
            m_new = cfg.b1 * m + (1 - cfg.b1) * g
            v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
            p32_new = p32 - lr * ((m_new / c1)
                                  / (torch.sqrt(v_new / c2) + cfg.eps)
                                  + cfg.weight_decay * p32)
            commit(v, v_new)
        else:
            m_new = cfg.momentum * m + g
            p32_new = p32 - lr * (m_new + cfg.weight_decay * p32)
        commit(m, m_new)
        commit(p, p32_new.to(p.dtype))
        commit(p32, p32_new)

    if finite is None:
        return params, state._replace(step=step), {"grad_norm": gn, "lr": lr}
    step = torch.where(finite, step, state.step)
    skipped = state.skipped + (~finite).to(torch.int32)
    good = torch.where(finite, state.good + 1, 0).to(torch.int32)
    scale = state.scale
    if dyn:
        grown = good >= cfg.loss_scale_growth
        scale_ok = torch.where(grown, state.scale * cfg.loss_scale_factor,
                               state.scale)
        good = torch.where(grown, 0, good).to(torch.int32)
        scale_bad = torch.clamp(state.scale / cfg.loss_scale_factor,
                                min=cfg.min_loss_scale)
        scale = torch.where(finite, scale_ok, scale_bad)
    new_state = state._replace(step=step, skipped=skipped, good=good,
                               scale=scale)
    metrics = {"grad_norm": torch.where(finite, gn, 0.0), "lr": lr,
               "finite": finite.float(), "skipped": skipped,
               "loss_scale": state.scale}
    return params, new_state, metrics
