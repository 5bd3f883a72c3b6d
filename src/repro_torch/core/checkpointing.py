"""Per-micro-batch gradient checkpointing (paper §3.2.4) as remat policies.

Counterpart of :mod:`repro.core.checkpointing`.  torchgpipe implements
checkpointing as a pair of autograd functions (``Checkpoint`` /
``Recompute``); the port wraps each per-tick stage application in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, so autograd
stores only the stage's inputs on its forward tick and re-runs the stage
forward right before that stage's backward (``F'_{i,j}`` of the paper).

Policies (``ParallelConfig.remat``):
  * ``none`` — no remat: autograd keeps whatever the stage's ops save.
  * ``full`` — the paper's setting (and the default): store only the stage
    boundary input, recompute everything in backward.
  * ``dots`` / ``dots_no_batch`` — store matmul outputs only: not ported yet
    (ROADMAP A14); they raise.
"""
from __future__ import annotations

from typing import Callable

import torch.utils.checkpoint

from repro_torch.configs.base import REMAT_POLICIES

POLICIES = REMAT_POLICIES


def wrap_stage(stage_fn: Callable, policy: str) -> Callable:
    """Wrap a per-tick stage application according to the remat policy."""
    if policy == "none":
        return stage_fn
    if policy == "full":
        def checkpointed(*args):
            return torch.utils.checkpoint.checkpoint(stage_fn, *args,
                                                     use_reentrant=False)
        return checkpointed
    if policy in ("dots", "dots_no_batch"):
        raise NotImplementedError(
            f"remat policy {policy!r} (save matmul outputs only) is not "
            "ported yet: ROADMAP A14; use 'full' or 'none'")
    raise ValueError(f"unknown remat policy {policy!r}; want one of {POLICIES}")


def wrap_stage_for_micro(stage_fn: Callable, policy: str, *, micro: int,
                         n_micro: int, remat_last_micro: bool) -> Callable:
    """Per-micro-batch wrap with the paper's §2.1 rule: the recompute of each
    stage's last micro-batch ``F'_{m,j}`` saves no memory on that stage's
    device (its activations can be kept until its backward, which comes
    first) and only slows the pipeline, so it is elided unless
    ``remat_last_micro`` forces it.  The executor wraps every forward tick
    with it; the port's default ``remat_last_micro=True`` wraps every
    micro-batch, because with all stages on one card the elided stages'
    activations add up to one micro-batch of the whole model."""
    if policy == "none":
        return stage_fn
    if micro == n_micro - 1 and not remat_last_micro:
        return stage_fn
    return wrap_stage(stage_fn, policy)
