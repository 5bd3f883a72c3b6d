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
  * ``dots`` — store the outputs of the matrix products only
    (``jax.checkpoint_policies.checkpoint_dots``): the backward's recompute
    runs the elementwise ops again and reads each product from the store.
  * ``dots_no_batch`` — store only the products without batch dimensions
    (``checkpoint_dots_with_no_batch_dims``).

How the two packages spell a product decides the mapping, op by op.  The
reference's ``x[B, S, D] @ w[D, F]`` is a ``dot_general`` with no batch
dimension; the port's ``@`` / ``F.linear`` on a 3-d activation reaches the
dispatcher as ``aten.mm`` on ``[B·S, D]`` (``aten.addmm`` with a bias).  The
reference's ``einsum("bhqd,bhkd->bhqk")`` (the plain attention, the plain
WKV recurrence) has batch dimensions; the port's einsum reaches it as
``aten.bmm`` (``aten.baddbmm`` when it accumulates).  So:

  ========================  ==========================================
  reference policy          port: outputs kept (``DOT_OPS``)
  ========================  ==========================================
  ``checkpoint_dots``       ``aten.mm``, ``aten.addmm``, ``aten.bmm``,
                            ``aten.baddbmm``
  ``..._no_batch_dims``     ``aten.mm``, ``aten.addmm``
  ========================  ==========================================

A hand-written kernel (attention, RMSNorm, WKV-6 on the card) is a ctypes
call that no dispatcher op sees, so its outputs are recomputed under both
policies, as the reference's ``pallas_call`` outputs are not dots.  On the
CPU the kernels' plain versions run as torch ops: ``dots`` keeps the plain
attention's ``bmm`` outputs there and ``dots_no_batch`` does not.  A region
checkpointed ``full`` inside a selective one (``remat_layers``, the head's
loss chunks) keeps nothing, as a nested ``jax.checkpoint`` under an outer
policy does: its ops are neither stored nor replayed.

The selection is the port's own (:class:`Selection`), built on the public
``TorchDispatchMode`` / ``context_fn`` interface of
``torch.utils.checkpoint``.  Its forward mode stores each kept op's output
in forward order; its recompute mode replays them by that order on every
recompute of the region and never pops them, so a region's graph can be
differentiated twice (below).  PyTorch's own selective checkpoint spends
its cache on the first recompute and refuses the second backward.

Split-backward residual handling (``ParallelConfig.residuals``) crosses with
the policy, as in the reference: under ``residuals="reuse"`` the fused
executor's Bx tick builds the stage graph through the policy-wrapped
function and keeps it until the Bw tick, so the policy decides what the
graph holds.  ``none`` keeps every activation the weight gradient needs (Bw
runs no forward); ``dots`` keeps the stage inputs and the products, and
both Bx's and Bw's backward recompute only the rest; ``full`` keeps only
the stage inputs, which are parked anyway, so Bw recomputes the stage
inside its backward: recompute semantics.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List

import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import REMAT_POLICIES, RESIDUAL_MODES

POLICIES = REMAT_POLICIES

_aten = torch.ops.aten
DOT_OPS = {
    "dots": frozenset((_aten.mm.default, _aten.addmm.default,
                       _aten.bmm.default, _aten.baddbmm.default)),
    "dots_no_batch": frozenset((_aten.mm.default, _aten.addmm.default)),
}

# depth of "full" regions entered on this thread: inside one, a selection
# neither stores nor replays (module docstring)
_opaque = threading.local()


def _in_opaque() -> bool:
    return getattr(_opaque, "depth", 0) > 0


class Selection:
    """What one checkpointed call of a selective policy keeps: the output of
    each op of ``ops``, by op, in forward order (``saved``), with its
    version counter at the time.  :meth:`contexts` is the ``context_fn``
    pair: a forward mode that stores, and a recompute mode that replays the
    stored outputs by their order on every recompute."""

    def __init__(self, ops):
        self.ops = ops
        self.saved: Dict[object, List] = {}

    def contexts(self):
        return _Store(self), _Replay(self)


class _Store(TorchDispatchMode):
    def __init__(self, sel: Selection):
        super().__init__()
        self.sel = sel

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.sel.ops and not _in_opaque():
            kept = out.detach()
            self.sel.saved.setdefault(func, []).append((kept, kept._version))
        return out


class _Replay(TorchDispatchMode):
    def __init__(self, sel: Selection):
        super().__init__()
        self.sel = sel
        self.count: Dict[object, int] = {}

    def __enter__(self):
        self.count = {}            # each recompute replays from the start
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in self.sel.ops or _in_opaque():
            return func(*args, **(kwargs or {}))
        i = self.count.get(func, 0)
        self.count[func] = i + 1
        runs = self.sel.saved.get(func, ())
        if i >= len(runs):
            raise RuntimeError(f"selective remat: the recompute ran {func} "
                               f"more often than the forward ({len(runs)})")
        kept, version = runs[i]
        if kept._version != version:
            raise RuntimeError(f"selective remat: the stored output of {func}"
                               " was changed in place after the forward")
        return kept.detach()


def check_policy(policy: str) -> None:
    """Raise for a policy the port does not know."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; "
                         f"want one of {POLICIES}")


def wrap_stage(stage_fn: Callable, policy: str) -> Callable:
    """Wrap a per-tick stage application according to the remat policy."""
    check_policy(policy)
    if policy == "none":
        return stage_fn
    if policy == "full":
        def opaque(*args):
            _opaque.depth = getattr(_opaque, "depth", 0) + 1
            try:
                return stage_fn(*args)
            finally:
                _opaque.depth -= 1

        def checkpointed(*args):
            return torch.utils.checkpoint.checkpoint(opaque, *args,
                                                     use_reentrant=False)
        return checkpointed
    ops = DOT_OPS[policy]

    def selective(*args):
        return torch.utils.checkpoint.checkpoint(
            stage_fn, *args, use_reentrant=False,
            context_fn=Selection(ops).contexts)
    return selective


def wrap_for_residuals(fn: Callable, policy: str, residuals: str) -> Callable:
    """Wrap the function the fused executor differentiates on a backward
    tick.  ``"recompute"`` leaves ``fn`` bare: each backward tick rebuilds
    its graph and drops it.  ``"reuse"`` wraps it by the policy, since the
    Bx tick's graph is the residual stash the Bw tick reads (module
    docstring)."""
    if residuals not in RESIDUAL_MODES:
        raise ValueError(f"unknown residuals mode {residuals!r}; "
                         f"want one of {RESIDUAL_MODES}")
    if residuals == "recompute":
        return fn
    return wrap_stage(fn, policy)


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
