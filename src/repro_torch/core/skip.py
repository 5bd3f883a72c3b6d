"""Skip connections across pipeline stages — the paper's §3.3 "portals".

A tensor produced at stage ``src`` and consumed at stage ``dst > src + 1``
breaks the pure-sequential assumption.  torchgpipe offers two behaviours,
both of which lower to static transfer ROUTES in the unified schedule plan
(:func:`repro_torch.core.plan.lower_tasks`; executed by
:func:`repro_torch.core.pipeline.run_pipeline_tasks`):

* **threaded** (the symptomatic §3.3 case): the tensor is relayed hop-by-hop
  through every intermediate stage — each relay rank parks the arriving
  value and re-sends it on its own F tick, so the intermediate devices
  spend memory bandwidth and a ``collective-permute`` hop on it (the cost
  the ablation benchmark measures).

* **portals** (§3.3.1, PortalBlue/Orange/Copy): the tensor is sent
  *directly* from ``src`` to ``dst`` with a dedicated single-pair
  ``collective-permute([(src, dst)])`` at the production tick.  The
  destination parks it in a plan-allocated buffer slot until the owning
  micro-batch's forward consumes it; intermediate *stages* spend no memory
  bandwidth or kernel time on the tensor (on a physical ring the bits still
  traverse intermediate links, exactly as they traverse PCIe switches in
  the paper's setting — the win is freeing the intermediate devices, not
  the wires).

Timing invariant (proved by ``tests/test_skip.py`` host-side): the value
for micro-batch ``i`` is produced at ``src`` during ``F(i, src)``'s tick
and consumed at ``dst`` during ``F(i, dst)``'s tick, so on the forward
wavefront at most ``SkipSpec.depth(dst) = dst - src`` values are parked at
once — the legacy rotating-ring depth, now an allocator output instead of
an assumption.  Under fused F+B schedules the destination keeps the value
parked until ``B(i, dst)``'s recompute, and a mirrored reverse route
carries the skip cotangent back to seed ``B(i, src)``.

Multi-consumer skips (e.g. whisper's encoder memory feeding every decoder
stage) lower to one route per destination; their backward cotangents sum
at the producer in fixed route order, keeping gradients bitwise-stable
across schedules.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class SkipSpec:
    """One skip value, produced at ``src_stage``, consumed at ``dsts``."""
    name: str
    src_stage: int
    dsts: Tuple[int, ...]

    def __post_init__(self):
        if not self.dsts:
            raise ValueError(f"skip {self.name}: needs at least one dst")
        for d in self.dsts:
            if d <= self.src_stage:
                raise ValueError(f"skip {self.name}: dst {d} must be > src "
                                 f"{self.src_stage}")

    def depth(self, dst: int) -> int:
        return dst - self.src_stage


def crossing_skips(layers: Sequence, bounds: Sequence[int]) -> List[SkipSpec]:
    """The edges of a layer-list model partitioned at ``bounds``: one for
    each skip that a layer of one stage produces (``skip_out``) and a layer
    of a later stage consumes (``skip_in``), in the consuming layers'
    order.  A skip produced and consumed within one stage is no edge."""
    stage_of = [s for s in range(len(bounds) - 1)
                for _ in range(bounds[s], bounds[s + 1])]
    produced: Dict[str, int] = {}
    edges = []
    for i, l in enumerate(layers):
        name = getattr(l, "skip_in", None)
        if name in produced and stage_of[i] > produced[name]:
            edges.append(SkipSpec(name, produced[name], (stage_of[i],)))
        if getattr(l, "skip_out", None):
            produced[l.skip_out] = stage_of[i]
    return edges
