"""torchgpipe.balance: automatic layer -> stage partitioning.

Counterpart of :mod:`repro.core.balance`'s pure-Python part.  The paper's
``torchgpipe.balance`` profiles per-layer resource use and applies the
block-partition algorithm of Bárány & Grinberg to find a contiguous
partition with small pairwise discrepancy.  The heterogeneous models
(:mod:`repro_torch.models.unet`, :mod:`repro_torch.models.amoebanet`)
partition their layer lists with :func:`block_partition` over analytic
per-layer costs, so the port's stage bounds equal the reference's.

``block_partition`` solves the contiguous-partition minimax problem exactly
(binary search on the bottleneck value + greedy feasibility check,
O(L log sum)): the slowest stage is the pipeline's period.

The reference's ``balance_by_flops`` (per-layer costs from compiled XLA
HLO) and ``arch_layer_costs`` (the planner's analytic LM costs) serve the
planner only and have no counterpart yet (ROADMAP A12).
"""
from __future__ import annotations

from typing import List, Sequence


def _feasible(costs: Sequence[float], n: int, cap: float) -> bool:
    blocks, acc = 1, 0.0
    for c in costs:
        if c > cap:
            return False
        if acc + c > cap:
            blocks += 1
            acc = c
            if blocks > n:
                return False
        else:
            acc += c
    return True


def block_partition(costs: Sequence[float], n: int) -> List[int]:
    """Partition ``costs`` into ``n`` contiguous blocks minimizing the max
    block sum.  Returns per-block sizes (len == n, sums to len(costs)).

    Every block is non-empty when ``len(costs) >= n``; otherwise trailing
    blocks are empty (the pipeline runs them as identity stages).
    """
    costs = [float(c) for c in costs]
    if n < 1:
        raise ValueError("need n >= 1")
    if len(costs) < n:
        return [1] * len(costs) + [0] * (n - len(costs))
    lo = max(costs) if costs else 0.0
    hi = sum(costs)
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if _feasible(costs, n, mid):
            hi = mid
        else:
            lo = mid
    cap = hi * (1 + 1e-12)
    # greedy split under cap, then rebalance so no block is empty
    sizes: List[int] = []
    acc, cnt = 0.0, 0
    for c in costs:
        if acc + c > cap and cnt > 0:
            sizes.append(cnt)
            acc, cnt = c, 1
        else:
            acc += c
            cnt += 1
    sizes.append(cnt)
    while len(sizes) < n:
        # split the largest block (by cost) that has >= 2 layers
        starts = [sum(sizes[:k]) for k in range(len(sizes))]
        best, best_cost = None, -1.0
        for k, sz in enumerate(sizes):
            if sz >= 2:
                c = sum(costs[starts[k]:starts[k] + sz])
                if c > best_cost:
                    best, best_cost = k, c
        if best is None:
            sizes.append(0)
            continue
        sz = sizes[best]
        sizes[best:best + 1] = [sz // 2 + sz % 2, sz // 2]
    if len(sizes) != n or sum(sizes) != len(costs):
        raise AssertionError(f"partition {sizes} of {len(costs)} layers "
                             f"into {n} blocks")
    return sizes


def partition_bounds(sizes: Sequence[int]) -> List[int]:
    """Cumulative stage boundaries: stage j owns layers [b[j], b[j+1])."""
    out = [0]
    for s in sizes:
        out.append(out[-1] + s)
    return out


def balance_by_size(param_bytes: Sequence[int], n: int) -> List[int]:
    """Partition layers by parameter byte counts (torchgpipe balance_by_size)."""
    return block_partition(param_bytes, n)


def max_block_cost(costs: Sequence[float], sizes: Sequence[int]) -> float:
    """The slowest block's cost: the pipeline period of a partition."""
    b = partition_bounds(sizes)
    return max((sum(costs[b[j]:b[j + 1]]) for j in range(len(sizes))),
               default=0.0)
