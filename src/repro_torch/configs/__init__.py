"""Architecture registry: full assigned configs + reduced smoke variants."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.configs.base import (ALL_SHAPES, SHAPES_BY_NAME, ArchConfig, Cell,
                                ParallelConfig, ShapeConfig)

_MODULES = {
    "whisper-tiny": "whisper_tiny",
    "smollm-360m": "smollm_360m",
    "gemma-2b": "gemma_2b",
    "llama3-405b": "llama3_405b",
    "deepseek-7b": "deepseek_7b",
    "rwkv6-1.6b": "rwkv6_1b6",
    "dbrx-132b": "dbrx_132b",
    "mixtral-8x7b": "mixtral_8x7b",
    "pixtral-12b": "pixtral_12b",
    "hymba-1.5b": "hymba_1b5",
}

ARCH_NAMES: List[str] = list(_MODULES)

# long_500k requires sub-quadratic decode state: SSM (rwkv6), hybrid
# SSM+SWA (hymba), or uniform SWA (mixtral).  Pure full-attention archs are
# skipped per assignment (DESIGN.md §3/§4).
SUBQUADRATIC = {"rwkv6-1.6b", "hymba-1.5b", "mixtral-8x7b"}


def get_arch(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.ARCH


def get_parallel(name: str, *, optimized: bool = False) -> ParallelConfig:
    """Arch's production layout; ``optimized=True`` selects the §Perf-
    hillclimbed variant where one exists (EXPERIMENTS.md §4)."""
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    if optimized and hasattr(mod, "PARALLEL_OPTIMIZED"):
        return mod.PARALLEL_OPTIMIZED
    return mod.PARALLEL


def shape_applies(arch: ArchConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return arch.name in SUBQUADRATIC
    return True


def derive_n_micro(shape: ShapeConfig, pcfg: ParallelConfig,
                   target_ratio: int = 4) -> int:
    """Largest m with: B % m == 0, (B/m) % dp == 0, m <= target_ratio*pipe.

    GPipe wants m >> n for small bubbles; the global micro-batch must still
    shard over the (pod, data) axes.
    """
    dp = pcfg.data * pcfg.pod * pcfg.dp2
    B = shape.global_batch
    best = 1
    for m in range(1, min(B, target_ratio * pcfg.pipe) + 1):
        if B % m == 0 and (B // m) % dp == 0:
            best = m
    return best


def cells_for(name: str, *, multi_pod: bool = False) -> List[Cell]:
    arch = get_arch(name)
    pcfg = get_parallel(name)
    pcfg = pcfg.with_(pod=2 if multi_pod else 1)
    out = []
    for shape in ALL_SHAPES:
        if not shape_applies(arch, shape):
            continue
        m = derive_n_micro(shape, pcfg)
        out.append(Cell(arch, shape, pcfg.with_(n_micro=m)))
    return out


def all_cells(*, multi_pod: bool = False) -> List[Cell]:
    return [c for n in ARCH_NAMES for c in cells_for(n, multi_pod=multi_pod)]


# ---------------------------------------------------------------------------
# Reduced smoke configs: same family/topology, tiny dims — run on 1 CPU dev.
# ---------------------------------------------------------------------------

def smoke_arch(name: str) -> ArchConfig:
    a = get_arch(name)
    kw = dict(
        n_layers=min(a.n_layers, 4), d_model=64, d_ff=128, vocab=256,
        enc_layers=min(a.enc_layers, 2) if a.enc_layers else 0,
    )
    if a.attn is not None:
        heads = 4 if a.attn.n_heads % 2 == 0 else 3
        kv = max(1, heads // 2) if a.attn.n_kv_heads < a.attn.n_heads else heads
        gl = tuple(g for g in ((0, 2) if a.attn.global_layers else ())
                   if g < kw["n_layers"])
        kw["attn"] = dataclasses.replace(
            a.attn, n_heads=heads, n_kv_heads=kv, head_dim=16,
            window=min(a.attn.window, 8) if a.attn.window else 0,
            global_layers=gl)
    if a.moe is not None:
        # capacity_factor high enough that no token is ever dropped: capacity
        # dropping depends on the dispatch-group size, which micro-batching
        # changes (the MoE analogue of the paper's §2 BatchNorm caveat) — the
        # equivalence tests need routing to be exact.
        kw["moe"] = dataclasses.replace(a.moe, n_experts=4, top_k=2,
                                        capacity_factor=8.0)
    if a.ssm is not None:
        kw["ssm"] = dataclasses.replace(a.ssm, head_dim=16, state_dim=4)
    return dataclasses.replace(a, **kw)


def smoke_parallel(name: str) -> ParallelConfig:
    return ParallelConfig(pipe=1, tp=1, data=1, pod=1, n_micro=2)
