"""hymba-1.5b [hybrid]: parallel attention + mamba heads, 3 global-attention
layers + SWA elsewhere, ssm_state=16. [arXiv:2411.13676; hf]"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ParallelConfig,
                                SSMConfig)

ARCH = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, d_ff=5504, vocab=32001,
    attn=AttentionConfig(n_heads=25, n_kv_heads=5, head_dim=64,
                         kind="swa", window=1024,
                         global_layers=(0, 15, 31)),
    ssm=SSMConfig(state_dim=16, head_dim=64),
    act="silu", norm="rms",
    source="arXiv:2411.13676; hf",
)

# 25 heads indivisible -> pipe 16 x tp 1: 2 layers/stage, no padding.
PARALLEL = ParallelConfig(pipe=16, tp=1)
