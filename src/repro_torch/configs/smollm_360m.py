"""smollm-360m [dense]: llama-arch small. [hf:HuggingFaceTB/SmolLM-360M; hf]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, ParallelConfig

ARCH = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, d_ff=2560, vocab=49152,
    attn=AttentionConfig(n_heads=15, n_kv_heads=5, head_dim=64),
    act="silu", norm="rms", tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-360M; hf",
)

# 15 heads are indivisible by any tp in {2,4,8,16} -> pipe 16 x tp 1.
PARALLEL = ParallelConfig(pipe=16, tp=1)
