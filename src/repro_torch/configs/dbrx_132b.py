"""dbrx-132b [moe]: 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, MoEConfig, ParallelConfig

ARCH = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, d_ff=10752, vocab=100352,
    attn=AttentionConfig(n_heads=48, n_kv_heads=8, head_dim=128),
    moe=MoEConfig(n_experts=16, top_k=4),
    act="silu", norm="rms",
    source="hf:databricks/dbrx-base; unverified",
)

# pipe 8 x tp 2: 5 layers/stage; experts EP-sharded over tp (8/shard).
PARALLEL = ParallelConfig(pipe=8, tp=2)
