"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, MoEConfig, ParallelConfig

ARCH = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, d_ff=14336, vocab=32000,
    attn=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                         kind="swa", window=4096),
    moe=MoEConfig(n_experts=8, top_k=2),
    act="silu", norm="rms",
    source="arXiv:2401.04088; hf",
)

# pipe 8 x tp 2: 4 layers/stage; experts EP-sharded over tp (4/shard).
# SWA => bounded window cache => long_500k decode applies.
PARALLEL = ParallelConfig(pipe=8, tp=2)
