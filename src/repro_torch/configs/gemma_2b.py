"""gemma-2b [dense]: GeGLU, head_dim=256, MQA. [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, ParallelConfig

ARCH = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, d_ff=16384, vocab=256000,
    attn=AttentionConfig(n_heads=8, n_kv_heads=1, head_dim=256),
    act="geglu", norm="rms", tie_embeddings=True, embed_scale=True,
    source="arXiv:2403.08295; hf",
)

# 18 layers: pipe 2 x tp 8 gives 9 layers/stage with zero padding; MQA kv
# head replicates under tp.
PARALLEL = ParallelConfig(pipe=2, tp=8)
