"""pixtral-12b [vlm]: pixtral-ViT + mistral-nemo decoder; vision frontend
stubbed (precomputed patch embeddings). [hf:mistralai/Pixtral-12B-2409;
unverified]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, ParallelConfig

ARCH = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, d_ff=14336, vocab=131072,
    attn=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                         rope_theta=1000000.0),
    act="silu", norm="rms", frontend="vision_stub",
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)

# pipe 8 x tp 2: 5 layers/stage, no padding.
PARALLEL = ParallelConfig(pipe=8, tp=2)
