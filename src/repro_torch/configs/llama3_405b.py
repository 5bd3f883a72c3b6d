"""llama3-405b [dense]: GQA, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, ParallelConfig

ARCH = ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, d_ff=53248, vocab=128256,
    attn=AttentionConfig(n_heads=128, n_kv_heads=8, head_dim=128,
                         rope_theta=500000.0),
    act="silu", norm="rms",
    source="arXiv:2407.21783; unverified",
)

# pipe 4 x tp 4: 126 -> 32/stage with 2 identity-pad layers (1.6% FLOPs).
PARALLEL = ParallelConfig(pipe=4, tp=4)

# §Perf-hillclimbed variant (EXPERIMENTS.md §4-C): nested per-layer remat
# (-49% memory/device) + input streaming.
PARALLEL_OPTIMIZED = PARALLEL.with_(remat_layers=True, stream_inputs=True)
