"""deepseek-7b [dense]: llama-arch, MHA. [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, ParallelConfig

ARCH = ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, d_ff=11008, vocab=102400,
    attn=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=128),
    act="silu", norm="rms",
    source="arXiv:2401.02954; hf",
)

# pipe 16 x tp 1: 30 -> 2/stage with 2 identity-pad layers.
PARALLEL = ParallelConfig(pipe=16, tp=1)

# §Perf-hillclimbed variant (EXPERIMENTS.md §4-A): ZeRO-1-style per-step
# weight gathering + pipe-sharded input streaming; roofline 0.156 -> 0.240.
PARALLEL_OPTIMIZED = PARALLEL.with_(gather_weights_once=True,
                                    stream_inputs=True)
