"""whisper-tiny [audio]: enc-dec, conv frontend stubbed (precomputed frame
embeddings).  [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig, AttentionConfig, ParallelConfig

ARCH = ArchConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, enc_layers=4,              # 4 decoder + 4 encoder blocks
    d_model=384, d_ff=1536, vocab=51865,
    attn=AttentionConfig(n_heads=6, n_kv_heads=6, head_dim=64,
                         use_rope=False),  # whisper: abs. positions
    act="gelu", norm="ln", frontend="audio_stub",
    source="arXiv:2212.04356; unverified",
)

# model axis 16 = pipe 8 x tp 2: 1 block/stage, no padding; encoder output
# reaches decoder stages via portals.
PARALLEL = ParallelConfig(pipe=8, tp=2)

# §Perf-hillclimbed variant (EXPERIMENTS.md §4-B): surplus model-axis
# capacity folded into extra data parallelism; roofline 0.007 -> 0.068.
PARALLEL_OPTIMIZED = PARALLEL.with_(dp2=4, pipe=2, tp=2,
                                    gather_weights_once=True,
                                    stream_inputs=True)
