"""rwkv6-1.6b [ssm]: Finch, attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ArchConfig, ParallelConfig

ARCH = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, d_ff=7168, vocab=65536,
    attn=None, act="silu", norm="ln",
    source="arXiv:2404.05892; unverified",
)

# pipe 8 x tp 2: 3 layers/stage, no padding; tp shards channel dims.
PARALLEL = ParallelConfig(pipe=8, tp=2)
