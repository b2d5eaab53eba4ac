"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536
— Finch: data-dependent decay [arXiv:2404.05892].

rwkv_mode="scan" is the faithful baseline; "chunked" is the GLA-style perf
variant (EXPERIMENTS.md §Perf hillclimb).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv=40, d_ff=8960, vocab=65536,
    ssm_chunk=64, rwkv_mode="scan", remat="dots",
)
