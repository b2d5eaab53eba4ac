"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242].

Shared attention every 6 Mamba2 layers (6 call sites + 2 tail layers);
ring-buffered 4096-window shared-attn KV for long_500k (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv=32, d_ff=8192, vocab=32000,
    ssm_state=64, attn_every=6, shared_attn_window=4096, remat="dots",
)
