"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global, 128k ctx [hf:google/gemma-3].

window=1024 sliding-window for the 5 local layers per group of 6; the 6th
layer is global.  long_500k is skipped: the global layers are full
attention (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv=8, d_ff=15360, vocab=262144,
    d_head=256, window=1024, global_every=6, rope_theta=1e6,
    remat="dots", fsdp=True,
)
