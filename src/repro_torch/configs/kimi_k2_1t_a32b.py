"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8 — trillion-param MoE [arXiv:2501.kimi2].

Deviation note (DESIGN.md §5): the public Kimi-K2 uses MLA attention and a
dense first layer; the assignment line specifies GQA kv=8 and uniform MoE,
which we follow.  bf16 params + bf16 optimizer state (ZeRO-sharded) keep
the 1.03T-param model addressable on the 512-chip mesh.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv=8, d_ff=2048, vocab=163840,
    d_head=112, n_experts=384, moe_top_k=8, capacity_factor=1.25,
    param_dtype="bfloat16", remat="full", fsdp=True,
)
