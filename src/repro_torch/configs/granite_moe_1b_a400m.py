"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, d_ff=512, vocab=49155,
    n_experts=32, moe_top_k=8, capacity_factor=1.25, remat="dots",
)
