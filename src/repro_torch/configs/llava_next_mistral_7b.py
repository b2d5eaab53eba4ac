"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Vision tower is a STUB: input_specs() provides 2880 precomputed anyres
patch embeddings (5 tiles x 576), spliced as a prefix.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336, vocab=32000,
    frontend="patch", num_patches=2880, remat="dots", fsdp=True,
)
