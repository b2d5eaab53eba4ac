"""`--arch <id>` registry + reduced smoke-test variants."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ArchConfig

ARCH_IDS = (
    "hubert-xlarge", "kimi-k2-1t-a32b", "granite-moe-1b-a400m", "granite-8b",
    "gemma3-12b", "llama3.2-3b", "granite-20b", "zamba2-1.2b",
    "llava-next-mistral-7b", "rwkv6-3b",
)

_MODULES = {
    "hubert-xlarge": "hubert_xlarge",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "granite-8b": "granite_8b",
    "gemma3-12b": "gemma3_12b",
    "llama3.2-3b": "llama3_2_3b",
    "granite-20b": "granite_20b",
    "zamba2-1.2b": "zamba2_1_2b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "rwkv6-3b": "rwkv6_3b",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def smoke_config(arch_id: str) -> ArchConfig:
    """Reduced same-family config: small depth/width/experts/vocab, runnable
    on CPU for one forward/train step (assignment §f)."""
    cfg = get_config(arch_id)
    changes = dict(
        n_layers=max(2, min(cfg.n_layers, 2 if cfg.attn_every == 0
                            else 2 * cfg.attn_every)),
        d_model=128, n_heads=4, d_ff=256, vocab=512,
        n_kv=min(cfg.n_kv, 4) if cfg.n_kv > 1 else 1,
        d_head=32, param_dtype="float32", compute_dtype="float32",
        remat="none", fsdp=False,
    )
    if cfg.family == "moe":
        changes.update(n_experts=8, moe_top_k=2, d_ff=64)
    if cfg.family == "hybrid":
        changes.update(attn_every=2, n_layers=4, ssm_state=16)
    if cfg.family == "ssm":
        changes.update(d_model=128, ssm_chunk=16)
    if cfg.family == "encoder":
        changes.update(num_classes=32)
    if cfg.window:
        changes.update(window=64)
    if cfg.num_patches:
        changes.update(num_patches=16)
    return dataclasses.replace(cfg, **changes)
