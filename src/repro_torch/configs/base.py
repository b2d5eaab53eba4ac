"""Architecture config schema + input-shape grid.

The port's own copy of the reference's `configs/base.py`, field for field
(the reference's tests hold the two equal).  One `ArchConfig` per
architecture lives in `repro_torch.configs.<id>`;
`repro_torch.configs.registry` maps `--arch <id>` strings to them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # default d_model // n_heads
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # attention pattern (gemma3: window>0 with global_every for 5:1 mix)
    window: int = 0                        # 0 = full attention
    global_every: int = 0                  # every k-th layer is global
    # SSM / RWKV
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_chunk: int = 64
    rwkv_mode: str = "scan"                # scan | chunked (perf variant)
    # hybrid (zamba2): shared attention block cadence
    attn_every: int = 0
    shared_attn_window: int = 4096         # long-context decode window
    # modality stub frontends (assignment: backbone only)
    frontend: str = "none"                 # none | patch | frame
    num_patches: int = 0
    # encoder-only
    causal: bool = True
    num_classes: int = 0                   # hubert masked-prediction classes
    # numerics / training
    rope_theta: float = 1e4
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "dots"                    # none | dots | full
    tie_embeddings: bool = False
    fsdp: bool = False                     # shard weights over data axis too
    sharding_scheme: str = "tp"            # tp | sp (§Perf: sequence-parallel
    #                                        activations + FSDP weights)
    windowed_kernel: bool = False          # O(T·window) local-attention path
    moe_local_combine: bool = False        # shard_map EP combine (§Perf A-it4)
    pallas_flash: bool = False             # fused flash kernel on the
    #                                        prefill/serving path (§Perf C)

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.head_dim
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family in ("ssm",):                   # rwkv6
            per = d * d * 4 + d * self.d_ff * 2 + d * 14  # tmix r,k,v,g,o + cmix
            return embed + self.n_layers * per
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv * hd) * 2
        if self.family == "moe":
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff
        per = attn + ffn
        if self.family == "hybrid":                    # zamba2-style
            d_in = 2 * d
            mamba = d * d_in * 2 + d_in * d + d_in * (2 * self.ssm_state) \
                + d_in * 2
            n_attn = max(1, self.n_layers // max(self.attn_every, 1))
            return embed + self.n_layers * mamba + attn + 3 * d * self.d_ff
        if self.family == "encoder":
            head = d * self.num_classes
            return embed + self.n_layers * per + head
        return embed + self.n_layers * per

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        attn = d * (self.n_heads * self.head_dim) * 2 \
            + d * (self.n_kv * self.head_dim) * 2
        ffn = self.moe_top_k * 3 * d * self.d_ff + d * self.n_experts
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return embed + self.n_layers * (attn + ffn)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


# The assignment's four LM shapes.
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """Assignment skip rules (DESIGN.md §5)."""
    out = ["train_4k", "prefill_32k"]
    if cfg.family == "encoder":
        return out                       # no decode step
    out.append("decode_32k")
    if cfg.family in ("ssm", "hybrid"):  # sub-quadratic archs only
        out.append("long_500k")
    return out
