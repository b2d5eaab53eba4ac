"""hubert-xlarge [audio]: 48L d_model=1280 16H (GQA kv=16) d_ff=5120
vocab=504 — encoder-only, same arch as wav2vec2 [arXiv:2106.07447].

`vocab` in the assignment line is the masked-prediction codebook size
(HuBERT units); the waveform conv frontend is a stub (frame embeddings in).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv=16, d_ff=5120, vocab=504,
    causal=False, num_classes=504, frontend="frame",
    remat="dots",
)
