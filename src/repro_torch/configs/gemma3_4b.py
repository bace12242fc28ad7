"""Gemma3-4B — 34L, d_model 2560, 8H (GQA kv=4), d_ff 10240, vocab 262144,
5:1 local:global attention (sliding window 1024), 128k context, tied + scaled
embeddings, qk-norm. [hf:google/gemma-3-1b-pt family]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
    head_dim=256, d_ff=10240, vocab_size=262144,
    sliding_window=1024, local_global_ratio=5,
    qk_norm=True, tie_embeddings=True, scale_embeddings=True,
    rope_theta=1_000_000.0,
    citation="hf:google/gemma-3-1b-pt",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="gemma3-smoke", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256,
        sliding_window=32, local_global_ratio=1)
