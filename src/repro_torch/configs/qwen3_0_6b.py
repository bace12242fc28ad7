"""Qwen3-0.6B — 28L, d_model 1024, 16H (GQA kv=8), d_ff 3072, vocab 151936,
qk-norm, head_dim 128, tied embeddings. [hf:Qwen/Qwen3-8B family]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
    head_dim=128, d_ff=3072, vocab_size=151936,
    qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0,
    citation="hf:Qwen/Qwen3-8B",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-smoke", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256)
