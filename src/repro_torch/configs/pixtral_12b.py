"""Pixtral-12B — 40L, d_model 5120, 32H (GQA kv=8), d_ff 14336, vocab 131072.
LM backbone only: the Pixtral-ViT vision encoder + projector are stubbed —
``input_specs()`` provides 1024 precomputed patch embeddings per image.
[hf:mistralai/Pixtral-12B-2409]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072,
    frontend="vision", num_frontend_tokens=1024,
    rope_theta=1_000_000_000.0,
    citation="hf:mistralai/Pixtral-12B-2409",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="pixtral-smoke", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=256,
        num_frontend_tokens=16)
