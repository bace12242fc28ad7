"""Mixtral-8x22B — 56L, d_model 6144, 48H (GQA kv=8), expert d_ff 16384,
vocab 32768, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=0, vocab_size=32768,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
    sliding_window=4096, rope_theta=1_000_000.0,
    citation="arXiv:2401.04088",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mixtral-smoke", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, vocab_size=256,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64),
        sliding_window=32)
