"""Qwen3-MoE 235B-A22B — 94L, d_model 4096, 64H (GQA kv=4), per-expert
d_ff 1536, vocab 151936, MoE 128 experts top-8, qk-norm, head_dim 128.
[hf:Qwen/Qwen3-30B-A3B family scaling per assignment]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    head_dim=128, d_ff=0, vocab_size=151936,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
    qk_norm=True, rope_theta=1_000_000.0,
    citation="hf:Qwen/Qwen3-30B-A3B",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-moe-smoke", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, vocab_size=256,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64))
