"""Moonlight-16B-A3B — 48L, d_model 2048, 16H (MHA kv=16), per-expert
d_ff 1408, vocab 163840, MoE 64 experts top-6.  The assignment pool tags it
[dense] but specifies a MoE geometry; built as MoE per the explicit spec
(noted in DESIGN.md). [hf:moonshotai/Moonlight-16B-A3B]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=0, vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2),
    rope_theta=50_000.0,
    citation="hf:moonshotai/Moonlight-16B-A3B",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="moonshot-smoke", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=4, vocab_size=256,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                      num_shared_experts=1))
