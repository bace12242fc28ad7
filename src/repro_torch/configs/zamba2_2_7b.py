"""Zamba2-2.7B — 54 Mamba-2 layers, d_model 2560, ssm_state 64, plus a
*shared* attention block (32H MHA, d_ff 10240) applied every 6 SSM blocks,
vocab 32000. [arXiv:2411.15242]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, version=2, head_dim=64),
    attn_period=6,
    citation="arXiv:2411.15242",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="zamba2-smoke", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=2,
                      head_dim=32, chunk=16),
        attn_period=2)
