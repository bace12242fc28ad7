"""Falcon-Mamba-7B — 64 Mamba-1 layers (attention-free), d_model 4096,
ssm_state 16, vocab 65024. [arXiv:2410.05355]"""
import dataclasses
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=65024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=1),
    citation="arXiv:2410.05355",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="falcon-mamba-smoke", num_layers=2, d_model=128,
        vocab_size=256,
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, version=1, chunk=16))
