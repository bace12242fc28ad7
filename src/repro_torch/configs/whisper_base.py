"""Whisper-base — 6 encoder + 6 decoder layers, d_model 512, 8H (MHA),
d_ff 2048, vocab 51865, encoder-decoder with stubbed conv/mel frontend
(1500 precomputed frame embeddings). [arXiv:2212.04356]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, encoder_layers=6, d_model=512, num_heads=8,
    num_kv_heads=8, d_ff=2048, vocab_size=51865,
    cross_attention=True, frontend="audio", num_frontend_tokens=1500,
    tie_embeddings=True, norm_eps=1e-5,
    citation="arXiv:2212.04356",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", num_layers=2, encoder_layers=2,
        d_model=128, num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=256,
        num_frontend_tokens=32)
