"""SmolLM-360M — 32L, d_model 960, 15H (GQA kv=5), d_ff 2560, vocab 49152,
llama-architecture small model, tied embeddings.
[hf:HuggingFaceTB/SmolLM-135M family]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152, tie_embeddings=True,
    citation="hf:HuggingFaceTB/SmolLM-135M",
)

def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="smollm-smoke", num_layers=2, d_model=96,
        num_heads=3, num_kv_heads=1, d_ff=256, vocab_size=256)
