"""Model / shape / run configuration dataclasses and the arch registry.

The port's own copy of ``repro.configs.base`` (plain dataclasses, no JAX),
kept field for field equal to it; ``tests/test_torch_zoo.py`` checks that
every arch's ``CONFIG`` and ``smoke_config()`` match.

Every assigned architecture provides a ``CONFIG`` (exact published geometry,
cited in its module docstring) and a ``smoke_config()`` (reduced same-family
variant: ≤2 layers, d_model ≤ 512, ≤4 experts) used by CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = ["MoEConfig", "SSMConfig", "ModelConfig", "ShapeConfig", "SHAPES",
           "ARCH_IDS", "get_config", "get_smoke_config", "FamilyLiteral"]

FamilyLiteral = str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'vlm' | 'audio'


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01   # load-balance loss (Switch-style)
    num_shared_experts: int = 0
    # Every MoE in the zoo (Mixtral, Qwen3-MoE, Kimi/Moonshot) routes
    # droplessly in its reference implementation; capacity_factor then only
    # sizes the dispatch buffers for the roofline, it never drops tokens.
    # Capacity-bounded (Switch/GShard) dispatch remains available for
    # experiments by setting dropless=False.
    dropless: bool = True


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    version: int = 1            # 1 = Mamba-1 selective scan, 2 = Mamba-2 SSD
    head_dim: int = 64          # Mamba-2 only
    dt_rank: int = 0            # 0 -> ceil(d_model/16) (Mamba-1 default)
    chunk: int = 128            # scan chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: FamilyLiteral
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    sliding_window: Optional[int] = None    # SWA width (tokens)
    local_global_ratio: int = 0         # N local layers per 1 global (gemma3)
    attn_period: int = 0                # hybrid: shared attn every N ssm blocks
    qk_norm: bool = False
    encoder_layers: int = 0             # enc-dec (whisper)
    cross_attention: bool = False
    frontend: Optional[str] = None      # 'audio' | 'vision' (stubbed)
    num_frontend_tokens: int = 0        # audio frames / image patches
    tie_embeddings: bool = False
    scale_embeddings: bool = False      # gemma-style sqrt(d_model) scaling
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    citation: str = ""

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # attention chunking for the XLA online-softmax path (0 = auto by size;
    # §Perf A/B: bigger tiles cut scan-boundary HBM+collective traffic, but
    # the fp32 score tile must fit alongside the rest of the step)
    q_chunk: int = 0
    kv_chunk: int = 0

    @property
    def attn_chunks(self) -> tuple[int, int]:
        if self.q_chunk and self.kv_chunk:
            return self.q_chunk, self.kv_chunk
        if self.d_model <= 1536:
            return 2048, 4096
        if self.d_model <= 4096:
            return 1024, 2048
        return 512, 1024

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long_500k decode is admissible (see DESIGN.md table)."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None
                or self.local_global_ratio > 0)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND roofline."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        hd = self.resolved_head_dim
        attn = d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads \
            + hd * self.num_heads * d
        if self.moe is not None:
            ffn = self.moe.num_experts * 3 * d * self.moe.d_ff_expert \
                + d * self.moe.num_experts
        elif self.d_ff:
            ffn = 3 * d * self.d_ff
        else:
            ffn = 0
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            dt_rank = s.dt_rank or -(-d // 16)
            per_layer = (2 * d * d_in + s.d_conv * d_in
                         + d_in * (dt_rank + 2 * s.d_state)
                         + dt_rank * d_in + d_in * s.d_state + d_in
                         + d_in * d)
        elif self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            per_layer = (d * (2 * d_in + 2 * nh * s.d_state + nh) + s.d_conv
                         * (d_in + 2 * nh * s.d_state) + d_in * d + nh)
            shared = attn + 3 * d * self.d_ff
            return emb + per_layer * self.num_layers + shared
        else:
            per_layer = attn + ffn
        total = emb + per_layer * self.num_layers
        if self.encoder_layers:
            total += self.encoder_layers * (attn + 3 * d * self.d_ff)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k only), for MoE 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.num_layers * (
            self.moe.num_experts * 3 * d * self.moe.d_ff_expert)
        active_ffn = self.num_layers * (self.moe.top_k
                                        * 3 * d * self.moe.d_ff_expert)
        return int(dense + active_ffn)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "qwen3_moe_235b_a22b",
    "moonshot_v1_16b_a3b",
    "gemma3_4b",
    "mixtral_8x22b",
    "smollm_360m",
    "pixtral_12b",
    "qwen3_0_6b",
    "whisper_base",
    "zamba2_2_7b",
    "falcon_mamba_7b",
]

# CLI-facing ids use dashes; module names use underscores.
def _norm(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(arch_id)}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(arch_id)}")
    return mod.smoke_config()
