"""Model / shape configuration dataclasses shared by the whole framework."""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence


def pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. Field defaults follow the llama lineage."""

    name: str = "model"
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"] = "dense"

    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0          # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    vocab_pad_multiple: int = 256   # pad embedding rows for clean TP sharding

    activation: Literal["swiglu", "geglu", "relu2", "gelu"] = "swiglu"
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    max_seq_len: int = 131072

    # --- MoE ---
    n_experts: int = 0
    n_experts_active: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01

    # --- SSM / recurrent families ---
    ssm_state: int = 64
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # xLSTM: indices of sLSTM blocks (rest are mLSTM)
    slstm_layers: Sequence[int] = ()

    # --- hybrid (zamba2): shared attention block applied every k-th layer ---
    shared_attn_every: int = 0   # 0 = no shared block
    shared_attn_lora_rank: int = 0

    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 1500      # precomputed frame embeddings (conv stub)

    # --- vlm (phi-3-vision) ---
    n_image_tokens: int = 0      # precomputed patch embeddings (CLIP stub)

    # numerics
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad_multiple)

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm" and self.shared_attn_every == 0

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason). long_500k needs sub-quadratic context handling."""
    if shape.name == "long_500k":
        if cfg.family in ("ssm", "hybrid"):
            return True, "recurrent/hybrid: O(1)-state decode"
        return False, "pure full-attention arch: long_500k skipped (DESIGN §5)"
    return True, "ok"
