"""Architecture registry: one module per assigned architecture (the port's own copy of the reference dataclasses; jax-free)."""
from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, shape_applicable

from repro_torch.configs import (
    qwen3_1p7b, qwen2_72b, minitron_4b, yi_34b, xlstm_125m, dbrx_132b,
    qwen3_moe_30b_a3b, phi3_vision_4p2b, whisper_small, zamba2_7b, llama2_7b,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen3_1p7b, qwen2_72b, minitron_4b, yi_34b, xlstm_125m, dbrx_132b,
        qwen3_moe_30b_a3b, phi3_vision_4p2b, whisper_small, zamba2_7b,
        llama2_7b,
    )
}

SMOKE: dict[str, ModelConfig] = {
    m.CONFIG.name: m.SMOKE for m in (
        qwen3_1p7b, qwen2_72b, minitron_4b, yi_34b, xlstm_125m, dbrx_132b,
        qwen3_moe_30b_a3b, phi3_vision_4p2b, whisper_small, zamba2_7b,
        llama2_7b,
    )
}

ASSIGNED = [n for n in ARCHS if n != "llama2-7b"]

# canonical representative arch per model family (smoke-testable via
# SMOKE[...]); the adapter-registry tests and examples iterate this
FAMILY_REPRESENTATIVE: dict[str, str] = {
    "dense": "llama2-7b",
    "moe": "qwen3-moe-30b-a3b",
    "vlm": "phi-3-vision-4.2b",
    "ssm": "xlstm-125m",
    "hybrid": "zamba2-7b",
    "audio": "whisper-small",
}


def get(name: str) -> ModelConfig:
    return ARCHS[name]
