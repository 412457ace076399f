"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768/expert
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936,
    n_experts=128, n_experts_active=8,
    activation="swiglu", qk_norm=True, rope_theta=1e6,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=512, n_experts=8, n_experts_active=2, max_seq_len=128,
)
