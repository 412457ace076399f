"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4 fine-grained. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    n_experts=16, n_experts_active=4,
    activation="swiglu", rope_theta=5e5,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=512, n_experts=4, n_experts_active=2, max_seq_len=128,
)
