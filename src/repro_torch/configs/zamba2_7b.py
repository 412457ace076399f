"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336 ssm_state=64
— Mamba2 trunk + shared attention block. [arXiv:2411.15242; unverified]

n_layers rounded 81 -> 78 so the trunk scans uniformly as 13 groups of 6
mamba layers, each preceded by the shared-attn invocation (DESIGN.md §5).
d_ff is unused by mamba blocks (kept for the record)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=78, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    shared_attn_every=6, shared_attn_lora_rank=64,
    rope_theta=1e4,
)

SMOKE = CONFIG.scaled(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=128, vocab_size=512, ssm_state=16, ssm_head_dim=16,
    shared_attn_every=2, shared_attn_lora_rank=8, max_seq_len=128,
)
