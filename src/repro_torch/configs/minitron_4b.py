"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron (relu^2 MLP). [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256000,
    activation="relu2", rope_theta=1e4,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, max_seq_len=128,
)
