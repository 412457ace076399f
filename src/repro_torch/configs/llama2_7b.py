"""llama2-7b: the paper's primary evaluation model (GPTVQ Tables 1/2/6-11)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=32000,
    activation="swiglu", rope_theta=1e4,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, max_seq_len=128,
)
