"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064 — phi3-mini backbone + CLIP stub (precomputed patch embeds).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    n_image_tokens=1024,
    activation="swiglu", rope_theta=1e4,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, n_image_tokens=16, max_seq_len=128,
)
