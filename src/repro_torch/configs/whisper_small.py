"""whisper-small [audio]: 12L enc + 12L dec, d_model=768 12H (kv=12)
d_ff=3072 vocab=51865 — enc-dec, conv frontend stubbed (precomputed frame
embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, n_encoder_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, encoder_seq=1500,
    activation="gelu", qkv_bias=True, tie_embeddings=True,
    max_seq_len=32768,
)

SMOKE = CONFIG.scaled(
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, encoder_seq=32, max_seq_len=128,
)
