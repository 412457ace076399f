"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (xLSTM[10:2]; sLSTM at layers 3 and 9). [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_layers=(3, 9), tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, vocab_size=512,
    slstm_layers=(1,), max_seq_len=128,
)
