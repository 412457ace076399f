"""Calibration dataset for post-training quantization (port of
``repro/data/calibration.py``): synthetic-corpus sequences, or a user's own
tokens from a ``.npy`` file (``from_token_file``), sharded across
data-parallel quantization workers."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.synthetic import sample_batch
from repro_torch.device import resolve_device


def calibration_tokens(vocab: int, n_sequences: int = 128,
                       seq_len: int = 2048, seed: int = 1234,
                       device=None) -> torch.Tensor:
    """(n_sequences, seq_len) int64 tokens, deterministic in ``seed``. They
    are drawn on the CPU, so CPU and CUDA runs see the same tokens, and
    then moved to ``device`` (``cuda`` unless ``device="cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    bs = min(16, n_sequences)
    out = [sample_batch(gen, vocab, seq_len, bs)
           for _ in range(0, n_sequences, bs)]
    return torch.cat(out, dim=0)[:n_sequences].to(dev)


def from_token_file(path: str, n_sequences: int, seq_len: int,
                    device=None) -> torch.Tensor:
    """A flat ``.npy`` int token file windowed into (n_sequences, seq_len)
    sequences: its first n_sequences * seq_len tokens, read as int32 as
    the reference reads them, as int64 tokens on ``device`` (``cuda``
    unless ``device="cpu"``). Raises ValueError when the file holds fewer
    tokens."""
    dev = resolve_device(device)
    toks = np.load(path).astype(np.int32).reshape(-1)
    need = n_sequences * seq_len
    if toks.size < need:
        raise ValueError(f"token file too small: {toks.size} < {need}")
    return torch.from_numpy(
        toks[:need].reshape(n_sequences, seq_len).astype(np.int64)).to(dev)


def shard_for_worker(tokens: torch.Tensor, worker: int, n_workers: int):
    per = tokens.shape[0] // n_workers
    return tokens[worker * per:(worker + 1) * per]
