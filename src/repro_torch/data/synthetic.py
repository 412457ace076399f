"""Deterministic synthetic corpus (port of ``repro/data/synthetic.py``).

A mixture of Zipfian n-gram "sources": each sequence picks a source; tokens
are drawn from a source-specific bigram chain over a Zipf-distributed
vocabulary. The draws come from a ``torch.Generator``, so the stream differs
from the reference's ``jax.random`` stream for the same seed; tests hand the
same tokens to both packages as numpy instead.
"""
from __future__ import annotations

import torch


def sample_batch(gen: torch.Generator, vocab: int, seq_len: int, batch: int,
                 n_sources: int = 8) -> torch.Tensor:
    """(batch, seq_len) int64 tokens on the generator's device."""
    dev = gen.device
    ranks = torch.arange(vocab, dtype=torch.float32, device=dev) + 1.0
    base_logits = -1.1 * torch.log(ranks)
    src = torch.randint(0, n_sources, (batch,), generator=gen, device=dev)
    # each source permutes the vocab by a fixed stride (cheap deterministic)
    stride = (1 + 2 * torch.arange(n_sources, device=dev))[src]  # (batch,)
    perm = (torch.arange(vocab, device=dev)[None, :] * stride[:, None]) % vocab
    logits = base_logits[perm]  # (batch, vocab)
    rows = torch.arange(batch, device=dev)
    prev = torch.randint(0, vocab, (batch,), generator=gen, device=dev)
    toks = []
    for _ in range(seq_len):
        # bigram structure: strong pull toward prev+delta(source)
        biased = logits.clone()
        biased[rows, (prev * 7 + stride) % vocab] += 4.0
        biased[rows, (prev + 1) % vocab] += 3.0
        prev = torch.multinomial(torch.softmax(biased, dim=-1), 1,
                                 generator=gen)[:, 0]
        toks.append(prev)
    return torch.stack(toks, dim=1)
