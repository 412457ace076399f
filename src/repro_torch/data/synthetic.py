"""Deterministic synthetic corpus (port of ``repro/data/synthetic.py``).

A mixture of Zipfian n-gram "sources": each sequence picks a source; tokens
are drawn from a source-specific bigram chain over a Zipf-distributed
vocabulary. The draws come from a ``torch.Generator``, so the stream differs
from the reference's ``jax.random`` stream for the same seed; tests hand the
same tokens to both packages as numpy instead. ``SyntheticStream`` is the
reference's resumable training stream over the same draw.
"""
from __future__ import annotations

import numpy as np
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


class SyntheticStream:
    """Sharded, resumable token stream (step index is the only state). Each
    batch is drawn on ``device`` (default the CPU) from a generator there
    seeded by (seed, step, shard_id), so a restored stream repeats its
    batches exactly. The CPU's and the card's generators differ, so one
    seed gives other tokens on each; on the card the draw's 4,096-step
    chain at vocab 32,000 is launch-bound instead of taking tens of
    seconds of host time a batch."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, shard_id: int = 0, n_shards: int = 1,
                 device=None):
        if global_batch % n_shards:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"into {n_shards} shards")
        self.vocab, self.seq_len = vocab, seq_len
        self.batch = global_batch // n_shards
        self.seed, self.shard_id, self.n_shards = seed, shard_id, n_shards
        self.device = device
        self.step = 0

    def next(self) -> torch.Tensor:
        key = np.random.SeedSequence(
            [self.seed, self.step, self.shard_id]).generate_state(1)[0]
        gen = torch.Generator(device=self.device or "cpu").manual_seed(
            int(key))
        self.step += 1
        return sample_batch(gen, self.vocab, self.seq_len, self.batch)

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict):
        self.step = int(state["step"])
        self.seed = int(state["seed"])
