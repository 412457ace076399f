"""How ``correct`` is decided for a served model: the plain reference is run
once over each sampled request's prompt and served tokens, and each served
token is read by how far its logit lies below the reference's best at its
position. Greedy tokens only.

The sample, drawn from the seed, holds the longest finished request and
``n - 1`` others. The reference gets the weights made again from the seed
(``perfbench/models/<arch>.py``) and nothing the program derived from them.
"""
from __future__ import annotations

import random

import torch

from perfbench import reference


def sample(finished: list, n: int, seed: int) -> list:
    """The longest of ``finished`` (by prompt + served tokens) and n - 1
    others drawn from the seed, one a client first (clients reach other
    slots); each an object with ``key`` (client, index), ``prompt`` (ids)
    and ``tokens`` (served ids)."""
    if not finished:
        return []
    order = sorted(finished, key=lambda r: (-(len(r.prompt) + len(r.tokens)),
                                            r.key))
    rest = sorted(order[1:], key=lambda r: r.key)
    rest = random.Random(seed).sample(rest, len(rest))
    picked, clients = [order[0]], {order[0].key[0]}
    for r in rest:
        if len(picked) < n and r.key[0] not in clients:
            picked.append(r)
            clients.add(r.key[0])
    taken = {id(r) for r in picked}
    picked += [r for r in rest if id(r) not in taken][:n - len(picked)]
    return picked


def _inputs(reqs: list, device):
    seqs, pos = [], []
    for r in reqs:
        toks = [int(t) for t in r.prompt] + [int(t) for t in r.tokens[:-1]]
        seqs.append(torch.tensor(toks, dtype=torch.int64, device=device))
        first = len(r.prompt) - 1
        pos.append(torch.arange(first, first + len(r.tokens),
                                dtype=torch.int64, device=device))
    return seqs, pos


def _below_best(logits: torch.Tensor, tokens) -> torch.Tensor:
    """Each row's best logit minus the logit of its token."""
    tok = torch.as_tensor(tokens, dtype=torch.int64, device=logits.device)
    return logits.max(-1).values - logits.gather(1, tok[:, None])[:, 0]


def served_gaps(cfg: dict, raw: dict, reqs: list) -> torch.Tensor:
    """Every served token's gap below the reference's best logit (f32)."""
    seqs, pos = _inputs(reqs, raw["embed"].device)
    logits = reference.get(cfg).logits_at(cfg, raw, seqs, pos)
    return torch.cat([_below_best(lg, [int(t) for t in r.tokens])
                      for lg, r in zip(logits, reqs)])


def control_gaps(cfg: dict, raw: dict, reqs: list,
                 precision: str = "fp8") -> torch.Tensor:
    """The control: at the same positions of the same prompts and served
    tokens, the gap (under the f32 reference) of the token that the
    reference computed at ``precision`` puts first."""
    seqs, pos = _inputs(reqs, raw["embed"].device)
    ref = reference.get(cfg)
    exact = ref.logits_at(cfg, raw, seqs, pos)
    low = ref.logits_at(cfg, raw, seqs, pos, precision=precision)
    return torch.cat([_below_best(lg, lo.argmax(-1))
                      for lg, lo in zip(exact, low)])
