"""Unified model API (port of ``repro/models/model_zoo.py``), dense family.

``build(cfg)`` returns a ``Model`` whose ``init_params(seed, device)`` makes
random weights from a seed (on ``cuda`` unless ``device="cpu"``) and whose
``forward(params, batch)`` takes a dict with ``tokens`` (B, S) and returns
(logits, new_cache, aux_loss).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable[..., Any]
    forward: Callable[..., tuple]


def build(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue 1, "
            "'The other five families')")

    def init_params(seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return transformer.init_params(cfg, gen, device=dev)

    def fwd(params, batch, pos=0):
        return transformer.forward(params, cfg, batch["tokens"], pos=pos)

    return Model(cfg, init_params, fwd)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def count_params(model: Model) -> int:
    """Parameter count, from shapes only (no allocation: meta tensors)."""
    shapes = transformer.init_params(model.cfg, None, device="meta")
    return sum(t.numel() for t in _leaves(shapes))
