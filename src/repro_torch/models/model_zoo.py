"""Unified model API (port of ``repro/models/model_zoo.py``): the dense,
moe, vlm, ssm (xLSTM), hybrid (Zamba2) and audio (whisper) families
(``transformer.PORTED``).

``build(cfg)`` returns a ``Model`` whose ``init_params(seed, device)`` makes
random weights from a seed (on ``cuda`` unless ``device="cpu"``), whose
``init_cache(batch, max_len, dtype, paged, device)`` makes a per-layer
cache list (the hybrid: a ``hybrid.HybridCache``, audio: an
``encdec.EncDecCache``; dense, or paged with a ``PagedLayout``; recurrent
state and cross K/V are slot-resident either way), and whose
``forward(params, batch, cache=None, pos=0, **kw)`` takes a dict with
``tokens`` (B, S) and, for vlm, ``patches`` (B, n_image_tokens, D), for
audio ``frames`` (B, encoder_seq, D), and returns (logits, new_cache,
aux_loss). ``param_specs()`` gives the reference's sharding specs
(``common.P``) on the port's tree, ``param_modes(axis)`` how a step on a
model axis (``parallel.ModelAxis``) reads each of those leaves (each
layer module's ``split_modes``), and ``abstract_params(model)`` the
parameters' shapes and dtypes as ``meta`` tensors (nothing allocated).
``remat=`` (the reference's ``True`` / ``False`` /
``"save_attn"``) passes through to the family's forward: the train step's
checkpointing (a block of dense, moe, vlm and ssm; a hybrid group; an
audio encoder or decoder layer).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, transformer, vlm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable[..., Any]
    forward: Callable[..., tuple]
    init_cache: Callable[..., Any]
    param_specs: Callable[[], Any]
    param_modes: Callable[[Any], Any]


def _family_module(cfg: ModelConfig):
    """The module holding the family's init_params / init_cache."""
    transformer._check_family(cfg)
    return {"hybrid": hybrid, "audio": encdec}.get(cfg.family, transformer)


def build(cfg: ModelConfig) -> Model:
    mod = _family_module(cfg)

    def init_params(seed: int = 0, device=None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return mod.init_params(cfg, gen, device=dev)

    if cfg.family == "audio":
        def fwd(params, batch, cache=None, pos=0, **kw):
            return encdec.forward(params, cfg, batch["tokens"],
                                  frames=batch.get("frames"), pos=pos,
                                  cache=cache, **kw)
    elif cfg.family == "hybrid":
        def fwd(params, batch, cache=None, pos=0, **kw):
            return hybrid.forward(params, cfg, batch["tokens"], pos=pos,
                                  cache=cache, **kw)
    elif cfg.family == "vlm":
        def fwd(params, batch, cache=None, pos=0, **kw):
            return vlm.forward(params, cfg, batch["tokens"],
                               patches=batch.get("patches"), pos=pos,
                               cache=cache, **kw)
    else:  # dense / moe / ssm (xLSTM)
        def fwd(params, batch, cache=None, pos=0, **kw):
            return transformer.forward(params, cfg, batch["tokens"],
                                       pos=pos, cache=cache, **kw)

    def init_cache(batch, max_len, dtype=torch.bfloat16, paged=None,
                   device=None):
        return mod.init_cache(cfg, batch, max_len, dtype, paged,
                              device=resolve_device(device))

    fam = {"hybrid": hybrid, "audio": encdec, "vlm": vlm}.get(cfg.family,
                                                              transformer)
    return Model(cfg, init_params, fwd, init_cache,
                 lambda: fam.param_specs(cfg),
                 lambda axis: fam.param_modes(cfg, axis))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def abstract_params(model: Model):
    """The parameter tree as ``meta`` tensors: shapes and dtypes, nothing
    allocated (the reference's ``jax.eval_shape`` of the init)."""
    return _family_module(model.cfg).init_params(model.cfg, None,
                                                 device="meta")


def count_params(model: Model) -> int:
    """Parameter count, from shapes only (no allocation: meta tensors)."""
    return sum(t.numel() for t in _leaves(abstract_params(model)))
