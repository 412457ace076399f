"""Phi-3-vision style VLM: the transformer LM backbone with a stubbed CLIP
front end (port of ``repro/models/vlm.py``).

The vision tower is a stub: the caller passes precomputed patch embeddings
(B, n_image_tokens, d_model), which are prepended to the text embedding
sequence (the projector is folded into the stub). Decode steps run on the
text tail with the usual KV cache.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def init_params(cfg: ModelConfig, gen: torch.Generator | None, device=None):
    return transformer.init_params(cfg, gen, device=device)


def param_specs(cfg: ModelConfig) -> dict:
    return transformer.param_specs(cfg)


def param_modes(cfg: ModelConfig, axis) -> dict:
    """The dense transformer's: the patches join the stream after the
    embedding's vocabulary-split lookup, so no leaf reads them."""
    return transformer.param_modes(cfg, axis)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, paged=None, device=None):
    return transformer.init_cache(cfg, batch, max_len, dtype, paged,
                                  device=device)


def cache_specs(cfg: ModelConfig) -> list:
    return transformer.cache_specs(cfg)


def forward(params, cfg: ModelConfig, tokens, *, patches=None, pos=0,
            cache=None, **kw):
    """tokens: (B, S_text); patches: (B, n_image_tokens, D) or None (decode).

    Returns logits over the full (image + text) sequence at prefill; callers
    slice off the image positions for loss and sampling.
    """
    return transformer.forward(params, cfg, tokens, pos=pos, cache=cache,
                               extra_embeds=patches, **kw)
