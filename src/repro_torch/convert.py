"""Carry weights over from the reference package as numpy.

``params_from_jax`` turns the numpy leaves of the reference's
``init_params`` tree into the port's parameter dict, unstacking the
``layers`` leading axis into a list of per-layer dicts (a MoE layer's
expert stacks (E, D, F) stay stacked inside its dict; the xLSTM's layers
are a list already; the hybrid's (n_groups, per) trunk becomes a list of
lists; the audio family's ``enc_layers`` and ``dec_layers`` become two
lists). The leaves the reference keeps in f32 (the MoE router, the mLSTM
gate projections, the Mamba2 scan parameters) stay f32.
``vqlinear_from_jax`` does the same for one packed ``VQLinear`` (any object
with the reference's field names, an expert stack's arrays with their
leading E, or one matrix of a stacked leaf; uint32 words are
reinterpreted as int32), and ``paged_cache_from_jax`` for a reference
``PagedKVCache`` (pools, scales, codebooks, page table), ``HybridCache``
or ``EncDecCache``, and ``train_state_from_jax`` for a reference
``TrainState`` (params, AdamW moments, master copy, step). Nothing here
imports jax: callers pass numpy arrays (or
objects ``np.asarray`` accepts).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.vq_linear import VQLinear
from repro_torch.device import resolve_device
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.common import DTYPES


def _tensor(a, dtype, device) -> torch.Tensor:
    # via float32: numpy has no bfloat16 that torch.from_numpy reads
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(
        device=device, dtype=dtype)


# leaves the reference keeps in f32 whatever the model's dtype, by block
# kind: the MoE router, the mLSTM's exponential-gate projections and the
# Mamba2 mixer's scan parameters
_F32_LEAVES = {"moe": {("ffn", "router")},
               "mlstm": {("core", w) for w in ("w_i", "w_f", "b_i", "b_f")},
               "mamba": {("mixer", w) for w in ("A_log", "dt_bias",
                                                "D_skip")}}


def _map(tree, f, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, f, path + (k,)) for k, v in tree.items()}
    return f(tree, path)


def params_from_jax(np_tree: dict, cfg: ModelConfig, device=None,
                    keep_dtype: bool = False) -> dict:
    """Reference params -> port params (``layers`` a list of per-layer
    dicts) in ``cfg.dtype``, the leaves the reference keeps in f32 in f32.
    The reference's ``layers`` is stacked on a leading axis (dense, moe,
    vlm) or already a list of per-layer dicts (the xLSTM's mLSTM/sLSTM
    mix, whose sLSTM ``r_*`` leaves are (H, hd, hd) stacks). The hybrid's
    ``mamba`` trunk, stacked (n_groups, per, ...) or a list of lists,
    becomes a list of groups of layer dicts; its ``lora`` factors stay
    stacked (n_groups, ...). The audio family's ``enc_layers`` and
    ``dec_layers``, stacked or lists, become lists of layer dicts.
    ``keep_dtype`` keeps each leaf's own dtype (f32 or bf16) instead: an
    optimizer state's moments and master copy."""
    from repro_torch.models.transformer import block_kind

    dev = resolve_device(device)

    def leaf_dtype(a, path, f32):
        if keep_dtype:
            name = np.asarray(a).dtype.name
            return torch.bfloat16 if name == "bfloat16" else torch.float32
        return torch.float32 if path in f32 else DTYPES[cfg.dtype]

    def conv(tree, kind=None):
        f32 = _F32_LEAVES.get(kind, ())
        return _map(tree, lambda a, path: _tensor(
            a, leaf_dtype(a, path, f32), dev))

    if cfg.family == "hybrid":
        out = {k: conv(v) for k, v in np_tree.items() if k != "mamba"}
        trunk = np_tree["mamba"]
        n_groups = cfg.n_layers // cfg.shared_attn_every
        if not isinstance(trunk, list):
            trunk = [[_map(trunk, lambda a, _, g=g, j=j: a[g][j])
                      for j in range(cfg.shared_attn_every)]
                     for g in range(n_groups)]
        out["mamba"] = [[conv(lp, "mamba") for lp in grp] for grp in trunk]
        return out
    def unstack(layers, n):
        if isinstance(layers, list):
            return layers
        return [_map(layers, lambda a, _, i=i: a[i]) for i in range(n)]

    if cfg.family == "audio":
        stacks = {"enc_layers": cfg.n_encoder_layers,
                  "dec_layers": cfg.n_layers}
        out = {k: conv(v) for k, v in np_tree.items() if k not in stacks}
        for k, n in stacks.items():
            out[k] = [conv(lp) for lp in unstack(np_tree[k], n)]
        return out
    out = {k: conv(v) for k, v in np_tree.items() if k != "layers"}
    out["layers"] = [conv(lp, block_kind(cfg, i)) for i, lp in
                     enumerate(unstack(np_tree["layers"], cfg.n_layers))]
    return out


def train_state_from_jax(np_state, cfg: ModelConfig, device=None):
    """A reference ``TrainState`` (leaves as numpy arrays; fields
    ``params`` and ``opt``, an ``AdamWState`` of ``step``, ``m``, ``v``,
    ``master``) -> the port's ``TrainState``: params as
    ``params_from_jax``, m, v and master leaf for leaf in their own dtypes
    (f32, or bf16 moments), the step a 0-dim int32 tensor."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState

    dev = resolve_device(device)
    o = np_state.opt
    trees = {name: params_from_jax(getattr(o, name), cfg, dev,
                                   keep_dtype=True)
             for name in ("m", "v", "master")}
    step = torch.tensor(int(np.asarray(o.step)), dtype=torch.int32,
                        device=dev)
    return TrainState(params=params_from_jax(np_state.params, cfg, dev),
                      opt=AdamWState(step=step, **trees))


def vqlinear_from_jax(vql, device=None, index: tuple = ()) -> VQLinear:
    """A reference ``VQLinear`` (fields as arrays) -> the port's VQLinear.
    ``index`` picks one matrix of a stacked leaf, e.g. (g, j) of the
    hybrid trunk's (n_groups, per, ...) arrays."""
    dev = resolve_device(device)

    def arr(name, np_dtype, torch_dtype):
        a = np.ascontiguousarray(np.asarray(getattr(vql, name))[index])
        return torch.from_numpy(a.view(np_dtype).copy()).to(dev, torch_dtype)

    return VQLinear(
        words=arr("words", np.int32, torch.int32),
        codebooks=arr("codebooks", np.int8, torch.int8),
        cb_scale=arr("cb_scale", np.float32, torch.float32),
        scale_sint=arr("scale_sint", np.int8, torch.int8),
        scale_a=arr("scale_a", np.float32, torch.float32),
        scale_z=arr("scale_z", np.float32, torch.float32),
        r=int(vql.r), c=int(vql.c), d=int(vql.d), k=int(vql.k),
        group_cols=int(vql.group_cols), rows_per_band=int(vql.rows_per_band),
        scale_block=int(vql.scale_block), rule=str(vql.rule))


def _exact(a, device) -> torch.Tensor:
    """numpy -> tensor with the same bits: f32/int8/int32 as they are,
    bf16 (no numpy dtype torch reads) through f32, which is exact."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                          torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def paged_cache_from_jax(cache, device=None):
    """A reference ``PagedKVCache`` (fields as arrays; pools with a leading
    layer axis, as the reference's scanned stacks hold them, or a single
    layer's) -> the port's per-layer list, bit for bit. A reference
    ``HybridCache`` (fields ``mamba``, an ``SSMCache`` stacked (n_groups,
    per, B, ...), and ``attn``, a ``PagedKVCache`` stacked (n_groups, ...))
    -> the port's ``HybridCache``: per group a ``PagedKVCache``, per layer
    an ``SSMCache``. A reference ``EncDecCache`` (``self_kv`` a stacked
    ``PagedKVCache``, ``cross_k`` / ``cross_v`` (L, B, S_enc, KV, hd)) ->
    the port's ``EncDecCache``: per layer a ``PagedKVCache`` and a pair of
    cross K/V tensors."""
    dev = resolve_device(device)
    if hasattr(cache, "cross_k"):
        from repro_torch.models.encdec import EncDecCache

        ck, cv = np.asarray(cache.cross_k), np.asarray(cache.cross_v)
        return EncDecCache(
            self_kv=paged_cache_from_jax(cache.self_kv, dev),
            cross_k=[_exact(a, dev) for a in ck],
            cross_v=[_exact(a, dev) for a in cv])
    if hasattr(cache, "mamba"):
        from repro_torch.models.hybrid import HybridCache
        from repro_torch.models.ssm import SSMCache

        h, conv = (np.asarray(cache.mamba.h), np.asarray(cache.mamba.conv))
        return HybridCache(
            mamba=[[SSMCache(_exact(h[g, j], dev), _exact(conv[g, j], dev))
                    for j in range(h.shape[1])] for g in range(h.shape[0])],
            attn=paged_cache_from_jax(cache.attn, dev))
    k = np.asarray(cache.k)
    stacked = k.ndim == 5
    n_layers = k.shape[0] if stacked else 1

    def field(name, i):
        a = getattr(cache, name)
        if a is None:
            return None
        a = np.asarray(a)
        return _exact(a[i] if stacked else a, dev)

    return [PagedKVCache(*(field(name, i) for name in PagedKVCache._fields))
            for i in range(n_layers)]
