"""Carry weights over from the reference package as numpy.

``params_from_jax`` turns the numpy leaves of the reference's
``init_params`` tree into the port's parameter dict, unstacking the
``layers`` leading axis into a list of per-layer dicts (a MoE layer's
expert stacks (E, D, F) stay stacked inside its dict; the xLSTM's layers
are a list already). The leaves the reference keeps in f32 (the MoE
router, the mLSTM gate projections) stay f32. ``vqlinear_from_jax`` does the same for
one packed ``VQLinear`` (any object with the reference's field names, an
expert stack's arrays with their leading E; uint32 words are reinterpreted
as int32), and
``paged_cache_from_jax`` for a reference ``PagedKVCache`` (pools, scales,
codebooks, page table). Nothing here imports jax: callers pass numpy arrays
(or objects ``np.asarray`` accepts).
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
# kind: the MoE router and the mLSTM's exponential-gate projections
_F32_LEAVES = {"moe": {("ffn", "router")},
               "mlstm": {("core", w) for w in ("w_i", "w_f", "b_i", "b_f")}}


def _map(tree, f, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, f, path + (k,)) for k, v in tree.items()}
    return f(tree, path)


def params_from_jax(np_tree: dict, cfg: ModelConfig, device=None) -> dict:
    """Reference params -> port params (``layers`` a list of per-layer
    dicts) in ``cfg.dtype``, the leaves the reference keeps in f32 in f32.
    The reference's ``layers`` is stacked on a leading axis (dense, moe,
    vlm) or already a list of per-layer dicts (the xLSTM's mLSTM/sLSTM
    mix, whose sLSTM ``r_*`` leaves are (H, hd, hd) stacks)."""
    from repro_torch.models.transformer import block_kind

    dev = resolve_device(device)

    def conv(tree, kind=None):
        f32 = _F32_LEAVES.get(kind, ())
        return _map(tree, lambda a, path: _tensor(
            a, torch.float32 if path in f32 else DTYPES[cfg.dtype], dev))

    out = {k: conv(v) for k, v in np_tree.items() if k != "layers"}
    layers = np_tree["layers"]
    if not isinstance(layers, list):
        layers = [_map(layers, lambda a, _, i=i: a[i])
                  for i in range(cfg.n_layers)]
    out["layers"] = [conv(lp, block_kind(cfg, i))
                     for i, lp in enumerate(layers)]
    return out


def vqlinear_from_jax(vql, device=None) -> VQLinear:
    """A reference ``VQLinear`` (fields as arrays) -> the port's VQLinear."""
    dev = resolve_device(device)

    def arr(name, np_dtype, torch_dtype):
        a = np.ascontiguousarray(np.asarray(getattr(vql, name)))
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


def paged_cache_from_jax(cache, device=None) -> list[PagedKVCache]:
    """A reference ``PagedKVCache`` (fields as arrays; pools with a leading
    layer axis, as the reference's scanned stacks hold them, or a single
    layer's) -> the port's per-layer list, bit for bit."""
    dev = resolve_device(device)
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
