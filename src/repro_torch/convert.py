"""Carry weights over from the reference package as numpy.

``params_from_jax`` turns the numpy leaves of the reference's
``init_params`` tree into the port's parameter dict, unstacking the
``layers`` leading axis into a list of per-layer dicts (a MoE layer's
expert stacks (E, D, F) stay stacked inside its dict, and its router stays
f32, as the reference keeps it). ``vqlinear_from_jax`` does the same for
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


# leaves the reference keeps in f32 whatever the model's dtype
_F32_LEAVES = ("router",)


def _map(tree, f, key=None):
    if isinstance(tree, dict):
        return {k: _map(v, f, k) for k, v in tree.items()}
    return f(tree, key)


def params_from_jax(np_tree: dict, cfg: ModelConfig, device=None) -> dict:
    """Reference dense- or moe-family params (layers stacked on a leading
    axis) -> port params (``layers`` a list of per-layer dicts) in
    ``cfg.dtype``, the router in f32."""
    dev = resolve_device(device)

    def conv(a, key):
        dtype = (torch.float32 if key in _F32_LEAVES
                 else DTYPES[cfg.dtype])
        return _tensor(a, dtype, dev)

    out = {k: _map(v, conv, k) for k, v in np_tree.items() if k != "layers"}
    out["layers"] = [_map(np_tree["layers"],
                          lambda a, key, i=i: conv(a[i], key))
                     for i in range(cfg.n_layers)]
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
