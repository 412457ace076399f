"""Carry weights over from the reference package as numpy.

``params_from_jax`` turns the numpy leaves of the reference's
``init_params`` tree into the port's parameter dict, unstacking the
``layers`` leading axis into a list of per-layer dicts. ``vqlinear_from_jax``
does the same for one packed ``VQLinear`` (any object with the reference's
field names; uint32 words are reinterpreted as int32). Nothing here imports
jax: callers pass numpy arrays (or objects ``np.asarray`` accepts).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.vq_linear import VQLinear
from repro_torch.device import resolve_device
from repro_torch.models.common import DTYPES


def _tensor(a, dtype, device) -> torch.Tensor:
    # via float32: numpy has no bfloat16 that torch.from_numpy reads
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(
        device=device, dtype=dtype)


def _map(tree, f):
    if isinstance(tree, dict):
        return {k: _map(v, f) for k, v in tree.items()}
    return f(tree)


def params_from_jax(np_tree: dict, cfg: ModelConfig, device=None) -> dict:
    """Reference dense-family params (layers stacked on a leading axis) ->
    port params (``layers`` a list of per-layer dicts) in ``cfg.dtype``."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    out = {k: _map(v, lambda a: _tensor(a, dtype, dev))
           for k, v in np_tree.items() if k != "layers"}
    out["layers"] = [_map(np_tree["layers"],
                          lambda a, i=i: _tensor(a[i], dtype, dev))
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
