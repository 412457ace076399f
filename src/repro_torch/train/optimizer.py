"""AdamW with fp32 master weights, global-norm clipping, cosine schedule
(port of ``repro/train/optimizer.py``).

State mirrors the parameter tree (dicts and lists of tensors): ``m``, ``v``
and ``master`` hold one tensor per parameter, ``step`` a 0-dim int32
tensor. ``update`` is functional, as the reference's: it returns new
tensors and leaves the state it was given as it was, so a caller may run
two steps from one state (the tests do).

Weight decay follows the reference's rank rule, ``p.ndim >= 2``, on the
reference's ranks. The reference stacks a homogeneous (dense, moe) model's
layers on a leading axis, the hybrid's Mamba trunk on two (groups,
layers) and the audio family's encoder and decoder layers on one, so there
every per-layer leaf, norm scales and biases included, has rank >= 2 and
is decayed; the port keeps layers in lists, where the same norm scale is
1-D. ``decay_mask`` gives the reference's answer for the port's tree, and
``update`` applies it: its caller says with ``stacked_layers`` whether the
reference stacks the model's layer lists (``STACKS``).

On a mesh the state's leaves are DTensors (``models/parallel.Layout``):
``init`` makes m, v and master with the parameters' placements and the
step a replicated DTensor, ``update`` runs elementwise on the shards and
``global_norm`` sums the squares of the shards each rank owns, then over
the mesh.
``state_specs`` gives the state's specs from the parameters'.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models import common as cm
from repro_torch.obs import work


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any
    master: Any  # fp32 master copy of (possibly bf16) params


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # storage dtype of the m/v moment buffers: "float32" or "bfloat16"
    # (the math stays f32)
    moment_dtype: str = "float32"
    # dtype of the microbatch gradient accumulator (train_step)
    grad_accum_dtype: str = "float32"


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterable ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    return build(like)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params, cfg: OptConfig | None = None) -> AdamWState:
    mdt = _DTYPES[cfg.moment_dtype if cfg else "float32"]
    flat = tree_leaves(params)

    def zeros():
        return tree_unflatten(params, [torch.zeros_like(p, dtype=mdt)
                                       for p in flat])

    step = torch.zeros((), dtype=torch.int32,
                       device=flat[0].device if flat else None)
    if flat and cm.is_dtensor(flat[0]):  # replicated on the parameters' mesh
        from torch.distributed.tensor import Replicate

        mesh = flat[0].device_mesh
        step = cm.place(step, mesh, [Replicate()] * mesh.ndim)
    return AdamWState(
        step=step, m=zeros(), v=zeros(),
        master=tree_unflatten(params, [p.to(torch.float32) for p in flat]),
    )


def _sharded_squares(leaves) -> torch.Tensor:
    """The sum of squares of DTensor leaves on one mesh: each rank sums
    the shards it owns (a replicated shard counts on the ranks at
    coordinate 0 of the mesh dims it is replicated over), then one sum
    over each mesh dim."""
    import torch.distributed as dist

    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].to_local().device)
    for g in leaves:
        if all(c == 0 for c, pl in zip(coord, g.placements)
               if pl.is_replicate()):
            total = total + torch.sum(torch.square(
                g.to_local().to(torch.float32)))
    for dim in range(mesh.ndim):
        work.collective("all-reduce", mesh.get_group(dim), 4)
        dist.all_reduce(total, group=mesh.get_group(dim))
    return total


def global_norm(tree) -> torch.Tensor:
    flat = tree_leaves(tree)
    if flat and cm.is_dtensor(flat[0]):
        return torch.sqrt(_sharded_squares(flat))
    total = 0
    for g in flat:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


# the top-level keys of the layer lists the reference stacks: a homogeneous
# dense or moe model's "layers", the hybrid's "mamba" trunk, audio's two
STACKS = ("layers", "mamba", "enc_layers", "dec_layers")


def decay_mask(params, stacked_layers: bool):
    """Whether the reference decays each leaf: rank >= 2 in its tree. With
    ``stacked_layers`` (the reference stacks the model's layer lists) a
    leaf under one of ``STACKS`` has at least one more axis there than
    here."""
    def mask(tree, extra):
        return tree_unflatten(tree, [p.dim() + extra >= 2
                                     for p in tree_leaves(tree)])

    return {k: mask(v, 1 if stacked_layers and k in STACKS else 0)
            for k, v in params.items()}


def update(cfg: OptConfig, grads, state: AdamWState, param_dtype=None, *,
           stacked_layers: bool):
    """Returns (new_params, new_state, metrics). ``stacked_layers``: whether
    the reference stacks ``params["layers"]`` (``decay_mask``), which
    decides the leaves that take weight decay."""
    step = state.step + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=t.device), t)
    mdt = _DTYPES[cfg.moment_dtype]

    def upd(g, m, v, p, dec):
        g = g.to(torch.float32) * scale
        m_f = b1 * m.to(torch.float32) + (1 - b1) * g
        v_f = b2 * v.to(torch.float32) + (1 - b2) * g * g
        u = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
        # decoupled weight decay (skip norms/biases, by the reference's rank)
        wd = cfg.weight_decay if dec else 0.0
        p = p - lr * (u + wd * p)
        return m_f.to(mdt), v_f.to(mdt), p

    flat_p = tree_leaves(state.master)
    flat_d = tree_leaves(decay_mask(state.master, stacked_layers))
    out = [upd(*a) for a in zip(tree_leaves(grads), tree_leaves(state.m),
                                tree_leaves(state.v), flat_p, flat_d)]
    new_m = tree_unflatten(grads, [o[0] for o in out])
    new_v = tree_unflatten(grads, [o[1] for o in out])
    new_master = tree_unflatten(grads, [o[2] for o in out])
    new_params = tree_unflatten(grads, [
        o[2] if param_dtype is None else o[2].to(param_dtype) for o in out])
    new_state = AdamWState(step=step, m=new_m, v=new_v, master=new_master)
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}


def state_specs(param_specs) -> AdamWState:
    """The optimizer state's specs (the reference's): the step replicated,
    m, v and master with the parameters' specs."""
    return AdamWState(step=cm.P(), m=param_specs, v=param_specs,
                      master=param_specs)
