"""The mesh's model axis inside a forward: tensor and expert parallelism
on each rank's local shards, with explicit collectives (the port's
counterpart of what GSPMD and ``moe._apply_ep``'s shard_map do under the
reference's ``("data", "model")`` mesh).

State lives as DTensors placed by the sanitized specs (``common.P``,
``common.placements``); the forward does not run on them. DTensor has no
sharding rule for the expert dispatch's scatter into an expert-sharded
buffer (``index_put_`` raises), ``topk`` over expert-sharded router logits
all-gathers them, and a ``wk`` split mid-head has no head-local form, so
the train step hands the model plain tensors (``Layout.views``) and the
layers below split their work by this module's rules, each from the config
and the model axis size tp (the conditions under which ``sanitize_specs``
keeps the model axis on the same weights):

* heads (``heads``): tp divides H and a rank's H/tp query heads meet whole
  KV heads (H/tp a multiple of the group G = H/KV, or G a multiple of
  H/tp). A rank projects its own query heads (q heads group onto KV heads
  contiguously, ``attention._plain_attention``); when tp divides KV its
  own columns of wk/wv are its own KV heads, otherwise every rank projects
  all KV heads from the whole wk/wv and keeps the ones its query heads
  read (whole heads before the kernel: a ``wk`` split mid-head, e.g. 2 KV
  heads of 16 on a model axis of 4, is gathered as a weight). ``wo``'s rows
  are the rank's heads and its output is summed over the model axis.
* ffn (``ffn``): tp divides d_ff; w_in / w_gate columns and w_out rows.
* vocab (``vocab``): tp divides the padded vocabulary; the embedding's
  rows and the head's columns, with the cross-entropy over vocab-sharded
  logits in ``train/loss.next_token_loss_split``.
* experts (``experts``): tp divides n_experts; ``moe._apply_ep``.
* units (``units``): tp divides a layer's own count of independent units
  (the Mamba2 mixer's heads, the xLSTM's heads, the sLSTM FFN's hidden
  units); the layer runs the rank's contiguous block of them.

A layer whose split does not hold runs whole on every model rank. The
batch is split over the data axis: each data rank runs its own rows.

Collectives inside the forward are autograd Functions over a process
group: ``enter`` (identity; the backward sums the gradient over the group:
a tensor entering work split over the model axis, whose gradient each
rank holds a part of), ``reduce`` (a sum; the backward is the identity:
leaving split work, the loss after it is the same on every model rank)
and ``reduce_parts`` (a sum both ways: over the data axis, where each
rank's loss is its own part of the objective). Weights cross no collective
inside the forward: ``Layout`` gathers each step's weights from their
shards before it and turns their gradients into gradients of the shards
after it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.models import common as cm

# how the forward reads a leaf: its model-axis shard (SPLIT), or the whole
# tensor, whose gradient each model rank then holds whole (FULL) or a part
# of (FULL_SUM: the leaf feeds split work, e.g. q_norm on a rank's heads)
SPLIT, FULL, FULL_SUM = "split", "full", "full_sum"


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def whole(d) -> torch.Tensor:
    """A DTensor's whole tensor on every rank, gathered with ``all_gather``
    over each sharded mesh dim's group, innermost first (DTensor's own
    ``full_tensor`` takes a collective that gloo does not run on CUDA
    tensors: ranks sharing one card)."""
    t, mesh = d.to_local(), d.device_mesh
    for dim in reversed(range(mesh.ndim)):
        pl = d.placements[dim]
        if mesh.size(dim) > 1 and pl.is_shard():
            t = all_gather(t, pl.dim, mesh.get_group(dim))
        elif mesh.size(dim) > 1 and pl.is_partial():
            t = all_reduce(t, mesh.get_group(dim))
    return t


def own_chunk(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return t.chunk(n, dim)[r].contiguous()


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def enter(x, group):
    return _Enter.apply(x, group)


def reduce(x, group):
    return _Reduce.apply(x, group)


def reduce_parts(x, group):
    return _ReduceParts.apply(x, group)


class HeadSplit(NamedTuple):
    """A rank's share of attention: ``heads`` query heads, ``kv_heads`` KV
    heads; ``kv_lo`` is None when the rank projects its own KV heads, else
    the first of them in the whole projection."""
    heads: int
    kv_heads: int
    kv_lo: int | None
    group: Any


@dataclasses.dataclass
class ModelAxis:
    """A ``("data", "model")`` ``DeviceMesh`` as the forward sees it: the
    two axes' sizes, process groups and this rank's place on them."""
    mesh: Any

    def __post_init__(self):
        size = cm.axis_sizes(self.mesh)
        self.dp, self.tp = size.get("data", 1), size.get("model", 1)
        names = self.mesh.mesh_dim_names
        self.data_group = (self.mesh.get_group("data") if "data" in names
                           else None)
        self.model_group = (self.mesh.get_group("model") if "model" in names
                            else None)
        self.data_rank = (self.mesh.get_local_rank("data") if "data" in names
                          else 0)
        self.model_rank = (self.mesh.get_local_rank("model")
                           if "model" in names else 0)

    def heads(self, cfg) -> HeadSplit | None:
        H, KV, tp = cfg.n_heads, cfg.n_kv_heads, self.tp
        if tp == 1 or H % tp:
            return None
        hl, g = H // tp, H // KV
        if KV % tp == 0:
            return HeadSplit(hl, KV // tp, None, self.model_group)
        if hl % g and g % hl:
            return None
        return HeadSplit(hl, max(hl // g, 1), self.model_rank * hl // g,
                         self.model_group)

    def ffn(self, cfg) -> bool:
        return self.tp > 1 and cfg.d_ff % self.tp == 0

    def vocab(self, cfg) -> int | None:
        """The first vocabulary row of this rank's shard, or None."""
        V = cfg.padded_vocab
        if self.tp == 1 or V % self.tp:
            return None
        return self.model_rank * (V // self.tp)

    def experts(self, cfg) -> bool:
        return (cfg.family == "moe" and self.tp > 1
                and cfg.n_experts % self.tp == 0)

    def units(self, n: int) -> slice | None:
        """This rank's contiguous block of ``n`` units, or None (tp 1, or
        tp does not divide n)."""
        if self.tp == 1 or n % self.tp:
            return None
        k = n // self.tp
        return slice(self.model_rank * k, (self.model_rank + 1) * k)

    def data_mean(self, x):
        """The mean of ``x`` over the data ranks (a part of the objective
        on each)."""
        if self.dp == 1:
            return x
        return reduce_parts(x, self.data_group) / self.dp


_CURRENT: list = [None]


def current() -> ModelAxis | None:
    """The model axis of the forward being run, or None (one device)."""
    return _CURRENT[0]


@contextlib.contextmanager
def using(axis: ModelAxis | None):
    prev, _CURRENT[0] = _CURRENT[0], axis
    try:
        yield axis
    finally:
        _CURRENT[0] = prev


def head_split(cfg) -> HeadSplit | None:
    axis = current()
    return None if axis is None else axis.heads(cfg)


def ffn_group(cfg):
    axis = current()
    return axis.model_group if axis is not None and axis.ffn(cfg) else None


def vocab_split(cfg):
    """(first row, group) of this rank's vocabulary shard, or None."""
    axis = current()
    lo = None if axis is None else axis.vocab(cfg)
    return None if lo is None else (lo, axis.model_group)


def unit_split(n: int):
    """(slice, group) of this rank's block of ``n`` units, or None."""
    axis = current()
    sl = None if axis is None else axis.units(n)
    return None if sl is None else (sl, axis.model_group)


def data_mean(x):
    axis = current()
    return x if axis is None else axis.data_mean(x)


def gather_units(x, sl: slice, n: int, group):
    """The whole last dim (``n``) of ``x``, whose columns ``sl`` this rank
    holds, on every rank of ``group``: its columns in place, zeros
    elsewhere, summed (the backward gives each rank its columns of the
    gradient, the same on every rank after the sum)."""
    whole_x = x.new_zeros((*x.shape[:-1], n))
    whole_x[..., sl] = x
    return reduce(whole_x, group)


def embed(table, tokens, cfg):
    """``table[tokens]``: under a vocabulary split of ``cfg`` the rows of
    this rank's shard, summed over the model axis (``embed_lookup``)."""
    split = vocab_split(cfg)
    if split is None:
        return table[tokens]
    return embed_lookup(table, tokens, *split)


def vocab_logits(x, w, cfg):
    """f32 logits ``x @ w`` (w: (d, V)); under a vocabulary split of
    ``cfg``, this rank's columns (x enters the split work)."""
    split = vocab_split(cfg)
    if split is not None:
        x = enter(x, split[1])
    return cm.matmul(x, w).to(torch.float32)


def embed_lookup(table, tokens, lo: int, group):
    """Rows ``tokens`` of an embedding whose rows [lo, lo + len(table))
    this rank holds: its own rows, zeros elsewhere, summed over the
    group (one rank adds a row, the others zeros: the whole table's
    lookup, bit for bit)."""
    local = tokens - lo
    inside = (local >= 0) & (local < table.shape[0])
    x = table[local.clamp(0, table.shape[0] - 1)]
    return reduce(torch.where(inside[..., None], x, torch.zeros_like(x)),
                  group)


# ---------------------------------------------------------------------------
# the train step's weights: shards <-> the tensors the forward reads
# ---------------------------------------------------------------------------

def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, prefix + (i,))]
    return [prefix]


class _Leaf(NamedTuple):
    placements: list
    data_dim: int | None
    model_dim: int | None
    mode: str


class Layout:
    """Where each parameter of ``model`` lives on ``mesh`` (the sanitized
    ``param_specs``) and how the forward reads it (``model.param_modes``:
    each layer's module says how its own code reads its leaves; a leaf
    that has a spec and no mode, or the reverse, raises).

    ``views`` gathers a step's weights from their shards over each axis
    with more than one rank: the data axis, and the model axis unless the
    leaf is SPLIT. ``grads`` turns the gradients of those views into
    DTensor gradients of the shards: a FULL_SUM leaf's summed over the
    model axis, a FULL leaf's own model part kept, then summed over the
    data axis and the own part kept."""

    def __init__(self, model, mesh):
        cfg = model.cfg
        self.mesh, self.axis, self.cfg = mesh, ModelAxis(mesh), cfg
        from repro_torch.train.optimizer import tree_leaves

        shapes = _meta_params(model)
        self.specs = cm.sanitize_specs(shapes, model.param_specs(), mesh)
        modes = model.param_modes(self.axis)
        if _paths(modes) != _paths(self.specs):
            odd = set(_paths(modes)) ^ set(_paths(self.specs))
            raise AssertionError(f"{cfg.name}: the leaves with a mode "
                                 f"differ from those with a spec: "
                                 f"{sorted(odd, key=str)}")
        self.leaves = {}  # path -> _Leaf
        for path, spec, mode in zip(_paths(self.specs),
                                    tree_leaves(self.specs),
                                    tree_leaves(modes)):
            axes = {n: i for i, e in enumerate(spec)
                    for n in cm._axes(e)}
            if mode == SPLIT and "model" not in axes:
                raise AssertionError(f"{path}: split on the model axis but "
                                     f"its spec is {spec}")
            self.leaves[path] = _Leaf(cm.placements(spec, mesh),
                                      axes.get("data"), axes.get("model"),
                                      mode)

    def of(self, tree) -> list:
        """Each leaf's ``_Leaf``, in ``tree``'s leaf order."""
        return [self.leaves[p] for p in _paths(tree)]

    def _tree(self, like, leaves):
        from repro_torch.train.optimizer import tree_unflatten

        return tree_unflatten(like, leaves)

    def views(self, params) -> list:
        from repro_torch.train.optimizer import tree_leaves

        ax, out = self.axis, []
        for p, leaf in zip(tree_leaves(params), self.of(params)):
            t = p.to_local()
            if leaf.data_dim is not None and ax.dp > 1:
                t = all_gather(t, leaf.data_dim, ax.data_group)
            if (leaf.model_dim is not None and leaf.mode != SPLIT
                    and ax.tp > 1):
                t = all_gather(t, leaf.model_dim, ax.model_group)
            out.append(t)
        return out

    def grads(self, like, grads: list):
        """``grads`` (the views' gradients, in ``like``'s leaf order) as
        a tree like ``like`` of DTensor gradients of the shards."""
        from torch.distributed.tensor import DTensor

        ax, out = self.axis, []
        for g, leaf in zip(grads, self.of(like)):
            if leaf.mode == FULL_SUM and ax.tp > 1:
                g = all_reduce(g, ax.model_group)
            if (leaf.model_dim is not None and leaf.mode != SPLIT
                    and ax.tp > 1):
                g = own_chunk(g, leaf.model_dim, ax.model_group)
            if ax.dp > 1:
                g = all_reduce(g, ax.data_group)
                if leaf.data_dim is not None:
                    g = own_chunk(g, leaf.data_dim, ax.data_group)
            out.append(DTensor.from_local(g, self.mesh, leaf.placements,
                                          run_check=False))
        return self._tree(like, out)


def _meta_params(model):
    from repro_torch.models import model_zoo

    return model_zoo.abstract_params(model)
