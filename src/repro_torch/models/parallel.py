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
after it. On a mesh with a pod axis the data axis is pod and data
together (``widen_fsdp``, ``axes_group``).

A serving step (``serve_step.make_prefill`` / ``make_decode(axis=)``)
runs under ``serve_axis``: its parameters are each model rank's reads
(``Layout.rank_params``: a SPLIT leaf's shard, ``VQLinear`` leaves cut by
``vq_linear.shard``), whole over the data axis; its batch the data rank's
rows (``rank_rows``); its dense caches each rank's part by the dry run's
placements (``rank_tree``, ``CacheSplit``): the KV heads over ``model``,
or the sequence over a group, each rank attending over its own positions
and the softmax merged over the group (``merge_softmax``), with
attention's projections whole. The recurrent mixers carry their state
and run whole. Collectives are counted by ``obs.work`` when a count is
on.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.models import common as cm
from repro_torch.obs import work

# how the forward reads a leaf: its model-axis shard (SPLIT), or the whole
# tensor, whose gradient each model rank then holds whole (FULL) or a part
# of (FULL_SUM: the leaf feeds split work, e.g. q_norm on a rank's heads)
SPLIT, FULL, FULL_SUM = "split", "full", "full_sum"


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    t = t.contiguous().clone()
    work.collective("all-reduce", group, work.nbytes(t))
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    t = t.contiguous()
    n = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(n)]
    work.collective("all-gather", group, n * work.nbytes(t))
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


class CacheSplit(NamedTuple):
    """How a serving step's ranks hold the attention K/V caches (the
    dry run's policy, ``launch/dryrun.cache_shardings``): ``heads``, each
    model rank its own KV heads; and/or the sequence over ``seq_group``
    (``seq_n`` ranks; this one, ``seq_rank``, holds the positions
    [seq_rank * S_local, (seq_rank + 1) * S_local) of every row it
    holds)."""
    heads: bool
    seq_group: Any = None
    seq_n: int = 1
    seq_rank: int = 0


class HeadSplit(NamedTuple):
    """A rank's share of attention: ``heads`` query heads, ``kv_heads`` KV
    heads; ``kv_lo`` is None when the rank projects its own KV heads, else
    the first of them in the whole projection."""
    heads: int
    kv_heads: int
    kv_lo: int | None
    group: Any


def axes_group(mesh, names: tuple):
    """(process group, size, this rank's index) of the mesh axes
    ``names`` taken together, the first outermost."""
    if len(names) == 1:
        return (mesh.get_group(names[0]), mesh.size(
            mesh.mesh_dim_names.index(names[0])),
            mesh.get_local_rank(names[0]))
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():  # the mesh's own tensors stay real
        flat = mesh[tuple(names)]._flatten()
    return flat.get_group(), flat.size(), flat.get_local_rank()


@dataclasses.dataclass
class ModelAxis:
    """A ``("data", "model")`` (or ``("pod", "data", "model")``)
    ``DeviceMesh`` as the forward sees it: the two axes' sizes, process
    groups and this rank's place on them; with a pod axis, the data axis
    is pod and data together (the reference's FSDP over ``("pod",
    "data")``). ``cache`` (a serving step's): how the ranks hold the
    attention caches; a serving step's recurrent mixers carry their state
    and run whole on every model rank, and where the caches split the
    sequence, attention's projections run whole too."""
    mesh: Any
    cache: CacheSplit | None = None

    def __post_init__(self):
        size = cm.axis_sizes(self.mesh)
        names = self.mesh.mesh_dim_names
        self.tp = size.get("model", 1)
        self.model_group = (self.mesh.get_group("model") if "model" in names
                            else None)
        self.model_rank = (self.mesh.get_local_rank("model")
                           if "model" in names else 0)
        dp_names = tuple(n for n in ("pod", "data") if n in names)
        self.data_group, self.dp, self.data_rank = None, 1, 0
        if dp_names:
            self.data_group, self.dp, self.data_rank = axes_group(
                self.mesh, dp_names)

    def groups(self) -> dict:
        """{process group: axis name} of this axis' groups (the pod and
        data axes together are "data"), for ``obs.work.counting``."""
        out = {self.data_group: "data", self.model_group: "model"}
        if self.cache is not None and self.cache.seq_group is not None:
            out.setdefault(self.cache.seq_group, "data_model")
        return {g: n for g, n in out.items() if g is not None}

    def heads(self, cfg) -> HeadSplit | None:
        H, KV, tp = cfg.n_heads, cfg.n_kv_heads, self.tp
        if tp == 1 or H % tp:
            return None
        if self.cache is not None and not self.cache.heads:
            return None  # a sequence-split cache: projections whole
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
        """This rank's contiguous block of ``n`` units, or None (tp 1, tp
        does not divide n, or a serving step: its mixers run whole)."""
        if self.tp == 1 or n % self.tp or self.cache is not None:
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


def cache_split() -> CacheSplit | None:
    """How the serving step being run holds its attention caches, or
    None (one device, or a train step)."""
    axis = current()
    return None if axis is None else axis.cache


def merge_softmax(o, m, l, group):
    """Attention's output from each rank's part of the keys: ``o`` (B, S,
    H, hd) the rank's sum of p @ v, ``m`` (B, S, H) its rows' max score and
    ``l`` its sum of p (``attention._partial_attention``), rescaled to the
    group's max and summed over the group, then normalised (the merge of
    ``paged_attention``'s split-KV, over ranks). f32."""
    big = all_reduce(m, group, op=dist.ReduceOp.MAX)
    scale = torch.exp(m - big)
    lsum = all_reduce(l * scale, group)
    osum = all_reduce(o * scale[..., None], group)
    return osum / lsum[..., None]


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

    def __init__(self, model, mesh, axis: ModelAxis | None = None):
        cfg = model.cfg
        self.mesh, self.cfg = mesh, cfg
        self.axis = ModelAxis(mesh) if axis is None else axis
        from repro_torch.train.optimizer import tree_leaves

        shapes = _meta_params(model)
        self.specs = cm.sanitize_specs(
            shapes, widen_fsdp(model.param_specs(), mesh), mesh)
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

    def rank_params(self, params):
        """A serving step's parameters on this rank, from the whole
        ``params`` (dense, ``VQLinear`` or ``FusedVQLinear`` leaves): each
        leaf the forward reads as its model-axis shard (SPLIT) cut to it
        (``shard``), the others whole; every leaf whole over the data
        axis."""
        from repro_torch.train.optimizer import tree_leaves

        ax, out = self.axis, []
        for p, leaf in zip(tree_leaves(params), self.of(params)):
            if (leaf.mode == SPLIT and leaf.model_dim is not None
                    and ax.tp > 1):
                p = shard(p, leaf.model_dim, ax.tp, ax.model_rank)
            out.append(p)
        return self._tree(params, out)

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


def widen_fsdp(specs, mesh):
    """On a mesh with a pod axis, FSDP shards over ``("pod", "data")``
    (the reference's rule: the pod axis would otherwise be pure
    replication for parameters and optimizer state)."""
    if "pod" not in mesh.mesh_dim_names:
        return specs

    def fix(s):
        if isinstance(s, dict):
            return {k: fix(v) for k, v in s.items()}
        if isinstance(s, cm.P):
            return cm.P(*[("pod", "data") if ax == "data" else ax
                          for ax in s])
        if isinstance(s, list):
            return [fix(v) for v in s]
        if hasattr(s, "_fields"):
            return type(s)(*(fix(v) for v in s))
        return s

    return fix(specs)


def shard(t, dim: int, n: int, i: int):
    """Part ``i`` of ``n`` of a parameter along its dense dim ``dim``, in
    storage of its own: a tensor's chunk, or a VQ leaf's
    (``vq_linear.shard``: a dense (..., in, out) leaf's out dim is the VQ
    rows, its in dim the column groups, a leading dim the experts)."""
    from repro_torch.core import vq_linear as vql

    if isinstance(t, (vql.VQLinear, vql.FusedVQLinear)):
        return vql.shard(t, dim, n, i)
    return t.chunk(n, dim)[i].clone(memory_format=torch.contiguous_format)


def serve_axis(mesh, kv_spec) -> ModelAxis:
    """The model axis of a serving step whose attention K/V leaves (B, S,
    KV, hd) are placed by the sanitized spec ``kv_spec``: heads split when
    the spec puts KV over ``model``; the sequence over the axes it puts S
    on."""
    kv_spec = tuple(kv_spec) + (None,) * (4 - len(kv_spec))
    heads = "model" in cm._axes(kv_spec[2])
    seq = cm._axes(kv_spec[1])
    if not seq:
        return ModelAxis(mesh, CacheSplit(heads))
    group, n, r = axes_group(mesh, seq)
    return ModelAxis(mesh, CacheSplit(heads, group, n, r))


def local_part(t, spec, mesh):
    """This rank's part of ``t`` (the whole tensor) by the sanitized
    ``spec`` on ``mesh``, in storage of its own: each dim cut over the
    axes the spec names there, the first outermost (DTensor's order of
    ``common.placements``)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    size = cm.axis_sizes(mesh)
    for d, entry in enumerate(spec or ()):
        names = cm._axes(entry)
        if not names:
            continue
        n, r = 1, 0
        for name in names:
            n, r = n * size[name], r * size[name] + coord[name]
        t = t.chunk(n, d)[r]
    return t.clone(memory_format=torch.contiguous_format)


def rank_tree(tree, specs, mesh):
    """``local_part`` of every leaf of ``tree`` (dicts, lists and
    NamedTuples, as a cache) by its spec in ``specs``; None stays None."""
    if isinstance(tree, dict):
        return {k: rank_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(rank_tree(a, b, mesh) for a, b in zip(tree, specs))
    if hasattr(tree, "_fields"):
        return type(tree)(*(rank_tree(a, b, mesh)
                            for a, b in zip(tree, specs)))
    return None if tree is None else local_part(tree, specs, mesh)


def rank_rows(batch: dict, axis: ModelAxis) -> dict:
    """A serving step's rows of ``batch`` on a data rank: its block of the
    rows where the data ranks divide them, else all of them (the
    reference's ``batch_sharding``)."""
    def rows(x):
        if x.shape[0] % axis.dp:
            return x
        return x.chunk(axis.dp, 0)[axis.data_rank].contiguous()

    return {k: rows(x) for k, x in batch.items()}


def _meta_params(model):
    from repro_torch.models import model_zoo

    return model_zoo.abstract_params(model)
