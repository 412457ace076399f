"""Adapter contracts for the family-agnostic GPTVQ pipeline (port of
``repro/core/adapters/base.py``).

  * ``ModelAdapter`` — one per model family. Owns the parameter tree during
    quantization, turns calibration token chunks into activation *states*,
    yields the ordered list of ``BlockAdapter``s, and reassembles the
    quantized tree.
  * ``BlockAdapter`` — one per quantizable block. Names the block's weight
    leaves as ``WeightSpec`` (name, path, hessian tap) triples, accumulates
    input Hessians for each tap by running the block's sub-forward
    (``capture``), receives the quantized block (``install``), and pushes a
    calibration state through the quantized block (``advance``) so
    downstream Hessians see upstream quantization error.

Inside ``diag_capture()`` every tap accumulates an O(c)
``DiagHessianState`` instead of the (c, c) Hessian (a per-expert tap,
through ``acc_expert_tap``, an (E, c) stack): the budget pre-pass reads
diag(H) only. Inside ``hessian_mesh(mesh, axis)`` every tap accumulates
through ``hessian.accumulate_sharded``: each rank of the mesh axis takes a
block of the calibration rows and one all-reduce a call merges them
(per-expert taps stay local, as the reference's).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hessian as hes


@dataclasses.dataclass(frozen=True)
class WeightSpec:
    """One quantizable weight leaf inside a block.

    path       — key path into the block's parameter tree, e.g.
                 ("attn", "wq"). The leaf is an (in, out) kernel, or an
                 (E, in, out) expert stack when ``per_expert`` is set.
    tap        — name of the Hessian tap (``capture`` output) whose
                 statistics quantize this leaf (``None``: no static tap).
                 Plain taps accumulate a ``hessian.HessianState``;
                 per-expert taps an (E, c, c) stack (or (E, c) diagonals
                 under ``diag_capture``) with (E,) routed-token counts.
    group      — "attn" or "mlp"; rule patterns can address it as
                 ``group:attn`` / ``group:mlp``.
    keep_dense — when set, the adapter declares this target dense by default
                 (the string is the reason); an explicit rule overrides it.

    The canonical recipe-visible name of a target is
    ``f"{block.prefix}.{spec.name}"``.
    """

    name: str
    path: tuple
    tap: str | None
    group: str = "attn"
    per_expert: bool = False
    keep_dense: str | None = None


class BlockAdapter:
    """Base class: one sequential block of the model."""

    name: str = "block"      # display name (progress lines, report rows)
    prefix: str = "block"    # canonical-name prefix for recipe patterns

    def params(self) -> Any:
        """Current (not yet quantized) block parameter tree."""
        raise NotImplementedError

    def targets(self) -> tuple[WeightSpec, ...]:
        raise NotImplementedError

    def capture(self, state, taps: dict, groups: frozenset) -> dict:
        """Accumulate this block's Hessian taps from one calibration state."""
        raise NotImplementedError

    def install(self, new_params) -> None:
        """Store the quantized block params (adapter-owned placement)."""
        raise NotImplementedError

    def advance(self, state):
        """Push one calibration state through the (quantized) block."""
        raise NotImplementedError


class ModelAdapter:
    """Base class: a model family's view of the quantization sweep."""

    def __init__(self, model, params):
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.params = params

    def calib_state(self, tokens: torch.Tensor, chunk_index: int = 0):
        """Embed one (B, S) calibration token chunk into the family's
        activation-state representation."""
        raise NotImplementedError

    def blocks(self) -> list[BlockAdapter]:
        raise NotImplementedError

    def finalize(self):
        """Reassemble the full parameter tree with quantized blocks."""
        raise NotImplementedError


_capture_mode = {"diag_only": False, "mesh": None, "axis": "data"}


@contextlib.contextmanager
def diag_capture():
    """Within this context, acc_tap accumulates O(c) diagonals only."""
    prev = _capture_mode["diag_only"]
    _capture_mode["diag_only"] = True
    try:
        yield
    finally:
        _capture_mode["diag_only"] = prev


def diag_capture_active() -> bool:
    return _capture_mode["diag_only"]


@contextlib.contextmanager
def hessian_mesh(mesh, axis: str = "data"):
    """Within this context, acc_tap shards calibration rows over the mesh
    axis (a ``torch.distributed`` ``DeviceMesh``) and all-reduces the
    ranks' partial Hessians."""
    prev = (_capture_mode["mesh"], _capture_mode["axis"])
    _capture_mode["mesh"], _capture_mode["axis"] = mesh, axis
    try:
        yield
    finally:
        _capture_mode["mesh"], _capture_mode["axis"] = prev


def acc_tap(taps: dict, name: str, x: torch.Tensor) -> dict:
    """Accumulate activations ``x`` (..., c) into the named Hessian tap."""
    state = taps.get(name)
    if state is None:
        c = x.shape[-1]
        state = (hes.init_diag_hessian(c, device=x.device)
                 if _capture_mode["diag_only"]
                 else hes.init_hessian(c, device=x.device))
    taps = dict(taps)
    mesh = _capture_mode["mesh"]
    if mesh is not None:
        taps[name] = hes.accumulate_sharded(state, x, mesh,
                                            _capture_mode["axis"])
    elif isinstance(state, hes.DiagHessianState):
        taps[name] = hes.accumulate_diag(state, x)
    else:
        taps[name] = hes.accumulate(state, x)
    return taps


def acc_expert_tap(taps: dict, name: str, new: tuple) -> dict:
    """Accumulate a per-expert (Hessian stack, (E,) count) pair — the
    stack is (E, c, c), or (E, c) diagonals under diag_capture()."""
    taps = dict(taps)
    acc = taps.get(name)
    taps[name] = new if acc is None else (acc[0] + new[0], acc[1] + new[1])
    return taps


def tree_get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree, path: tuple, value):
    """Copy-on-write set: shallow-copies dicts along ``path`` only."""
    if not path:
        return value
    out = dict(tree)
    out[path[0]] = tree_set(tree[path[0]], path[1:], value)
    return out


# ---------------------------------------------------------------------------
# stacking: the reference's scan form of a homogeneous block list
# ---------------------------------------------------------------------------

def _structure(tree):
    """A tree's structure with the static fields of its VQLinear leaves and
    the shape and dtype of every tensor: two blocks stack when theirs are
    equal."""
    from repro_torch.core import vq_linear as vql_mod

    if isinstance(tree, dict):
        return tuple((k, _structure(v)) for k, v in sorted(tree.items()))
    if isinstance(tree, list):
        return ("list",) + tuple(_structure(v) for v in tree)
    if isinstance(tree, vql_mod.VQLinear):
        return ("vq",) + tuple(
            (f.name, _structure(getattr(tree, f.name))
             if torch.is_tensor(getattr(tree, f.name))
             else getattr(tree, f.name))
            for f in dataclasses.fields(tree))
    return (tuple(tree.shape), tree.dtype)


def blocks_stackable(block_list: list) -> bool:
    """True when every block tree has the same structure (VQLinear static
    metadata and tensor shapes included): the reference scans such a stack.
    Mixed recipes break this (per-layer settings diverge in (k, d, band)
    metadata or leave some layers dense)."""
    s0 = _structure(block_list[0])
    return all(_structure(b) == s0 for b in block_list[1:])


def _vq_leaves(tree, out):
    from repro_torch.core import vq_linear as vql_mod

    if isinstance(tree, dict):
        for k in sorted(tree):
            _vq_leaves(tree[k], out)
    elif isinstance(tree, list):
        for v in tree:
            _vq_leaves(v, out)
    elif isinstance(tree, vql_mod.VQLinear):
        out.append(tree)
    return out


def _replace_vq(tree, new):
    from repro_torch.core import vq_linear as vql_mod

    if isinstance(tree, dict):
        return {k: _replace_vq(tree[k], new) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_replace_vq(v, new) for v in tree]
    if isinstance(tree, vql_mod.VQLinear):
        return next(new)
    return tree


def unify_rules(block_list: list) -> list:
    """When per-layer VQLinear leaves differ *only* in their ``rule``
    provenance string (e.g. layer 0 matched a by-name rule whose action
    equals the default), collapse the divergent rules to "mixed" so the
    stack stays stackable; per-target provenance stays exact in
    ``QuantizeReport.per_target`` and the checkpoint metadata."""
    def no_rule(b):
        return _structure(_replace_vq(b, iter(
            dataclasses.replace(v, rule="") for v in _vq_leaves(b, []))))

    if any(no_rule(b) != no_rule(block_list[0]) for b in block_list[1:]):
        return block_list  # the trees themselves differ
    cols = list(zip(*[_vq_leaves(b, []) for b in block_list]))
    for i, col in enumerate(cols):
        if len({v.rule for v in col}) > 1:
            cols[i] = tuple(dataclasses.replace(v, rule="mixed")
                            for v in col)
    return [_replace_vq(b, iter(c[bi] for c in cols))
            for bi, b in enumerate(block_list)]


def stack_blocks(block_list: list):
    """Stack homogeneous block trees along a new leading axis; VQLinear
    leaves keep their static metadata and stack array by array (the
    reference's scan form, and its checkpoint layout)."""
    from repro_torch.core import vq_linear as vql_mod

    b0 = block_list[0]
    if isinstance(b0, dict):
        return {k: stack_blocks([b[k] for b in block_list]) for k in b0}
    if isinstance(b0, list):
        return [stack_blocks([b[i] for b in block_list])
                for i in range(len(b0))]
    if isinstance(b0, vql_mod.VQLinear):
        return dataclasses.replace(b0, **{
            f.name: torch.stack([getattr(b, f.name) for b in block_list])
            for f in dataclasses.fields(b0)
            if torch.is_tensor(getattr(b0, f.name))})
    return torch.stack(block_list)
