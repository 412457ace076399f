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

The diagonal-only capture mode and mesh-sharded accumulation of the
reference are not ported yet (ROADMAP.md queue 1, "Budgets and solvers" and
"Multi-device and training").
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hessian as hes


@dataclasses.dataclass(frozen=True)
class WeightSpec:
    """One quantizable weight leaf inside a block.

    path       — key path into the block's parameter tree, e.g.
                 ("attn", "wq"); the leaf is an (in, out) kernel.
    tap        — name of the Hessian tap (``capture`` output) whose
                 statistics quantize this leaf (``None``: no static tap).
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


def acc_tap(taps: dict, name: str, x: torch.Tensor) -> dict:
    """Accumulate activations ``x`` (..., c) into the named Hessian tap."""
    state = taps.get(name)
    if state is None:
        state = hes.init_hessian(x.shape[-1], device=x.device)
    taps = dict(taps)
    taps[name] = hes.accumulate(state, x)
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
