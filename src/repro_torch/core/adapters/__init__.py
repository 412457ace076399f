"""Model-adapter registry (port of ``repro/core/adapters/__init__.py``):
the GPTVQ pipeline's only entry to block anatomy. The dense and moe
families map to ``TransformerAdapter``; the other four wait for
ROADMAP.md queue 1, "The other five families"."""
from __future__ import annotations

from repro_torch.core.adapters.base import (  # noqa: F401 (public API)
    BlockAdapter,
    ModelAdapter,
    WeightSpec,
    acc_expert_tap,
    acc_tap,
    diag_capture,
    diag_capture_active,
    tree_get,
    tree_set,
)


def get_adapter(model, params) -> ModelAdapter:
    from repro_torch.models import transformer

    family = model.cfg.family
    if family in transformer.PORTED:
        from repro_torch.core.adapters.transformer import TransformerAdapter
        return TransformerAdapter(model, params)
    if family in transformer.PENDING:
        transformer._check_family(model.cfg)  # raises, naming them
    raise KeyError(f"no ModelAdapter for family {family!r}")
