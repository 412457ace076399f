"""Model-adapter registry (port of ``repro/core/adapters/__init__.py``):
the GPTVQ pipeline's only entry to block anatomy. Only the dense family is
ported; the other five wait for ROADMAP.md queue 1, "The other five
families"."""
from __future__ import annotations

from repro_torch.core.adapters.base import (  # noqa: F401 (public API)
    BlockAdapter,
    ModelAdapter,
    WeightSpec,
    acc_tap,
    diag_capture,
    diag_capture_active,
    tree_get,
    tree_set,
)

_PENDING = ("moe", "vlm", "ssm", "hybrid", "audio")


def get_adapter(model, params) -> ModelAdapter:
    family = model.cfg.family
    if family == "dense":
        from repro_torch.core.adapters.transformer import TransformerAdapter
        return TransformerAdapter(model, params)
    if family in _PENDING:
        raise NotImplementedError(
            f"family {family!r} is not ported yet (ROADMAP.md queue 1, "
            "'The other five families')")
    raise KeyError(f"no ModelAdapter for family {family!r}")
