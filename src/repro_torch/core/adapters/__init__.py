"""Model-adapter registry (port of ``repro/core/adapters/__init__.py``):
the GPTVQ pipeline's only entry to block anatomy. The dense, moe and vlm
families map to ``TransformerAdapter``, ssm (xLSTM) to ``XLSTMAdapter``,
hybrid (Zamba2) to ``HybridAdapter``, audio (whisper) to
``EncDecAdapter``."""
from __future__ import annotations

from repro_torch.core.adapters.base import (  # noqa: F401 (public API)
    BlockAdapter,
    ModelAdapter,
    WeightSpec,
    acc_expert_tap,
    acc_tap,
    diag_capture,
    diag_capture_active,
    hessian_mesh,
    tree_get,
    tree_set,
)


def get_adapter(model, params) -> ModelAdapter:
    from repro_torch.models import transformer

    family = model.cfg.family
    if family == "ssm":
        from repro_torch.core.adapters.recurrent import XLSTMAdapter
        return XLSTMAdapter(model, params)
    if family == "hybrid":
        from repro_torch.core.adapters.hybrid import HybridAdapter
        return HybridAdapter(model, params)
    if family == "audio":
        from repro_torch.core.adapters.encdec import EncDecAdapter
        return EncDecAdapter(model, params)
    if family in transformer.PORTED:
        from repro_torch.core.adapters.transformer import TransformerAdapter
        return TransformerAdapter(model, params)
    raise KeyError(f"no ModelAdapter for family {family!r}")


def calib_extras(cfg, tokens, chunk_index: int = 0) -> dict:
    """Stub-frontend batch extras for families whose forward needs more
    than tokens, used by the evaluation around the quantize launcher: audio
    gets its synthesized frames (on the tokens' device); every other family
    evaluates on tokens alone (vlm on text: patches enter through the
    forward's ``patches``)."""
    if cfg.family == "audio":
        from repro_torch.core.adapters.encdec import synth_frames

        return {"frames": synth_frames(cfg, tokens.shape[0], chunk_index,
                                       device=tokens.device)}
    return {}
