"""Device resolution shared by every entry point of the port.

Entry points default to ``cuda``. Asking for CUDA where there is none is an
error: the port never falls back to the CPU on its own. A caller that wants
the CPU (the tests) passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def full_fp32_matmuls() -> None:
    """Keep float32 matmuls and convolutions out of TF32: the Hessian
    Cholesky factorisations and the sweep's error feedback need full fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``torch.device`` for ``device`` (default ``cuda``); raises when CUDA is
    asked for and unavailable."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    full_fp32_matmuls()
    return dev
