"""PyTorch/CUDA port of the GPTVQ system (reference: the ``repro`` package).

The layout mirrors the reference module for module (``repro/core/gptvq.py``
-> ``repro_torch/core/gptvq.py``). The port imports torch and numpy only;
it never imports jax or anything of ``repro``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (see ``device.py``).
"""
