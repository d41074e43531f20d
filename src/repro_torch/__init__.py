"""PyTorch and CUDA port of ``repro`` for one NVIDIA H100.

The framework-free file-system modules (``configs``, ``core``,
``serving.engine``) are verbatim copies of their ``repro`` counterparts with
the imports rewritten; the model, the kernels and the launchers are
rewritten for PyTorch. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``. Nothing here imports ``jax`` or ``repro``.
"""
