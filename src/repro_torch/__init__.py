"""PyTorch/CUDA port of the S5P reproduction (the JAX package ``repro`` is
the reference).

The layout mirrors ``repro``: ``repro_torch/core/clustering.py`` is the
counterpart of ``repro/core/clustering.py`` and so on.  Every entry point
takes ``device=`` and runs on ``cuda`` unless the caller passes
``device="cpu"``; the tensor's device decides whether a kernel wrapper
launches its hand-written Hopper kernel (CUDA) or runs its plain PyTorch
version (CPU).  The package imports neither ``jax`` nor ``repro``.
"""

from ._device import resolve_device  # noqa: F401
