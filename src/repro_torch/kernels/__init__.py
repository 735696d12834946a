"""Hand-written Hopper kernels of the port, one sub-package per kernel
family of ``repro.kernels`` (``stream_scan``, ``cms_sketch``,
``segment_agg``, ``flash_attention``, ``cin``).

Each wrapper launches its CUDA kernel on a CUDA tensor and runs its plain
PyTorch version on a CPU tensor; ``_build`` compiles ``csrc/*.cu`` with
``nvcc`` for ``sm_90a`` at first use and loads it through ``ctypes``.
"""
