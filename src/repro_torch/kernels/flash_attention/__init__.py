"""K6 (flash attention forward, GQA with position masks): CUDA kernel in
``csrc/flash_attention.cu``, wrapper in ``kernel``, model-layout entry point
in ``ops``, plain versions in ``ref``."""

from .kernel import flash_attention_fwd, launch_counts, reset_launch_counts  # noqa: F401
from .ops import flash_attention  # noqa: F401
from .ref import attention_ref, flash_attention_ref  # noqa: F401
