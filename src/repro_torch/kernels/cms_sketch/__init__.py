"""K4a/K4b (count-min sketch update and query): CUDA kernels in
``csrc/cms_sketch.cu``, wrappers in ``kernel``, ``CMSketch`` ops in ``ops``,
plain versions in ``ref``."""

from .kernel import cms_add, cms_query, cms_update, launch_counts, reset_launch_counts  # noqa: F401
from .ops import cms_query_kernel, cms_update_kernel  # noqa: F401
from .ref import add_ref, query_ref, update_ref  # noqa: F401
