"""K4a/K4b (count-min sketch update and query): CUDA kernels in
``csrc/cms_sketch.cu``, wrappers in ``kernel``, plain versions in ``ref``."""

from .kernel import cms_query, cms_update, launch_counts, reset_launch_counts  # noqa: F401
from .ref import query_ref, update_ref  # noqa: F401
