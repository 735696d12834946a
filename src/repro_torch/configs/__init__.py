"""--arch registry of the port: every architecture of ``repro.configs``
(the GNNs ``gcn-cora``, ``schnet``, ``egnn``, ``dimenet``, the dense LMs
``llama3-8b``, ``qwen2.5-14b``, ``qwen3-14b``, the MoE LMs
``mixtral-8x7b`` and ``mixtral-8x22b``, and the recsys model
``xdeepfm``).  Any other name raises ``KeyError``, as an unknown name
does in ``repro.configs``."""
from . import (dimenet, egnn, gcn_cora, llama3_8b, mixtral_8x7b, mixtral_8x22b, qwen2_5_14b,
               qwen3_14b, schnet, xdeepfm)
from .base import ArchSpec  # noqa: F401

REGISTRY = {m.ARCH.name: m.ARCH
            for m in (qwen2_5_14b, llama3_8b, qwen3_14b, mixtral_8x7b, mixtral_8x22b,
                      schnet, egnn, dimenet, gcn_cora, xdeepfm)}


def get_arch(name: str) -> ArchSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
