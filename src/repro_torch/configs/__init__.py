"""--arch registry of the port: the architectures ported so far
(``gcn-cora``, the dense LMs ``llama3-8b``, ``qwen2.5-14b``,
``qwen3-14b``, and the recsys model ``xdeepfm``).  Any other name raises
``KeyError``, as an unknown name does in ``repro.configs``; the Mixtral
configs wait for the MoE slice."""
from . import gcn_cora, llama3_8b, qwen2_5_14b, qwen3_14b, xdeepfm
from .base import ArchSpec  # noqa: F401

REGISTRY = {m.ARCH.name: m.ARCH
            for m in (qwen2_5_14b, llama3_8b, qwen3_14b, gcn_cora, xdeepfm)}


def get_arch(name: str) -> ArchSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
