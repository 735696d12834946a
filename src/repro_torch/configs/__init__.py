"""--arch registry of the port: the architectures ported so far
(``gcn-cora``).  Any other name raises ``KeyError``, as an unknown name
does in ``repro.configs``."""
from . import gcn_cora
from .base import ArchSpec  # noqa: F401

REGISTRY = {m.ARCH.name: m.ARCH for m in (gcn_cora,)}


def get_arch(name: str) -> ArchSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]
