"""Mesh serving plane — a worker *is* a mesh endpoint; counterpart of
``ai4e_tpu/runtime/mesh``.

``spec`` and ``redelivery`` are stdlib-only, so the batcher's poison
contract and other device-free surfaces import them without torch;
``placement``, ``endpoint`` and ``coordinator`` are reached through the
lazy attributes below (or imported directly).
"""

from .redelivery import EndpointHealth, RowPoisoned, redeliver_poisoned
from .spec import MeshLayout, MeshSpecError, parse_mesh_spec

_LAZY = {
    "MeshEndpoint": ".endpoint",
    "MeshCoordinator": ".coordinator",
}

__all__ = [
    "EndpointHealth",
    "MeshCoordinator",
    "MeshEndpoint",
    "MeshLayout",
    "MeshSpecError",
    "RowPoisoned",
    "parse_mesh_spec",
    "redeliver_poisoned",
]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(mod, __name__), name)
