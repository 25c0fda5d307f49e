"""Serving runtime: servables, the device runtime, the micro-batcher and
the inference worker (counterpart of ``ai4e_tpu/runtime``).

The package resolves its public names on first attribute access (PEP
562), as JAX's does, so that importing one module of it (the decode
engine, the mesh vocabulary) does not import the others.
"""

import importlib

_EXPORTS = {
    "BatcherSaturated": ".batcher",
    "MicroBatcher": ".batcher",
    "FAMILIES": ".families",
    "build_servable": ".families",
    "crops_handoff": ".handoffs",
    "LadderManager": ".ladder",
    "ShapeHistogram": ".ladder",
    "derive_ladder": ".ladder",
    "ModelRuntime": ".registry",
    "ServableModel": ".registry",
    "InferenceWorker": ".worker",
    "DecodeEngine": ".decode",
    "DecodeSaturated": ".decode",
    "SlotPool": ".decode",
    "LMServable": ".kvcache",
    "PagedDecodeRuntime": ".kvcache",
    "build_lm_servable": ".kvcache",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(_EXPORTS[name], __name__)
        value = getattr(module, name)
        globals()[name] = value  # later accesses skip this hook
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
