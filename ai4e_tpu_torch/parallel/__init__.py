"""Parallel plane (counterpart of ``ai4e_tpu/parallel``): device meshes over
``torch.distributed``, parameter sharding, ring and Ulysses attention, the
multi-process serving bridge. Every collective lives in ``comm``."""

from .sharding import (
    AXES,
    MeshSpec,
    batch_sharding,
    init_distributed,
    make_mesh,
    pad_to_multiple,
    replicated,
    shard_params,
    spec_for_param,
)

__all__ = [
    "AXES",
    "MeshSpec",
    "batch_sharding",
    "init_distributed",
    "make_mesh",
    "pad_to_multiple",
    "replicated",
    "shard_params",
    "spec_for_param",
]
