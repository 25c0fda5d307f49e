"""Device mesh + sharding helpers over ``torch.distributed`` — counterpart
of ``ai4e_tpu/parallel/sharding.py``.

One rank of ``torch.distributed`` is one device of the mesh. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the named axes in the
JAX package's order, ``("dp", "fsdp", "ep", "sp", "tp")``, ``tp``
innermost, so a rank's coordinates are the digits of its rank in that
mixed radix (``rank_coords``):

- ``dp``/``fsdp``: the batch dimension, split over dp x fsdp data
  coordinates (``data_index``); every rank of one data coordinate holds
  that coordinate's rows;
- ``tp``: feature dimensions (the ViT's megatron split);
- ``sp``: the sequence dimension (ring and Ulysses attention);
- ``ep``: the experts of a MoE layer.

Where XLA places parameters by ``NamedSharding`` and inserts the
collectives, the port keeps each rank's local shard of every parameter
(``shard_params`` on a flax-shaped tree, ``shard_module_`` on a module in
place), and the models call the collectives themselves, all of them in
``parallel/comm.py``. A parameter spec is the port's own: a tuple with one
entry a dimension, each ``None`` (replicated) or an axis name or a tuple of
axis names (split over their product, the first outermost), as
``PartitionSpec`` reads.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import re

import numpy as np
import torch

log = logging.getLogger("ai4e_tpu_torch.parallel")

AXES = ("dp", "fsdp", "tp", "sp", "ep")
#: The mesh's dimension order: tp innermost, then sp (JAX's ``make_mesh``).
MESH_AXES = ("dp", "fsdp", "ep", "sp", "tp")
#: The axes the batch dimension splits over.
BATCH_AXES = ("dp", "fsdp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Zero/one-sized axes are kept in the mesh (size 1)
    so specs naming them always resolve."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.ep

    @classmethod
    def data_parallel(cls, n_devices: int) -> "MeshSpec":
        return cls(dp=n_devices)

    @classmethod
    def auto(cls, n_devices: int, model_parallel: int = 1,
             sequence_parallel: int = 1) -> "MeshSpec":
        """Fill dp with whatever model/sequence parallelism leaves over."""
        denom = model_parallel * sequence_parallel
        if n_devices % denom:
            raise ValueError(
                f"{n_devices} devices not divisible by tp*sp={denom}")
        return cls(dp=n_devices // denom, tp=model_parallel,
                   sp=sequence_parallel)


# -- the process group -------------------------------------------------------

def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0 (or the only process) fronts the worker's HTTP surface."""
    return process_index() == 0


def init_distributed(device=None) -> bool:
    """Join the process group that ``MASTER_ADDR``/``MASTER_PORT``/
    ``WORLD_SIZE``/``RANK`` name (``init_method="env://"``); a no-op that
    returns False for one process (``WORLD_SIZE`` unset or 1). ``device``
    is the device this rank computes on: where it is CUDA and every rank
    has a card of its own, CUDA tensors move by NCCL
    (``"cpu:gloo,cuda:nccl"``); otherwise every collective runs on gloo,
    and ``comm`` stages CUDA tensors through host memory (NCCL refuses two
    ranks on one card). Returns True once the group is up."""
    import torch.distributed as dist

    from . import comm

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    dev = torch.device(device) if device is not None else torch.device("cpu")
    own_cards = dev.type == "cuda" and torch.cuda.device_count() >= world
    backend = "cpu:gloo,cuda:nccl" if own_cards else "gloo"
    rank = int(os.environ["RANK"])
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank)
    comm.set_backend(backend)
    log.info("torch.distributed up: %d processes, this is %d (%s)", world,
             rank, backend)
    return True


def rank_device(device) -> torch.device:
    """The device of this rank for a requested ``device``: ``cuda`` becomes
    ``cuda:<LOCAL_RANK (else RANK) mod the cards present>``; anything else
    is returned as it is."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or dev.index is not None or process_count() == 1:
        return dev
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


# -- the mesh ----------------------------------------------------------------

def make_mesh(spec: MeshSpec | None = None, device_type: str | None = None):
    """The named ``DeviceMesh`` over every rank of the process group;
    default: all ranks on ``dp``. The spec must cover exactly the ranks
    present. ``device_type`` defaults to ``cuda`` where CUDA is available
    and the CPU otherwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = process_count()
    if spec is None:
        spec = MeshSpec.data_parallel(world)
    if spec.size != world:
        raise ValueError(f"mesh spec {spec} needs {spec.size} ranks, "
                         f"got {world}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "init_distributed (WORLD_SIZE, RANK, MASTER_ADDR, "
                           "MASTER_PORT) first")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    shape = tuple(getattr(spec, axis) for axis in MESH_AXES)
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=MESH_AXES)


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a mesh (every axis 1 for ``None``)."""
    if mesh is None:
        return {axis: 1 for axis in MESH_AXES}
    return {axis: int(mesh.size(i)) for i, axis in enumerate(MESH_AXES)}


def axis_size(mesh, *axes: str) -> int:
    """The product of the sizes of ``axes`` (1 without a mesh)."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes)


def rank_coords(mesh, rank: int | None = None) -> dict[str, int]:
    """A rank's coordinate on every axis (this rank's by default)."""
    rank = process_index() if rank is None else rank
    shape = mesh_shape(mesh)
    coords = {}
    for axis in reversed(MESH_AXES):
        rank, coords[axis] = divmod(rank, shape[axis])
    return coords


def axis_index(mesh, *axes: str, rank: int | None = None) -> int:
    """A rank's index along the product of ``axes``, the first outermost
    (0 without a mesh)."""
    shape, coords = mesh_shape(mesh), rank_coords(mesh, rank)
    index = 0
    for axis in axes:
        index = index * shape[axis] + coords[axis]
    return index


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def axes_group(mesh, *axes: str):
    """The process group of this rank's ranks along the product of
    ``axes`` (the first outermost); ``None`` where that product is 1. A
    group over one axis of size > 1 is the mesh's own; one over several is
    made anew with ``new_group``, a collective call (every rank builds
    every line of the product, in the same order): callers keep it."""
    import torch.distributed as dist

    live = [a for a in axes if axis_size(mesh, a) > 1]
    if not live:
        return None
    if len(live) == 1:
        return axis_group(mesh, live[0])
    mine = None
    lines: dict[tuple, list[int]] = {}
    for rank in range(process_count()):
        coords = rank_coords(mesh, rank)
        rest = tuple(coords[a] for a in MESH_AXES if a not in live)
        lines.setdefault(rest, []).append(rank)
    for ranks in lines.values():
        ranks.sort(key=lambda r: axis_index(mesh, *live, rank=r))
        group = dist.new_group(ranks)
        if process_index() in ranks:
            mine = group
    return mine


def data_group(mesh):
    """The group a data-parallel gradient is averaged over: dp x fsdp
    (``None`` where both are 1)."""
    return axes_group(mesh, *BATCH_AXES)


def data_axis_size(mesh) -> int:
    return axis_size(mesh, *BATCH_AXES)


def data_index(mesh, rank: int | None = None) -> int:
    """The data coordinate (dp x fsdp) a rank computes the rows of."""
    return axis_index(mesh, *BATCH_AXES, rank=rank)


def row_range(mesh, batch: int, rank: int | None = None) -> tuple[int, int]:
    """The dim-0 rows ``[start, stop)`` of a ``batch``-row batch that a rank
    holds: its data coordinate's equal share (``batch`` a multiple of the
    data axes' size). Replicated axes (tp, sp, ep) hold the same rows."""
    n = data_axis_size(mesh)
    if batch % n:
        raise ValueError(f"batch {batch} does not split over {n} data "
                         f"coordinates")
    per = batch // n
    start = data_index(mesh, rank) * per
    return start, start + per


# -- specs -------------------------------------------------------------------

def batch_sharding(mesh, ndim: int = 2) -> tuple:
    """Spec of a batch: the leading dim over dp+fsdp, the rest replicated."""
    return (BATCH_AXES,) + (None,) * (ndim - 1)


def replicated(mesh) -> tuple:
    return ()


def _joined(path) -> str:
    return "/".join(str(p) for p in path)


def spec_for_param(path: tuple, value, tp_rules=None) -> tuple:
    """Spec for one parameter by name-path match (``path`` the flax path's
    parts). Two rule forms, both first-match-wins on the ``/``-joined path:

    - ``dict`` — substring -> spec. No match: replicate.
    - ``list``/``tuple`` of ``(regex, spec)`` pairs — ``re.search`` per rule
      in order. Scalar (rank-0) leaves always replicate without consulting
      the rules; a non-scalar leaf NO rule matches raises ValueError: a
      regex rule set is a complete declaration. End the list with
      ``(".*", ())`` to replicate by default.

    Returns the spec as a tuple (empty: replicated)."""
    if isinstance(tp_rules, (list, tuple)):
        if not hasattr(value, "ndim") or value.ndim == 0:
            return ()
        joined = _joined(path)
        for pattern, spec in tp_rules:
            if re.search(pattern, joined):
                return tuple(spec)
        raise ValueError(
            f"no partition rule matches param {joined!r} — regex rule sets "
            f"must be complete (add a ('.*', ()) catch-all to replicate)")
    if tp_rules:
        joined = _joined(path)
        for needle, spec in tp_rules.items():
            if needle in joined:
                return tuple(spec)
    return ()


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _narrow(leaf, dim: int, parts: int, index: int, groups: int = 1):
    """Chunk ``index`` of ``parts`` equal chunks of ``leaf`` along ``dim``;
    with ``groups`` > 1 the dim is first cut into that many equal groups
    and each is chunked alike (a fused q/k/v projection split by heads)."""
    size = leaf.shape[dim]
    if size % (parts * groups):
        raise ValueError(f"dim {dim} of size {size} does not split into "
                         f"{parts} parts of {groups} groups")
    shape = tuple(leaf.shape)
    grouped = shape[:dim] + (groups, size // groups) + shape[dim + 1:]
    chunk = size // groups // parts
    if isinstance(leaf, torch.Tensor):
        out = leaf.reshape(grouped).narrow(dim + 1, index * chunk, chunk)
        return out.reshape(shape[:dim] + (groups * chunk,)
                           + shape[dim + 1:]).contiguous()
    arr = np.asarray(leaf).reshape(grouped)
    sl = [slice(None)] * arr.ndim
    sl[dim + 1] = slice(index * chunk, (index + 1) * chunk)
    return np.ascontiguousarray(arr[tuple(sl)]).reshape(
        shape[:dim] + (groups * chunk,) + shape[dim + 1:])


def local_shard(leaf, spec: tuple, mesh, rank: int | None = None,
                order: tuple[int, ...] | None = None, groups: int = 1):
    """This rank's shard of ``leaf`` under ``spec``. ``order[i]`` is the
    dimension of ``leaf`` that dimension ``i`` of the spec names (default:
    the same), for a tensor laid out unlike the flax leaf the spec is
    written for."""
    for i, entry in enumerate(spec):
        axes = _axes(entry)
        parts = axis_size(mesh, *axes) if axes else 1
        if parts == 1:
            continue
        dim = order[i] if order is not None else i
        leaf = _narrow(leaf, dim, parts, axis_index(mesh, *axes, rank=rank),
                       groups)
    return leaf


def shard_params(params, mesh, tp_rules=None, rank: int | None = None):
    """This rank's shards of a nested-dict params tree (flax-shaped: numpy
    arrays or tensors) per ``tp_rules`` (either form ``spec_for_param``
    takes): a tree of the same structure whose split leaves are narrowed
    to the rank's chunk along each split dimension."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return local_shard(node, spec_for_param(path, node, tp_rules), mesh,
                           rank)
    return walk(params, ())


#: Module-path parts that the JAX package names otherwise (flax's
#: automatic names of the sequence families' and the ViT's LayerNorms).
_FLAX_NAMES = {"ln1": "LayerNorm_0", "ln2": "LayerNorm_1",
               "norm": "LayerNorm_0"}


def flax_view(module: torch.nn.Module) -> dict[str, tuple[tuple, tuple]]:
    """``{state_dict key: (flax path, order)}`` for every parameter of a
    module built like the JAX package's (``blocks.3.attn.qkv.weight`` is
    ``block3/attn/qkv/kernel``), ``order[i]`` the tensor's dimension that
    holds the flax leaf's dimension ``i``: a Dense kernel is the
    transposed weight, a conv kernel (H, W, I, O) the (O, I, H, W)
    weight."""
    from torch import nn

    from ..models.layers import LayerNorm

    view = {}
    for name, param in module.named_parameters():
        *owner_path, leaf = name.split(".")
        owner = module.get_submodule(".".join(owner_path))
        parts: list[str] = []
        for i, part in enumerate(owner_path):
            if part.isdigit() and parts and parts[-1] == "blocks":
                parts[-1] = f"block{part}"
            else:
                parts.append(_FLAX_NAMES.get(part, part) if i == len(
                    owner_path) - 1 and isinstance(owner, LayerNorm) else part)
        order = tuple(range(param.dim()))
        if isinstance(owner, nn.Linear) and leaf == "weight":
            leaf, order = "kernel", (1, 0)
        elif isinstance(owner, nn.Conv2d) and leaf == "weight":
            leaf, order = "kernel", (2, 3, 1, 0)
        elif isinstance(owner, nn.Embedding):
            leaf = "embedding"
        elif isinstance(owner, LayerNorm) and leaf == "weight":
            leaf = "scale"
        view[name] = (tuple(parts) + (leaf,), order)
    return view


def shard_module_(module: torch.nn.Module, mesh, tp_rules=None) -> dict:
    """Keep only this rank's shard of every parameter of ``module`` that
    ``tp_rules`` splits (rules in the JAX package's flax paths, matched
    through ``flax_view``), in place. A submodule's ``SPLIT_GROUPS``
    (``{parameter name: groups}``) splits a fused parameter group by group.
    Returns ``{state_dict key: (spec, order, groups)}`` of the split
    parameters (``local_shard``'s arguments for a new value of one;
    ``shard_tensors`` and ``unshard_tensors`` take it). The shards are
    frozen (``requires_grad=False``), as serving wants them; ``Trainer``
    makes its model's parameters trainable after sharding it."""
    split = {}
    for name, (path, order) in flax_view(module).items():
        param = module.get_parameter(name)
        flax_shape = tuple(param.shape[d] for d in order)
        spec = spec_for_param(path, np.empty(flax_shape, np.uint8)
                              if flax_shape else np.float32(0), tp_rules)
        if not any(axis_size(mesh, *_axes(e)) > 1 for e in spec if e):
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        groups = getattr(owner, "SPLIT_GROUPS", {}).get(leaf, 1)
        with torch.no_grad():
            local = local_shard(param.detach(), spec, mesh, order=order,
                                groups=groups)
        setattr(owner, leaf, torch.nn.Parameter(local, requires_grad=False))
        split[name] = (spec, order, groups)
    return split


def shard_tensors(tensors: dict, mesh, split: dict) -> dict:
    """This rank's shard of every whole tensor of ``tensors`` that
    ``split`` (``shard_module_``'s result, keyed by state_dict key) names;
    the others as they are."""
    out = {}
    for key, t in tensors.items():
        if key in split:
            spec, order, groups = split[key]
            t = local_shard(t, spec, mesh, order=order, groups=groups)
        out[key] = t
    return out


def unshard_tensors(tensors: dict, mesh, split: dict) -> dict:
    """The inverse of ``shard_tensors``: the whole tensor of every local
    shard that ``split`` names, gathered over its axes
    (``comm.gather_along_spec``, a collective: every rank calls it with
    the same keys in the same order); the others as they are."""
    from .comm import gather_along_spec

    out = {}
    for key, t in tensors.items():
        if key in split:
            spec, order, groups = split[key]
            t = gather_along_spec(t, spec, mesh, order=order, groups=groups)
        out[key] = t
    return out


def pad_to_multiple(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple) * multiple)
