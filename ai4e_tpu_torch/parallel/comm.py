"""Every collective of the parallel plane, in one module.

The port's models and runtimes call these and nothing of
``torch.distributed`` directly. Two transports:

- NCCL, where every rank has a card of its own (the process group's
  backend is ``"cpu:gloo,cuda:nccl"``): CUDA tensors move card to card;
- gloo, everywhere else: on the CPU, and where two ranks share one card,
  which NCCL refuses. gloo moves CUDA tensors in only some collectives and
  never in ``send``/``recv`` or ``all_to_all``, so here a CUDA tensor is
  copied to pinned host memory, moved, and copied back, explicitly. Those
  copies are counted: ``host_copy_bytes`` (both directions) and
  ``host_copies``. Compute never moves to the CPU: only the bytes that
  cross between ranks do.

``calls`` and ``seconds`` count the collectives and their wall time on the
calling thread (a staged collective waits for its copies, so its time is
whole; an NCCL one is enqueued and its time is the enqueue).

Training adds collectives with an explicit backward, each a
``torch.autograd.Function`` (``copy_to``, ``reduce_from``, ``all_to_all``
under autograd), or run outside autograd (``reduce_gradients_``,
``gather_along_spec``): a megatron tp layer, and the MoE layer over ep,
takes its replicated input through ``copy_to`` (identity forward, sum over
the group backward) and hands its partial output to ``reduce_from`` (sum
forward, identity backward), as does the SeqFormer's pool over sp;
Ulysses' exchange takes the inverse exchange backward; the trainer sums
the gradients a rank holds only a part of over sp or ep and averages every
gradient over the data axes, one flat buffer a group a step; a checkpoint
gathers whole parameters and optimizer moments from their shards.

Control traffic — the multihost runtime's descriptor broadcast, its poison
gather, the outputs' gather — rides CPU tensors on the default group
(gloo either way).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

_backend = "gloo"
_lock = threading.Lock()
#: Bytes copied between a card and host memory to carry a collective over
#: gloo (device to host plus host to device), since import or a reset.
host_copy_bytes = 0
host_copies = 0
calls = 0
seconds = 0.0


def set_backend(backend: str) -> None:
    """Record the process group's backend string (``init_distributed``)."""
    global _backend
    _backend = backend


def reset() -> None:
    global host_copy_bytes, host_copies, calls, seconds
    with _lock:
        host_copy_bytes = host_copies = calls = 0
        seconds = 0.0


def counters() -> dict:
    return {"calls": calls, "seconds": seconds,
            "host_copy_bytes": host_copy_bytes, "host_copies": host_copies}


def _staged(t: torch.Tensor) -> bool:
    """Whether ``t`` must cross through host memory."""
    return t.is_cuda and "nccl" not in _backend


def _count(nbytes: int, copies: int, t0: float) -> None:
    global host_copy_bytes, host_copies, calls, seconds
    with _lock:
        host_copy_bytes += nbytes
        host_copies += copies
        calls += 1
        seconds += time.perf_counter() - t0


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t)


def _ranks(group) -> list[int]:
    import torch.distributed as dist
    return dist.get_process_group_ranks(group)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Send ``x`` one hop around the ring of ``group`` (to the next rank
    in the group's order) and return what the previous rank sent: one
    ``batch_isend_irecv`` a call."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    ranks = _ranks(group)
    me = ranks.index(dist.get_rank())
    nxt, prev = ranks[(me + 1) % len(ranks)], ranks[(me - 1) % len(ranks)]
    staged = _staged(x)
    send = _to_host(x) if staged else x.contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, nxt, group),
        dist.P2POp(dist.irecv, recv, prev, group)])
    for req in reqs:
        req.wait()
    if staged:
        recv = recv.to(x.device, non_blocking=True)
    _count(2 * x.nbytes if staged else 0, 2 if staged else 0, t0)
    return recv


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` over ``group``: chunk i of ``x``'s dim 0 goes
    to the group's rank i; the result's chunk i came from rank i. Under
    autograd (``_AllToAll``) the gradient takes the inverse exchange, the
    same call on the result's gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, group)
    return _all_to_all(x, group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    t0 = time.perf_counter()
    staged = _staged(x)
    send = _to_host(x) if staged else x.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(x.device, non_blocking=True)
    _count(2 * x.nbytes if staged else 0, 2 if staged else 0, t0)
    return recv


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, on every rank of it (a new tensor on
    ``x``'s device)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    staged = _staged(x)
    buf = _to_host(x) if staged else x.clone()
    dist.all_reduce(buf, group=group)
    if staged:
        buf = buf.to(x.device, non_blocking=True)
    _count(2 * x.nbytes if staged else 0, 2 if staged else 0, t0)
    return buf


def all_gather_host(arr: np.ndarray) -> list[np.ndarray]:
    """Every rank's ``arr`` (same shape and dtype on every rank), in rank
    order, over the default group."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    mine = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    _count(0, 0, t0)
    return [o.numpy() for o in out]


def broadcast_host(arr: np.ndarray, src: int = 0) -> np.ndarray:
    """Rank ``src``'s ``arr`` on every rank (same shape and dtype given on
    every rank), over the default group."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    buf = torch.from_numpy(np.array(arr, copy=True))
    dist.broadcast(buf, src)
    _count(0, 0, t0)
    return buf.numpy()


def all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape and dtype on every rank of
    ``group``), in the group's rank order, on ``x``'s device."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    staged = _staged(x)
    send = _to_host(x) if staged else x.contiguous()
    out = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, send, group=group)
    if staged:
        out = [o.to(x.device, non_blocking=True) for o in out]
    _count((1 + len(out)) * x.nbytes if staged else 0,
           1 + len(out) if staged else 0, t0)
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` forward; backward, the inverse exchange: equal chunks
    make the exchange its own inverse (rank j's chunk i went to rank i's
    chunk j)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient summed over ``group`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """The sum over ``group`` forward; the gradient as it is backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, replicated over ``group``, entering a layer whose ranks each
    take a part of it: its gradient is the sum of the ranks' (the input
    of a column-split Dense)."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``group``, under autograd:
    every rank's part gets the whole gradient (a row-split Dense)."""
    return _ReduceFrom.apply(x, group)


def reduce_gradients_(tensors: list[torch.Tensor], group,
                      scale: float = 1.0) -> None:
    """Sum ``tensors`` over ``group`` and multiply by ``scale``, in place,
    with one all-reduce a dtype: the tensors are flattened into one buffer
    (so a staged collective costs one round trip through host memory, not
    one a tensor) and copied back."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        flat = all_reduce_sum(flat, group)
        if scale != 1.0:
            flat.mul_(scale)
        offset = 0
        for t in same:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def gather_along_spec(local: torch.Tensor, spec: tuple, mesh,
                      order: tuple[int, ...] | None = None,
                      groups: int = 1) -> torch.Tensor:
    """The whole tensor of which ``local`` is this rank's
    ``sharding.local_shard(whole, spec, mesh, order=order, groups=groups)``:
    each split dimension gathered over its axes' group and put back in the
    axes' index order, group by group (``SPLIT_GROUPS``). A collective:
    every rank of the mesh calls it with its own shard."""
    from .sharding import _axes, axes_group, axis_index, axis_size

    whole = local
    for i in reversed(range(len(spec))):
        axes = _axes(spec[i])
        parts = axis_size(mesh, *axes) if axes else 1
        if parts == 1:
            continue
        dim = order[i] if order is not None else i
        group = axes_group(mesh, *axes)
        shards = all_gather(whole, group)
        ranks = _ranks(group)
        by_index = sorted(zip((axis_index(mesh, *axes, rank=r)
                               for r in ranks), range(len(ranks))))
        shape = tuple(whole.shape)
        size = shape[dim]
        grouped = shape[:dim] + (groups, size // groups) + shape[dim + 1:]
        whole = torch.cat([shards[j].reshape(grouped) for _, j in by_index],
                          dim=dim + 1)
        whole = whole.reshape(shape[:dim] + (size * parts,) + shape[dim + 1:])
    return whole
