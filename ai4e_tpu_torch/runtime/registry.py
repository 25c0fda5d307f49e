"""Model registry — servable PyTorch modules on one device, one CUDA graph
per (model, bucket).

Counterpart of ``ai4e_tpu/runtime/registry.py``. A servable is a module plus
pure pre/postprocess functions; the runtime moves the module to its device
and runs one padded batch at a time. Where JAX jits one executable per
(model, bucket), the runtime on the card captures one CUDA graph per (model,
bucket): ``warmup`` (and ``prepare_buckets`` for a derived ladder) runs the
bucket eagerly on the execute stream (kernel builds, cuDNN's algorithm
choice), then captures ``apply_fn`` into a static input and static outputs;
serving copies the padded batch into the static input and replays. All
graphs of a runtime share one memory pool and are never replayed at once: a
lock makes the card run one batch, one capture or one weight copy at a time.
A capture that fails raises; nothing serves that bucket eagerly instead. On
the CPU the runtime runs ``apply_fn`` eagerly.

The first run of a (model, bucket) shape is labelled ``compile`` by
``run_batch_phases`` and ``execute_resident``, as the JAX runtime does;
``warmup`` and ``prepare_buckets`` take those runs, so a warmed worker's
serving path reads ``execute``.

A replay launches the hand-written kernels without calling their wrappers,
so each graph keeps what its capture launched and adds it to the kernels'
counters on every replay (``ops.add_launches``).

``reload_params`` swaps a servable's weights in place: the new tensors are
staged on the device, then copied into the module's own tensors under the
lock, so every batch runs wholly on the old weights or wholly on the new
ones, and the graphs, which captured the tensors' addresses, replay the new
values.

Over a device mesh of more than one rank (``mesh``, a ``DeviceMesh`` from
``parallel.sharding``; one rank a device) the runtime is one rank's part of
an SPMD program, as JAX's runtime is on a multi-process slice:
``register`` keeps the rank's shard of every parameter the servable's
``param_sharding_rules`` split (``shard_module_``) and rounds the buckets
up to the data axes' multiple (``data_axis_size``); ``run_rows`` runs this
rank's rows of a bucket (its data coordinate's share) and gathers every
data coordinate's outputs, so each rank returns the whole batch's;
``run_batch_phases`` on a whole batch runs the rank's rows of it (every
rank enters it with the same batch: warmup). The models call their
collectives inside ``apply_fn``, and a collective over gloo cannot be
captured, so a meshed bucket runs eagerly on the execute stream: no CUDA
graphs. The multi-process serving path (``parallel.multihost``) drives
``run_rows`` on every rank.

``cudnn.allow_tf32`` is switched off on the card: the head conv is float32
in the reference, and cuDNN would otherwise run it in TF32 (about three
decimal digits), which can flip the argmax of close logits. Likewise for
cuBLAS: no TF32 for float32 products, and bfloat16 products reduce in
float32 (PyTorch lets cuBLAS reduce them in bfloat16 by default), as XLA's
do. The dct wire's inverse DCT (two float32 products per block, inside the
bucket's graph) relies on this: in TF32 its pixels would drift.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from .. import ops
from ..device import resolve_device
from .ladder import DEFAULT_BUCKETS

log = logging.getLogger("ai4e_tpu_torch.runtime")

Preprocess = Callable[[bytes, str], np.ndarray]
Postprocess = Callable[[Any], Any]


@dataclass
class ServableModel:
    """One deployable model API.

    - ``apply_fn(module, batch) -> outputs``: a function of a dense batch
      tensor on the runtime's device; outputs are a tensor or a dict of
      tensors with the batch as their first axis. On the card it is
      captured in a CUDA graph, so it must not synchronise with the host;
    - ``preprocess(body, content_type) -> example``: request payload -> one
      example array of ``input_shape`` (raises ValueError on bad input —
      that fails one task, never a batch);
    - ``postprocess(example_outputs) -> result``: one example's slice of the
      host outputs -> JSON-able result;
    - ``batch_buckets``: allowed batch sizes, ascending; a batch is padded
      up to the smallest that fits.
    - ``state_dict_from_flax``: converts the JAX package's params tree for
      this servable to ``module``'s state_dict, and
      ``flax_from_state_dict`` back (None: no weights to restore or
      reload).
    - ``checkpoint_path`` and ``params_version``: where the weights came
      from and how many times they were swapped in (1 = as built);
      ``generation``: the rollout generation a reload names.
    - the batch API's stack contract (``InferenceWorker.serve_batch``):
      stacks arrive as (N, *``stack_item_shape``) in ``stack_item_dtype``
      (None: ``input_shape`` and ``input_dtype``), each item passed through
      ``stack_adapter`` to become an example; ``stack_validator`` checks
      the RAW decoded stack before any cast (token servables reject floats
      and out-of-range ids there); ``example_decoder`` turns a
      preprocessed example back into the natural image for host consumers
      such as a crops handoff. The adapter and decoder belong to the
      compressed wires (``yuv420``, ``dct``); the rgb8 wire leaves them
      None.
    """

    name: str
    apply_fn: Callable
    module: nn.Module
    input_shape: tuple[int, ...]
    preprocess: Preprocess
    postprocess: Postprocess
    batch_buckets: tuple[int, ...] = DEFAULT_BUCKETS
    input_dtype: Any = np.float32
    version: str = "1.0"
    checkpoint_path: str | None = None
    params_version: int = 1
    generation: int = 1
    state_dict_from_flax: Callable | None = None
    flax_from_state_dict: Callable | None = None
    stack_item_shape: tuple[int, ...] | None = None
    stack_item_dtype: Any = None
    stack_adapter: Callable | None = None
    stack_validator: Callable | None = None
    example_decoder: Callable | None = None
    #: Partition rules over the flax params tree (``spec_for_param``'s
    #: forms) that a mesh shards the module's parameters by; None:
    #: replicated.
    param_sharding_rules: Any = None

    def bucket_for(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    @property
    def max_bucket(self) -> int:
        return self.batch_buckets[-1]


@dataclass
class BucketGraph:
    """One captured (model, bucket) program: the graph, the static input it
    reads, the static outputs it writes, the kernel launches of one replay
    and the model it serves."""

    graph: Any
    static_in: torch.Tensor
    static_out: Any
    launches: dict[str, int]
    model: str = ""


def _to_pinned(out):
    """Start copying a tensor (or dict of tensors) on the card into fresh
    pinned host tensors on the current stream; the caller synchronises."""
    if isinstance(out, dict):
        return {k: _to_pinned(v) for k, v in out.items()}
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    return host.copy_(out, non_blocking=True)


def _numpy(out):
    if isinstance(out, dict):
        return {k: _numpy(v) for k, v in out.items()}
    return out.numpy()


def _clone(out):
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    return out.clone()


def _gather_rows(mesh, out):
    """Every data coordinate's host outputs (an array or a dict of arrays,
    this rank's rows first axis), concatenated in data-coordinate order:
    gathered over the process group from one rank of each coordinate (the
    ranks of one coordinate hold the same outputs)."""
    from ..parallel import comm
    from ..parallel.sharding import data_axis_size, process_count

    if isinstance(out, dict):
        return {k: _gather_rows(mesh, v) for k, v in out.items()}
    per_coord = process_count() // data_axis_size(mesh)
    parts = comm.all_gather_host(out)
    return np.concatenate(parts[::per_coord])


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


#: 64-bit leaves as JAX sees them without x64: its 32-bit types.
_CANONICAL = {"float64": "float32", "int64": "int32", "uint64": "uint32",
              "complex128": "complex64"}


def flax_spec(tree):
    """``(shape, dtype name)`` of every leaf of a nested-dict params tree,
    64-bit types named as their 32-bit ones: the tree the JAX runtime's
    ``reload_params`` compares (``jnp.result_type`` without x64)."""
    if isinstance(tree, dict):
        return {k: flax_spec(tree[k]) for k in sorted(tree)}
    arr = np.asarray(tree)
    return (tuple(arr.shape), _CANONICAL.get(arr.dtype.name, arr.dtype.name))


class ModelRuntime:
    """Owns the device, the registered modules and their graphs; runs padded
    batches."""

    def __init__(self, device=None, mesh=None):
        from ..parallel.sharding import process_count
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self.mesh = mesh
        # One rank's part of an SPMD program: eager buckets, sharded params.
        self._meshed = mesh is not None and process_count() > 1
        # model -> {state_dict key: (spec, order, groups)} of split params.
        self._split: dict[str, dict] = {}
        if self._cuda:
            torch.backends.cudnn.allow_tf32 = False
            # Load-bearing beyond the head conv: the dct wire's IDCT
            # products are float32 matmuls captured in the bucket graphs.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            # Batches execute (and graphs are captured) on one stream; the
            # split-phase path's copies each way run on one of their own.
            self.exec_stream = torch.cuda.Stream(self.device)
            self._h2d_stream = torch.cuda.Stream(self.device)
            self._d2h_stream = torch.cuda.Stream(self.device)
            self.graph_pool = torch.cuda.graph_pool_handle()
        self.models: dict[str, ServableModel] = {}
        self.graphs: dict[tuple[str, int], BucketGraph] = {}
        # (model, padded-batch-size) shapes this process has run — the
        # first run of each is labelled ``compile``. Append-only: an old
        # ladder's buckets stay warm after a swap.
        self._executed_shapes: set[tuple[str, int]] = set()
        # The card runs one batch, one capture or one weight copy at a time.
        self._device_lock = threading.Lock()
        # Each servable's params-tree spec, computed at its first reload.
        self._flax_specs: dict[str, dict] = {}
        # model -> kernel -> launches its graphs' replays made.
        self.model_launches: dict[str, dict[str, int]] = {}

    @property
    def device_lock(self) -> threading.Lock:
        """The lock under which the card runs one batch, capture or weight
        copy at a time; the decode runtime (``runtime/kvcache.py``) takes
        it for its own prefills, steps, captures and copies."""
        return self._device_lock

    @property
    def data_axis_size(self) -> int:
        """Data coordinates (dp x fsdp) a batch splits over: 1 off a mesh."""
        from ..parallel.sharding import data_axis_size
        return data_axis_size(self.mesh)

    def register(self, servable: ServableModel) -> ServableModel:
        """Move the module to the device, channels-last, inference mode.
        Over a mesh of more than one rank, first keep this rank's shard of
        each parameter ``param_sharding_rules`` split, and round the
        buckets up to multiples of the data axes' size."""
        from ..parallel.sharding import pad_to_multiple, shard_module_
        if self._meshed:
            if (servable.param_sharding_rules is not None
                    and servable.flax_from_state_dict is not None):
                # The served tree, whole, for reload's comparison.
                self._flax_specs[servable.name] = flax_spec(
                    servable.flax_from_state_dict(
                        servable.module.state_dict()))
            self._split[servable.name] = shard_module_(
                servable.module, self.mesh, servable.param_sharding_rules)
            servable.batch_buckets = tuple(sorted({
                pad_to_multiple(b, self.data_axis_size)
                for b in servable.batch_buckets}))
        servable.module = servable.module.to(
            device=self.device, memory_format=torch.channels_last).eval()
        servable.module.requires_grad_(False)
        self.models[servable.name] = servable
        return servable

    def warmup(self, names: list[str] | None = None) -> dict[str, float]:
        """Run every bucket of every model once (on the card: run it
        eagerly, capture its graph and replay it), so the first served
        request pays no one-off cost. Returns seconds per model."""
        times: dict[str, float] = {}
        for name, servable in self.models.items():
            if names is not None and name not in names:
                continue
            t0 = time.perf_counter()
            for bucket in servable.batch_buckets:
                self._prepare(name, bucket)
            times[name] = time.perf_counter() - t0
            log.info("warmup %s: %d buckets in %.1fs%s", name,
                     len(servable.batch_buckets), times[name],
                     " (CUDA graphs captured)" if self._cuda and not self._meshed
                     else "")
        return times

    def _prepare(self, name: str, bucket: int) -> None:
        """Capture (on the card) and run one bucket not run before."""
        if (name, bucket) in self._executed_shapes:
            return
        servable = self.models[name]
        self.run_batch(name, np.zeros((bucket, *servable.input_shape),
                                      servable.input_dtype))

    def prepare_buckets(self, name: str, buckets) -> tuple[int, ...]:
        """Run (on the card: capture and replay) every bucket of a candidate
        ladder not run before, WITHOUT swapping it in — the ladder
        deriver's background step. Returns the sorted tuple to pass to
        ``apply_ladder``."""
        if name not in self.models:
            raise KeyError(name)
        aligned = tuple(sorted({int(b) for b in buckets}))
        if not aligned:
            raise ValueError(f"empty ladder for {name}")
        for bucket in aligned:
            self._prepare(name, bucket)
        return aligned

    def apply_ladder(self, name: str, buckets) -> tuple[int, ...]:
        """Swap ``name``'s serving ladder to ``buckets`` (the tuple
        ``prepare_buckets`` returned) in one attribute assignment. Refuses
        any bucket that has not been executed; old buckets keep their
        graphs, so a batch cut against the old ladder still replays."""
        servable = self.models[name]
        aligned = tuple(sorted({int(b) for b in buckets}))
        missing = [b for b in aligned
                   if (name, b) not in self._executed_shapes]
        if missing:
            raise RuntimeError(
                f"apply_ladder({name}): buckets {missing} have no "
                f"executed program — call prepare_buckets first")
        servable.batch_buckets = aligned
        return aligned

    def reload_params(self, name: str, new_params) -> ServableModel:
        """Swap a registered servable's weights for the flax-shaped tree
        ``new_params`` (as ``convert.load_npz`` reads it). The tree must
        match the served one exactly — structure, shapes and dtypes, as
        the JAX runtime requires — or ``ValueError`` is raised and serving
        is unchanged. The new weights are staged on the device, then
        copied into the module's own tensors between batches, and
        ``params_version`` goes up by one."""
        servable = self.models[name]  # KeyError -> the caller's 404
        if servable.flax_from_state_dict is None:
            raise ValueError(f"model {name!r} has no weights to reload")
        module_sd = servable.module.state_dict()
        served = self._flax_specs.get(name)
        if served is None:
            served = self._flax_specs[name] = flax_spec(
                servable.flax_from_state_dict(module_sd))
        offered = flax_spec(new_params)
        if served != offered:
            raise ValueError(
                f"checkpoint tree does not match the served model: "
                f"served {served} vs reload {offered}")
        new_sd = servable.state_dict_from_flax(new_params)
        if self._split.get(name):
            from ..parallel.sharding import local_shard
            for key, (spec, order, groups) in self._split[name].items():
                new_sd[key] = local_shard(new_sd[key], spec, self.mesh,
                                          order=order, groups=groups)
        staged = {k: new_sd[k].to(device=self.device, dtype=t.dtype)
                  for k, t in module_sd.items()}
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()
        with self._device_lock, self._on_exec_stream(), torch.no_grad():
            for key, tensor in module_sd.items():
                tensor.copy_(staged[key])
            self._sync()
            servable.params_version += 1
        return servable

    # -- the fused path ------------------------------------------------------

    def run_batch(self, name: str, batch: np.ndarray):
        """Execute one padded batch; blocking (call from an executor)."""
        return self.run_batch_phases(name, batch)[0]

    def run_batch_report(self, name: str, batch: np.ndarray
                         ) -> tuple[object, frozenset]:
        """``run_batch`` plus the poisoned-rows set of the JAX runtime's
        surface — always empty on one device."""
        return self.run_batch(name, batch), frozenset()

    def run_batch_phases(self, name: str, batch: np.ndarray
                         ) -> tuple[object, frozenset, dict[str, float]]:
        """``run_batch_report`` with the device boundary split into
        measured phases, each ended by a synchronize of the execute stream:

        - ``h2d``: the padded batch copied from pinned host memory (on the
          card, into the bucket graph's static input);
        - ``execute`` (``compile`` on the first run of this shape, which on
          the card includes the eager run and the capture): the graph's
          replay, or ``apply_fn`` on the CPU;
        - ``d2h``: the outputs copied back (counts-only land-cover: B*C
          int32).

        Returns ``(host_outputs, poisoned_rows, {phase: seconds})``. Over
        a mesh, every rank passes the same whole batch and runs its rows
        of it (``run_rows``)."""
        if self._meshed:
            from ..parallel.sharding import row_range
            start, stop = row_range(self.mesh, int(batch.shape[0]))
            out, phases = self.run_rows(name, batch[start:stop],
                                        int(batch.shape[0]))
            return out, frozenset(), phases
        servable = self.models[name]
        key = (name, int(batch.shape[0]))
        phases: dict[str, float] = {}
        with self._device_lock, self._on_exec_stream():
            first = key not in self._executed_shapes
            t0 = time.perf_counter()
            if self._cuda:
                graph = self.graphs.get(key)
                dest = (graph.static_in if graph is not None else
                        torch.empty(batch.shape,
                                    dtype=_torch_dtype(batch.dtype),
                                    device=self.device))
                dest.copy_(torch.from_numpy(batch).pin_memory(),
                           non_blocking=True)
                self._sync()
            else:
                dest = torch.from_numpy(batch)
            phases["h2d"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if self._cuda:
                if graph is None:
                    graph = self._capture(servable, dest)
                out = self._replay(graph)
            else:
                with torch.inference_mode():
                    out = servable.apply_fn(servable.module, dest)
            self._sync()
            phases["compile" if first else "execute"] = (
                time.perf_counter() - t0)
            self._executed_shapes.add(key)
            t0 = time.perf_counter()
            host_out = self._fetch(out)
            phases["d2h"] = time.perf_counter() - t0
        return host_out, frozenset(), phases

    def run_rows(self, name: str, rows: np.ndarray, bucket: int
                 ) -> tuple[object, dict[str, float]]:
        """Over a mesh: run this rank's ``rows`` of a ``bucket``-row batch
        (its data coordinate's share, ``row_range``) eagerly on the execute
        stream, the model's collectives inside, then gather every data
        coordinate's outputs over the process group. Every rank of the
        mesh must enter it for the same (model, bucket) in the same order.
        Returns ``(host_outputs of all bucket rows, {phase: seconds})``,
        phases ``h2d``, ``execute`` (``compile`` on the shape's first run)
        and ``d2h`` (the copy back and the gather)."""
        servable = self.models[name]
        key = (name, int(bucket))
        phases: dict[str, float] = {}
        with self._device_lock, self._on_exec_stream():
            first = key not in self._executed_shapes
            t0 = time.perf_counter()
            # Rows fetched from the shard feed are a read-only buffer.
            dev = torch.from_numpy(np.require(rows, requirements="CW"))
            if self._cuda:
                dev = dev.pin_memory().to(self.device, non_blocking=True)
                self._sync()
            phases["h2d"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            with torch.inference_mode():
                out = servable.apply_fn(servable.module, dev)
            self._sync()
            phases["compile" if first else "execute"] = (
                time.perf_counter() - t0)
            self._executed_shapes.add(key)
            t0 = time.perf_counter()
            host_out = _gather_rows(self.mesh, self._fetch(out))
            phases["d2h"] = time.perf_counter() - t0
        return host_out, phases

    # -- split-phase surface (the double-buffered batcher) -------------------
    #
    # The three steps of run_batch_phases as separate blocking calls, each
    # returning its (perf-counter start, end) wall window. The batcher's
    # double-buffered path runs them on three single-thread executors, so
    # batch N+1's h2d (its own device buffer, on the h2d stream) overlaps
    # batch N's replay, and batch N's fetch overlaps batch N+1's replay.

    def supports_split_phases(self) -> bool:
        return not self._meshed

    def host_buffer(self, shape: tuple[int, ...], dtype) -> np.ndarray:
        """A host array for staging batches: on the card in pinned memory,
        so ``h2d_resident`` copies from it directly."""
        if not self._cuda:
            return np.zeros(shape, dtype)
        return torch.zeros(shape, dtype=_torch_dtype(dtype),
                           pin_memory=True).numpy()

    def h2d_resident(self, name: str, batch: np.ndarray):
        """Copy the padded batch (a ``host_buffer``: pinned on the card) to
        a device buffer of its own on the h2d stream, blocked until
        resident, so the caller may reuse ``batch`` on return. Returns
        ``(device_batch, (t0, t1))``."""
        t0 = time.perf_counter()
        if not self._cuda:
            return torch.from_numpy(batch.copy()), (t0, time.perf_counter())
        with torch.cuda.stream(self._h2d_stream):
            dev = torch.empty(batch.shape, dtype=_torch_dtype(batch.dtype),
                              device=self.device)
            dev.copy_(torch.from_numpy(batch), non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._h2d_stream)
            done.synchronize()
        dev.record_stream(self.exec_stream)
        return (dev, done), (t0, time.perf_counter())

    def execute_resident(self, name: str, device_batch):
        """Run the bucket's program on an already-resident batch, blocked
        until the outputs are on the device: on the card the execute stream
        waits for the h2d event, copies the batch into the graph's static
        input, replays, and copies the static outputs out (so the next
        replay of the bucket cannot overwrite them before they are
        fetched). Returns ``(device_outputs, label, (t0, t1))``, label
        ``compile`` on the first run of the (model, bucket) shape."""
        servable = self.models[name]
        with self._device_lock, self._on_exec_stream():
            if self._cuda:
                dev, ready = device_batch
            else:
                dev = device_batch
            key = (name, int(dev.shape[0]))
            first = key not in self._executed_shapes
            t0 = time.perf_counter()
            if self._cuda:
                self.exec_stream.wait_event(ready)
                graph = self.graphs.get(key)
                if graph is None:
                    graph = self._capture(servable, dev)
                else:
                    graph.static_in.copy_(dev)
                out = _clone(self._replay(graph))
            else:
                with torch.inference_mode():
                    out = servable.apply_fn(servable.module, dev)
            self._sync()
            self._executed_shapes.add(key)
        return out, ("compile" if first else "execute"), (
            t0, time.perf_counter())

    def fetch_resident(self, out):
        """Copy the outputs (on the card: ``execute_resident``'s copies of
        the static outputs) to pinned host memory on the d2h stream.
        Returns ``(host_outputs, (t0, t1))``."""
        t0 = time.perf_counter()
        if self._cuda:
            with torch.cuda.stream(self._d2h_stream):
                host = self._fetch(out, self._d2h_stream)
        else:
            host = self._fetch(out)
        return host, (t0, time.perf_counter())

    # -- graphs --------------------------------------------------------------

    def _capture(self, servable: ServableModel,
                 batch: torch.Tensor) -> BucketGraph:
        """Capture ``servable.apply_fn`` on a static copy of ``batch`` (the
        lock held, on the execute stream), after running it eagerly there
        once, and register the graph. Nothing has replayed it yet."""
        static_in = batch.clone()
        with torch.inference_mode():
            servable.apply_fn(servable.module, static_in)
        self._sync()
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        try:
            with torch.inference_mode(), torch.cuda.graph(
                    graph, pool=self.graph_pool, stream=self.exec_stream,
                    capture_error_mode="thread_local"):
                static_out = servable.apply_fn(servable.module, static_in)
        finally:
            launched = {k: n - before[k]
                        for k, n in ops.launch_counts().items()
                        if n != before[k]}
            # A capture launches nothing, failed or not; the counters count
            # replays.
            ops.add_launches({k: -n for k, n in launched.items()})
        bg = BucketGraph(graph, static_in, static_out, launched,
                         servable.name)
        self.graphs[(servable.name, int(batch.shape[0]))] = bg
        log.info("captured %s bucket %d (kernel launches a replay: %s)",
                 servable.name, batch.shape[0], launched)
        return bg

    def _replay(self, graph: BucketGraph):
        graph.graph.replay()
        ops.add_launches(graph.launches)
        counts = self.model_launches.setdefault(graph.model, {})
        for kernel, n in graph.launches.items():
            counts[kernel] = counts.get(kernel, 0) + n
        return graph.static_out

    def graph_pool_bytes(self) -> int:
        """Bytes the caching allocator has reserved for the graphs' shared
        pool (0 on the CPU)."""
        if not self._cuda:
            return 0
        pool = tuple(self.graph_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    # -- helpers -------------------------------------------------------------

    def _fetch(self, out, stream=None):
        """Outputs as numpy arrays: on the card copied to pinned host
        memory on ``stream`` (default: the execute stream), waited for."""
        if not self._cuda:
            return _numpy(out)
        host = _to_pinned(out)
        (stream or self.exec_stream).synchronize()
        return _numpy(host)

    def _on_exec_stream(self):
        if self._cuda:
            return torch.cuda.stream(self.exec_stream)
        return contextlib.nullcontext()

    def _sync(self) -> None:
        if self._cuda:
            self.exec_stream.synchronize()
