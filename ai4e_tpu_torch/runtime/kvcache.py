"""Pooled KV-cache decode runtime — the device side of continuous batching
(``runtime/decode.py`` owns the scheduling); counterpart of
``ai4e_tpu/runtime/kvcache.py``.

The cache is ONE preallocated float32 slot-pool tensor each for K and V::

    k, v : (layers, slots, heads, max_len, head_dim)

keyed by ``(model, params_version)``: a hot weight reload bumps the
version and the engine clears the cache (``reset_cache``) then re-prefills
its active sequences. Slots are rows of that tensor; admission and release
are bookkeeping in ``decode.SlotPool``, and the card never allocates per
request.

On the card three kinds of work serve the whole path, and none is captured
while serving: ``warm()`` captures one CUDA graph per prefill bucket (batch
1: the prompt padded to the smallest fitting bucket of
``ladder.DECODE_PROMPT_BUCKETS``, the top bucket always ``max_len``) and
one for the step over the whole pool, each on static token, length and
position tensors, the caches captured as persistent memory:

- **prefill**: causal attention over one padded prompt (its graph's
  replay), then **insert**: the prompt's K/V block copied in place into
  ``k[:, slot, :, :P]`` and ``v[:, slot, :, :P]``, where XLA updates a
  donated buffer;
- **step**: one decode step over the WHOLE pool, every slot one token
  (inactive slots ride along at position 0; their rows are garbage that a
  later prefill overwrites), the new K/V written into the caches in place.

Because the graphs read the caches' and the parameters' addresses,
``reset_cache`` zeroes the caches in place and ``reload_params`` copies new
weights into the module's own tensors: a new tensor would leave every
graph reading freed memory.

Locks and threads: the engine calls the backend from its one executor
thread, the worker's reload verb from another, and the batcher replays its
own graphs from its threads. Every prefill, step, cache clear, capture and
weight copy here holds the serving ``ModelRuntime``'s device lock, so the
card runs one batch, prefill, step or capture at a time, on that runtime's
execute stream and graph pool (and under its float32 settings: no TF32).
The worker captures every graph at boot (``warm``), before serving
starts.

On the CPU the same class runs the module eagerly, with no graphs.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass

import torch

from ..convert import (seqformer_lm_flax_from_state_dict,
                       seqformer_lm_state_dict_from_flax)
from .ladder import DECODE_PROMPT_BUCKETS
from .registry import flax_spec

log = logging.getLogger("ai4e_tpu_torch.kvcache")


@dataclass
class LMServable:
    """A deployable autoregressive LM, the decode path's analogue of
    ``registry.ServableModel`` (which stays the batch path's contract: an
    LM never enters ``runtime.models``). ``module`` is a
    ``models.SeqFormerLM``; its ``.npz`` is a flax tree that
    ``convert.seqformer_lm_state_dict_from_flax`` reads."""

    name: str
    module: torch.nn.Module
    vocab_size: int
    max_len: int
    eos_id: int | None = None
    version: str = "1.0"
    checkpoint_path: str | None = None
    params_version: int = 1
    generation: int = 1


def build_lm_servable(name: str = "lm", vocab_size: int = 512,
                      max_len: int = 256, dim: int = 64, depth: int = 2,
                      heads: int = 4, eos_id: int | None = None,
                      generator: torch.Generator | None = None,
                      **_) -> LMServable:
    """A ``SeqFormerLM`` servable for the streaming path, its weights drawn
    on the CPU from ``generator`` (default: seed 0); the decode runtime
    moves it to its device. The ``**_`` sink takes the spec keys this
    family ignores, as the batch families do."""
    from ..models.seqformer import create_seqformer_lm

    module = create_seqformer_lm(generator=generator, vocab_size=vocab_size,
                                 max_len=max_len, dim=dim, depth=depth,
                                 heads=heads, device="cpu")
    return LMServable(name=name, module=module, vocab_size=vocab_size,
                      max_len=max_len, eos_id=eos_id)


@dataclass
class LMGraph:
    """One captured program: the graph, its static inputs and outputs, and
    how many times it was replayed."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    outputs: tuple
    replays: int = 0


class PagedDecodeRuntime:
    """The ``DecodeEngine`` backend over a ``SeqFormerLM``, on the device,
    lock, execute stream and graph pool of ``runtime`` (the worker's
    ``registry.ModelRuntime``). Every method blocks; the engine runs them
    on its single device-executor thread."""

    def __init__(self, servable: LMServable, runtime, slots: int = 8,
                 prompt_buckets=None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.device = runtime.device
        self._cuda = self.device.type == "cuda"
        self.servable = servable
        self.name = servable.name
        self.slots = slots
        self.max_len = servable.max_len
        self.eos_id = servable.eos_id
        raw = tuple(prompt_buckets) if prompt_buckets else (
            DECODE_PROMPT_BUCKETS)
        # Clamped to the cache length, with max_len always the top bucket,
        # so every admissible prompt (< max_len) has a graph.
        self.prompt_buckets = tuple(sorted(
            {min(int(b), self.max_len) for b in raw} | {self.max_len}))
        module = servable.module.to(self.device).eval()
        module.requires_grad_(False)
        self.module = module
        shape = (module.depth, slots, module.heads, self.max_len,
                 module.dim // module.heads)
        self._k = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._v = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.graphs: dict[tuple, LMGraph] = {}
        self._served_spec = None
        self._lock = runtime.device_lock
        self._stream = runtime.exec_stream if self._cuda else None
        self._pool = runtime.graph_pool if self._cuda else None

    # -- cache lifecycle ---------------------------------------------------

    @property
    def params_version(self) -> int:
        return self.servable.params_version

    @property
    def k_cache(self) -> torch.Tensor:
        return self._k

    @property
    def v_cache(self) -> torch.Tensor:
        return self._v

    def cache_nbytes(self) -> int:
        """Resident bytes of the pooled cache, both tensors."""
        return 2 * self._k.numel() * self._k.element_size()

    def reset_cache(self) -> None:
        """Zero the pooled cache in place (hot-reload invalidation: blocks
        computed under the old weights never serve). In place, because the
        captured graphs hold its address."""
        with self._device():
            self._k.zero_()
            self._v.zero_()

    # -- engine backend surface -------------------------------------------

    def bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if b >= n:
                return b
        return self.prompt_buckets[-1]

    def prefill_into(self, slot: int, tokens) -> int:
        """Run the prompt, padded to its bucket, through the prefill (its
        graph's replay on the card), copy its K/V block into ``slot`` and
        return the first generated token id."""
        n = len(tokens)
        if not 0 < n < self.max_len:
            raise ValueError(
                f"prompt of {n} tokens must be in [1, {self.max_len})")
        vocab = self.servable.vocab_size
        if not all(0 <= t < vocab for t in tokens):
            # On the card an id out of range is a device-side assert that
            # ends the process; JAX clamps it silently.
            raise ValueError(f"token ids must be in [0, {vocab})")
        bucket = self.bucket_for(n)
        padded = torch.zeros((1, bucket), dtype=torch.int64)
        padded[0, :n] = torch.as_tensor(list(tokens), dtype=torch.int64)
        length = torch.tensor([n], dtype=torch.int64)
        with self._device():
            if self._cuda:
                graph = self.graphs.get(("prefill", bucket))
                if graph is None:
                    graph = self._capture_prefill(bucket)
                graph.inputs[0].copy_(padded)
                graph.inputs[1].copy_(length)
                token, k_block, v_block = self._replay(graph)
            else:
                token, k_block, v_block = self.module.prefill(padded, length)
            self._k[:, slot, :, :bucket].copy_(k_block[:, 0])
            self._v[:, slot, :, :bucket].copy_(v_block[:, 0])
            return int(token[0])

    def step(self, tokens, positions, active) -> list[int]:
        """One decode step over the pool. ``active`` is advisory: every
        slot is computed; inactive rows are garbage the engine never
        reads."""
        del active
        tokens = torch.as_tensor(list(tokens), dtype=torch.int64)
        positions = torch.as_tensor(list(positions), dtype=torch.int64)
        with self._device():
            if self._cuda:
                graph = self.graphs.get(("step",))
                if graph is None:
                    graph = self._capture_step()
                graph.inputs[0].copy_(tokens)
                graph.inputs[1].copy_(positions)
                out = self._replay(graph)[0]
            else:
                out = self.module.decode_step(tokens, self._k, self._v,
                                              positions)[0]
            return out.tolist()

    # -- weights -----------------------------------------------------------

    def reload_params(self, new_params) -> int:
        """Swap the LM's weights for the flax-shaped tree ``new_params``.
        The tree must match the served one (structure, shapes, dtypes) or
        ``ValueError`` is raised and serving is unchanged; the new weights
        are staged on the device, then copied into the module's own
        tensors under the lock. Bumps ``params_version``, so the engine
        clears the cache at its next tick."""
        sd = self.module.state_dict()
        if self._served_spec is None:
            self._served_spec = flax_spec(
                seqformer_lm_flax_from_state_dict(sd))
        if flax_spec(new_params) != self._served_spec:
            raise ValueError("checkpoint tree does not match the served model")
        new_sd = seqformer_lm_state_dict_from_flax(new_params)
        staged = {k: new_sd[k].to(device=self.device, dtype=t.dtype)
                  for k, t in sd.items()}
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()
        with self._device():
            for key, tensor in sd.items():
                tensor.copy_(staged[key])
            self._sync()
            self.servable.params_version += 1
        return self.servable.params_version

    # -- warmup ------------------------------------------------------------

    def warm(self) -> float:
        """Run every program once (on the card: capture its graph and
        replay it): a prefill into slot 0 per prompt bucket and one step,
        then clear the cache. Returns wall seconds."""
        t0 = time.perf_counter()
        for bucket in self.prompt_buckets:
            self.prefill_into(0, [1] * min(bucket, self.max_len - 1))
        self.step([0] * self.slots, [1] * self.slots, [True] * self.slots)
        self.reset_cache()
        seconds = time.perf_counter() - t0
        log.info("decode warmup %s: %d prompt buckets + step in %.1fs%s",
                 self.name, len(self.prompt_buckets), seconds,
                 " (CUDA graphs captured)" if self._cuda else "")
        return seconds

    # -- graphs --------------------------------------------------------------

    def _capture_prefill(self, bucket: int) -> LMGraph:
        tokens = torch.zeros((1, bucket), dtype=torch.int64,
                             device=self.device)
        length = torch.ones((1,), dtype=torch.int64, device=self.device)
        graph = self._capture(lambda: self.module.prefill(tokens, length),
                              (tokens, length), f"prefill bucket {bucket}")
        self.graphs[("prefill", bucket)] = graph
        return graph

    def _capture_step(self) -> LMGraph:
        tokens = torch.zeros((self.slots,), dtype=torch.int64,
                             device=self.device)
        positions = torch.zeros((self.slots,), dtype=torch.int64,
                                device=self.device)
        graph = self._capture(
            lambda: self.module.decode_step(tokens, self._k, self._v,
                                            positions)[:1],
            (tokens, positions), f"step over {self.slots} slots")
        self.graphs[("step",)] = graph
        return graph

    def _capture(self, fn, inputs: tuple, label: str) -> LMGraph:
        """Run ``fn`` eagerly once, then capture it on the execute stream
        into the shared pool (the lock held by the caller). Nothing has
        replayed the graph yet."""
        fn()
        self._sync()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode="thread_local"):
            outputs = fn()
        log.info("captured %s %s", self.name, label)
        return LMGraph(graph, inputs, tuple(outputs))

    def _replay(self, graph: LMGraph) -> tuple:
        graph.graph.replay()
        graph.replays += 1
        return graph.outputs

    # -- helpers -------------------------------------------------------------

    @contextlib.contextmanager
    def _device(self):
        """The device lock, the execute stream and inference mode."""
        stream = (torch.cuda.stream(self._stream) if self._cuda
                  else contextlib.nullcontext())
        with self._lock, stream, torch.inference_mode():
            yield

    def _sync(self) -> None:
        if self._cuda:
            self._stream.synchronize()
