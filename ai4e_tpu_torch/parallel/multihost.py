"""Multi-process serving bridge — request ingestion on rank 0, SPMD on all
ranks; counterpart of ``ai4e_tpu/parallel/multihost.py``.

Every rank of a mesh must enter the same model calls in the same order
(their collectives pair up), but only rank 0 fronts the HTTP surface. The
design is the JAX package's sharded ingestion:

- every process calls ``init_distributed`` (``parallel.sharding``) and
  builds the same mesh, registers the same models and warms the same
  buckets (each rank takes its rows of a zeros batch: no feed);
- the **primary** (rank 0) runs the worker, the batcher and the platform
  stack. Its batcher executes through ``MultihostRuntime.run_batch_report``:
  it stages each follower's *own rows* of the batch on a host-local shard
  feed (an HTTP server checking a token), broadcasts a fixed-size int32
  work descriptor (model index, sequence number, dtype, shape up to rank
  8) as a CPU tensor over the process group, then runs its own rows (``ModelRuntime.
  run_rows``), whose collectives every rank enters;
- **followers** run ``follower_loop()``: block on the descriptor, fetch
  only their rows from the primary's feed (an HTTP GET: batch / dp bytes,
  not the whole batch), run the same bucket, and join the post-batch
  poison gather. A sentinel descriptor shuts them down;
- outputs come back gathered on every rank (``run_rows``), so the primary
  reads the whole batch's results with no further traffic.

Rows are owned by data coordinates (dp x fsdp, ``sharding.row_range``):
under sp, tp or ep every rank of one data coordinate fetches that
coordinate's rows.

A follower whose fetch fails (``AI4E_FAULT_FETCH_FAIL_NTHS`` injects
failures by ordinal) or whose run raises still enters every collective,
on a zeros shard, and reports its rows poisoned on the gather; the primary
fails exactly those rows (``RowPoisoned``), never serving the zeros'
answers. The feed advertises ``AI4E_FEED_ADVERTISE_IP`` (default: the
rendezvous host ``MASTER_ADDR``).
"""

from __future__ import annotations

import hmac
import logging
import os
import socket
import threading
import time

import numpy as np

from . import comm
from .sharding import is_primary, pad_to_multiple, process_count, \
    process_index, row_range

log = logging.getLogger("ai4e_tpu_torch.multihost")

_SHUTDOWN = -1
# Fixed-rank shape header so the descriptor is always the same shape.
_MAX_RANK = 8
# Staged shards older than this many sequence numbers are pruned (a
# follower that died mid-fetch must not leak primary memory forever).
_FEED_WINDOW = 8


def _fault_fetch_nths() -> frozenset[int]:
    """Fault-injection knob: 1-based shard-fetch ordinals this follower
    should fail (comma-separated in AI4E_FAULT_FETCH_FAIL_NTHS). Empty in
    production."""
    raw = os.environ.get("AI4E_FAULT_FETCH_FAIL_NTHS", "")
    return frozenset(int(s) for s in raw.split(",") if s.strip())


def _advertise_ip() -> str:
    """The address followers reach the feed on: ``AI4E_FEED_ADVERTISE_IP``,
    else ``MASTER_ADDR`` as an IPv4 address, else loopback."""
    ip = os.environ.get("AI4E_FEED_ADVERTISE_IP") or os.environ.get(
        "MASTER_ADDR", "127.0.0.1")
    if ip == "localhost":
        return "127.0.0.1"
    try:
        socket.inet_aton(ip)
    except OSError:
        ip = socket.gethostbyname(ip)
    return ip


class _ShardFeed:
    """Host-local HTTP server on the primary staging per-follower batch rows.

    One GET per (sequence, rank): ``/shard/{seq}/{rank}`` -> raw bytes,
    403 without the slice's token. Entries live until ``_FEED_WINDOW``
    newer batches have been staged, so a retried fetch still succeeds.
    """

    def __init__(self, token: bytes, bind: str):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        feed = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if not hmac.compare_digest(
                        self.headers.get("X-AI4E-Feed-Token", ""),
                        feed.token_str):
                    self.send_response(403)
                    self.end_headers()
                    return
                parts = self.path.strip("/").split("/")
                payload = None
                if len(parts) == 3 and parts[0] == "shard":
                    with feed._lock:
                        payload = feed._staged.get(
                            (int(parts[1]), int(parts[2])))
                if payload is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *a):  # quiet
                pass

        self.token_str = token.hex()
        self._staged: dict[tuple[int, int], bytes] = {}
        self._lock = threading.Lock()
        self._server = ThreadingHTTPServer((bind, 0), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="ai4e-shard-feed", daemon=True)
        self._thread.start()

    def stage(self, seq: int, rank: int, payload: bytes) -> None:
        with self._lock:
            self._staged[(seq, rank)] = payload
            for key in [k for k in self._staged if k[0] <= seq - _FEED_WINDOW]:
                del self._staged[key]

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def _fetch(url: str, token: str, timeout_s: float = 60.0) -> bytes:
    """GET with retry — the shard is staged before the descriptor
    broadcast, so a 404 only means a transient hiccup. Called only from
    ``follower_loop``, which runs without an event loop, so the blocking
    ``time.sleep`` backoff is right here."""
    import urllib.error
    import urllib.request

    deadline = time.monotonic() + timeout_s
    delay = 0.02
    while True:
        try:
            req = urllib.request.Request(
                url, headers={"X-AI4E-Feed-Token": token})
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.read()
        except (urllib.error.URLError, OSError) as e:
            if time.monotonic() >= deadline:
                raise TimeoutError(f"shard fetch {url} failed: {e}") from e
            time.sleep(delay)
            delay = min(delay * 2, 0.5)


class MultihostRuntime:
    """Wraps a ``ModelRuntime`` so batch execution is SPMD across ranks.
    With one process it is a pass-through. Attributes it does not define
    (``device``, ``model_launches``...) are the wrapped runtime's."""

    def __init__(self, runtime):
        self.runtime = runtime
        # Stable model ordering shared by all ranks: registration order.
        self._names = list(runtime.models)
        # Followers replay descriptors strictly in order, so the primary's
        # stage + descriptor + execute sequence is serialised.
        self._order_lock = threading.Lock()
        self._seq = 0
        self._feed = None
        self._feed_url = None
        self._feed_token = ""
        self.last_egress_bytes = 0
        self.total_egress_bytes = 0
        self.last_ingest_s = 0.0
        self._fetch_count = 0  # fault-injection ordinal (follower side)
        # ``poison_listener(flags)`` receives every gather's per-rank
        # flags (the coordinator's follower-health signal);
        # ``_process_phases`` accumulates (label, rank, seconds) tuples per
        # batch for the mesh endpoint's hop ledgers.
        self.poison_listener = None
        self._process_phases: list[tuple[str, int, float]] = []
        self._phases_lock = threading.Lock()
        if process_count() > 1:
            self._open_feed()

    def __getattr__(self, name: str):
        return getattr(self.runtime, name)

    # Pass-throughs, so that the batcher treats this as a ModelRuntime.
    @property
    def models(self):
        return self.runtime.models

    @property
    def mesh(self):
        return self.runtime.mesh

    @property
    def data_axis_size(self) -> int:
        return self.runtime.data_axis_size

    def supports_split_phases(self) -> bool:
        return process_count() == 1 and self.runtime.supports_split_phases()

    def _open_feed(self) -> None:
        """The primary opens the shard feed; every rank learns its address
        and bearer token from one broadcast (port, IPv4 and 16 token bytes
        as int32s)."""
        addr = np.zeros((21,), np.int32)
        if is_primary():
            ip = _advertise_ip()
            token = os.urandom(16)
            self._feed = _ShardFeed(
                token, "127.0.0.1" if ip.startswith("127.") else "0.0.0.0")
            addr[0] = self._feed.port
            addr[1:5] = [int(o) for o in ip.split(".")]
            addr[5:21] = np.frombuffer(token, np.uint8)
        addr = comm.broadcast_host(addr)
        self._feed_url = (f"http://{addr[1]}.{addr[2]}.{addr[3]}.{addr[4]}"
                          f":{addr[0]}")
        self._feed_token = bytes(addr[5:21].astype(np.uint8)).hex()

    def _model_index(self, name: str) -> int:
        try:
            return self._names.index(name)
        except ValueError:
            raise KeyError(
                f"model {name!r} registered after MultihostRuntime was "
                "built; register every model before wrapping") from None

    def _plan(self, name: str, global_shape: tuple) -> dict[int, list]:
        """dim-0 row ranges each rank computes: its data coordinate's."""
        mesh = self.runtime.mesh
        return {r: [row_range(mesh, int(global_shape[0]), r)]
                for r in range(process_count())}

    # -- primary side (the batcher's executor thread) ------------------------

    def run_batch(self, model_name: str, batch: np.ndarray):
        return self.run_batch_report(model_name, batch)[0]

    def run_batch_phases(self, model_name: str, batch: np.ndarray):
        out, poisoned = self.run_batch_report(model_name, batch)
        return out, poisoned, {}

    def run_batch_report(self, model_name: str, batch: np.ndarray
                         ) -> tuple[object, frozenset]:
        """Execute one batch; returns ``(outputs, poisoned_rows)``, the
        global dim-0 indices whose results are invalid because a follower
        degraded (fetch failure -> zeros shard, or a failed local run)."""
        if process_count() == 1:
            return self.runtime.run_batch_report(model_name, batch)
        if not is_primary():
            raise RuntimeError(
                "run_batch on a follower — followers run follower_loop()")
        batch = np.ascontiguousarray(batch)
        me = process_index()
        with self._order_lock:
            t0 = time.perf_counter()
            self._seq += 1
            plan = self._plan(model_name, batch.shape)
            egress = 0
            phases: list[tuple[str, int, float]] = []
            for rank, ranges in plan.items():
                if rank == me:
                    continue
                ts = time.perf_counter()
                payload = np.concatenate(
                    [batch[a:b] for a, b in ranges]).tobytes()
                self._feed.stage(self._seq, rank, payload)
                phases.append(("h2d", rank, time.perf_counter() - ts))
                egress += len(payload)
            self.last_egress_bytes = egress
            self.total_egress_bytes += egress
            self._broadcast_descriptor(
                self._model_index(model_name), self._seq, batch)
            (a, b), = plan[me]
            self.last_ingest_s = time.perf_counter() - t0
            ts = time.perf_counter()
            try:
                out, _ = self.runtime.run_rows(model_name, batch[a:b],
                                               batch.shape[0])
            finally:
                # Followers enter the gather unconditionally; a primary
                # that skipped it would misalign every later collective.
                flags = self._gather_poison(0)
            phases.append(("execute", me, time.perf_counter() - ts))
            with self._phases_lock:
                self._process_phases.extend(phases)
            if self.poison_listener is not None:
                self.poison_listener(list(flags))
            poisoned: set[int] = set()
            for rank, flag in enumerate(flags):
                if flag:
                    for a, b in plan.get(rank, []):
                        poisoned.update(range(a, b))
            return out, frozenset(poisoned)

    def prepare_buckets(self, name: str, buckets) -> tuple[int, ...]:
        """Run candidate ladder buckets THROUGH the broadcast path, so every
        follower enters the same bucket; the swap (``apply_ladder``) stays
        primary-local, since followers only mirror the shapes the primary
        broadcasts."""
        if process_count() == 1:
            return self.runtime.prepare_buckets(name, buckets)
        servable = self.runtime.models[name]
        aligned = tuple(sorted({
            pad_to_multiple(int(b), self.data_axis_size) for b in buckets}))
        if not aligned:
            raise ValueError(f"empty ladder for {name}")
        for bucket in aligned:
            if (name, bucket) in self.runtime._executed_shapes:
                continue
            self.run_batch_report(name, np.zeros(
                (bucket, *servable.input_shape), servable.input_dtype))
        return aligned

    def apply_ladder(self, name: str, buckets) -> tuple[int, ...]:
        return self.runtime.apply_ladder(name, buckets)

    def reload_params(self, name: str, new_params):
        """Refused on more than one process: the followers would keep the
        old weights."""
        if process_count() > 1:
            raise ValueError("reload on a multi-process mesh is not "
                             "supported: the followers would keep the old "
                             "weights; restart the mesh with the checkpoint")
        return self.runtime.reload_params(name, new_params)

    def drain_process_phases(self) -> list[tuple[str, int, float]]:
        """Pop the accumulated per-rank device-phase tuples."""
        with self._phases_lock:
            out, self._process_phases = self._process_phases, []
        return out

    def shutdown_followers(self) -> None:
        if process_count() > 1 and is_primary():
            with self._order_lock:
                self._broadcast_descriptor(_SHUTDOWN, 0, None)
                if self._feed is not None:
                    self._feed.shutdown()

    # -- follower side -------------------------------------------------------

    def follower_loop(self) -> None:
        """Run on every non-primary rank: mirror the primary's batches
        until the shutdown sentinel arrives."""
        assert not is_primary(), "primary must not enter follower_loop"
        me = process_index()
        while True:
            model_idx, seq, shape, dtype = self._receive_descriptor()
            if model_idx == _SHUTDOWN:
                log.info("follower %d: shutdown", me)
                return
            t0 = time.perf_counter()
            name = self._names[model_idx]
            (a, b), = self._plan(name, shape)[me]
            poisoned = 0
            try:
                self._fetch_count += 1
                if self._fetch_count in _fault_fetch_nths():
                    raise RuntimeError(
                        f"injected fetch fault #{self._fetch_count}")
                raw = _fetch(f"{self._feed_url}/shard/{seq}/{me}",
                             self._feed_token)
                rows = np.frombuffer(raw, dtype).reshape(-1, *shape[1:])
                if rows.shape[0] != b - a:
                    raise RuntimeError(
                        f"feed sent {rows.shape[0]} rows, plan wants {b - a}")
            except Exception:  # noqa: BLE001 — a dead fetch must NOT desync
                # Every rank must still enter the same collectives or the
                # primary waits on a missing participant: run a zeros
                # shard and report these rows poisoned on the gather.
                log.exception(
                    "follower %d: shard fetch for %s seq %d failed; running "
                    "a ZEROS shard to keep the mesh in lockstep — reporting "
                    "these rows poisoned", me, name, seq)
                rows = np.zeros((b - a, *shape[1:]), dtype)
                poisoned = 1
            self.last_ingest_s = time.perf_counter() - t0
            try:
                self.runtime.run_rows(name, rows, shape[0])
            except Exception:  # noqa: BLE001 — mirror the primary's policy
                log.exception("follower %d: batch for %s failed; continuing",
                              me, name)
                poisoned = 1
            self._gather_poison(poisoned)

    # -- post-batch health gather -------------------------------------------

    def _gather_poison(self, my_flag: int) -> np.ndarray:
        """All-gather one int per rank after every batch: 1 = this rank's
        rows are invalid. Returns the flags in rank order."""
        return np.concatenate(comm.all_gather_host(
            np.asarray([my_flag], np.int32)))

    # -- the descriptor ------------------------------------------------------

    def _broadcast_descriptor(self, model_idx: int, seq: int, batch) -> None:
        header = np.zeros((3 + _MAX_RANK,), np.int32)
        header[0] = model_idx
        header[1] = seq
        if batch is not None:
            header[2] = _dtype_code(batch.dtype)
            header[3:3 + batch.ndim] = batch.shape
        comm.broadcast_host(header)

    def _receive_descriptor(self):
        header = comm.broadcast_host(np.zeros((3 + _MAX_RANK,), np.int32))
        model_idx = int(header[0])
        if model_idx == _SHUTDOWN:
            return model_idx, 0, None, None
        shape = tuple(int(d) for d in header[3:] if d > 0)
        return model_idx, int(header[1]), shape, _code_dtype(int(header[2]))


_DTYPES = [np.float32, np.float16, np.uint8, np.int32, np.int8]


def _dtype_code(dtype) -> int:
    for i, d in enumerate(_DTYPES):
        if np.dtype(dtype) == np.dtype(d):
            return i
    raise ValueError(f"unsupported broadcast dtype {dtype}")


def _code_dtype(code: int):
    return np.dtype(_DTYPES[code])
