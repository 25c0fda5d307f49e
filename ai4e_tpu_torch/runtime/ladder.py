"""Traffic-tuned batch-bucket ladders — a copy of ``ai4e_tpu/runtime/
ladder.py`` driving the port's ``ModelRuntime``.

- ``ShapeHistogram`` keeps a bounded, exponentially-decayed histogram of
  observed batch demand per servable: the queue length at each cut before
  it is clamped, clamped only to the FACTORY ladder's max, so a swap that
  shrank the top bucket can still witness the larger demand that should
  grow it back;
- ``derive_ladder`` turns a histogram into a bucket ladder minimizing
  expected pad-waste × program count under a max-programs budget (a
  dynamic program over candidate cut points; the factory ladder is always
  a candidate, so the derived ladder's expected pad-waste never exceeds
  the factory ladder's on the same histogram whenever the budget admits
  it);
- ``LadderManager`` owns the loop: observe cuts → re-derive on a period →
  prepare the new buckets in the background (on the card: run each once
  and capture its CUDA graph, ``ModelRuntime.prepare_buckets``) →
  atomically swap the ladder in → persist it, so that a restarted worker
  warms the traffic-tuned ladder and serves hot from its first request.

Swap safety: a new ladder is assigned only after every one of its buckets
has an executed program (``ModelRuntime.apply_ladder`` refuses otherwise),
and an old ladder's programs are never evicted, so a batch cut against the
old tuple stays warm too.

Persistence: an entry is keyed by a fingerprint of the model's code
identity (name, version, input geometry) and records the factory ladder it
was derived from. A ``params_version`` bump (hot weight reload) keeps it;
a code, geometry or factory-ladder change discards it.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time

import numpy as np

log = logging.getLogger("ai4e_tpu_torch.ladder")

# -- factory ladders ------------------------------------------------------

#: ServableModel's default batch buckets.
DEFAULT_BUCKETS = (1, 2, 4, 8)
#: Image-classifier family default (landcover/species/imagenet-class).
IMAGE_BUCKETS = (1, 16, 64)
#: Detector family default (4x the pixels per example of the classifiers).
DETECTOR_BUCKETS = (1, 8, 16)
#: The static ``ai4e_batch_size`` exposition ladder of a batcher without
#: ladder derivation.
EXPOSITION_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
#: Decode-path prompt buckets (``runtime/kvcache.py``): a streaming prompt
#: pads to the smallest fitting bucket before prefill, so the card holds
#: one prefill graph a bucket, not one a prompt length. The decode runtime
#: always adds the K/V cache length as the covering top bucket.
#: ``AI4E_RUNTIME_DECODE_PROMPT_BUCKETS`` overrides it.
DECODE_PROMPT_BUCKETS = (1, 16, 64)


def _align_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= n (the bucket rounding of a
    runtime whose batch axis is split ``multiple`` ways; 1 on one card)."""
    if multiple <= 1:
        return int(n)
    return int(math.ceil(n / multiple) * multiple)


def exposition_buckets(servables) -> tuple[int, ...]:
    """``ai4e_batch_size`` exposition buckets built from the servables'
    OWN ladders (satellite: the static copy at batcher construction
    would drift the moment ladders are derived). Falls back to the
    static exposition ladder when no servable is registered yet."""
    union = sorted({int(b) for s in servables for b in s.batch_buckets})
    return tuple(union) if union else EXPOSITION_BUCKETS


# -- observed-shape histogram ----------------------------------------------


class ShapeHistogram:
    """Bounded, exponentially-decayed histogram of observed batch-cut
    sizes. ``window_s`` is the half-life: a cut size not seen for one
    window carries half its weight, so the ladder follows traffic shifts
    instead of averaging over the process lifetime. Bounded at
    ``max_sizes`` distinct sizes (lowest-weight entry evicted) so an
    adversarial size sweep cannot grow it without bound. Thread-safe:
    observed from the event loop, snapshotted from the deriver thread."""

    def __init__(self, window_s: float = 300.0, max_sizes: int = 256,
                 clock=time.monotonic):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = window_s
        self.max_sizes = max_sizes
        self._clock = clock
        self._lock = threading.Lock()
        self._weights: dict[int, float] = {}
        self._stamps: dict[int, float] = {}
        self._count = 0  # raw observations, never decayed

    def _decayed(self, size: int, now: float) -> float:
        w = self._weights.get(size, 0.0)
        if not w:
            return 0.0
        return w * 0.5 ** ((now - self._stamps[size]) / self.window_s)

    def observe(self, n: int, weight: float = 1.0) -> None:
        if n < 1:
            return
        now = self._clock()
        with self._lock:
            self._count += 1
            self._weights[n] = self._decayed(n, now) + weight
            self._stamps[n] = now
            if len(self._weights) > self.max_sizes:
                victim = min(self._weights,
                             key=lambda s: self._decayed(s, now))
                del self._weights[victim]
                del self._stamps[victim]

    def snapshot(self) -> dict[int, float]:
        """Decayed weights per size; entries below 1e-6 dropped."""
        now = self._clock()
        with self._lock:
            return {s: w for s in self._weights
                    if (w := self._decayed(s, now)) > 1e-6}

    @property
    def observations(self) -> int:
        return self._count


# -- derivation ------------------------------------------------------------


def expected_pad_waste(ladder, hist: dict[int, float]) -> float:
    """Expected padded slots per cut under ``ladder``: each observed size
    pads to the smallest bucket >= it (sizes above the largest bucket
    clamp — the batcher never cuts past ``max_bucket``, so they only
    appear when comparing a foreign histogram against a smaller ladder,
    and a clamped cut pads nothing)."""
    buckets = sorted(ladder)
    total = 0.0
    for s, w in hist.items():
        b = next((b for b in buckets if b >= s), None)
        if b is not None:
            total += w * (b - s)
    return total


def derive_ladder(hist: dict[int, float], *, baseline,
                  max_programs: int = 16, align: int = 1
                  ) -> tuple[int, ...]:
    """Derive a bucket ladder from an observed cut-size histogram.

    Objective: minimize expected pad-waste × program count, subject to
    at most ``max_programs`` buckets — more programs cost compile time,
    AOT-warmup time, and device program memory, so zero-waste ladders
    prefer the fewest buckets achieving it. Guarantees (property-tested
    in the tests):

    - strictly ascending (monotone) buckets, all multiples of ``align``
      (the mesh data-axis size — the SPMD divisibility rule
      ``ModelRuntime.register`` applies to configured ladders);
    - the largest bucket covers the observed max;
    - expected pad-waste <= the ``baseline`` (static) ladder's on the
      same histogram whenever the budget admits the baseline itself
      (the baseline's buckets are always candidates).

    An empty histogram returns the aligned baseline unchanged.
    """
    if max_programs < 1:
        raise ValueError(f"max_programs must be >= 1, got {max_programs}")
    hist = {int(s): float(w) for s, w in hist.items()
            if s >= 1 and w > 0}
    base = tuple(sorted({_align_up(b, align) for b in baseline}))
    if not hist:
        return base
    max_obs = max(hist)
    cover = _align_up(max_obs, align)
    # Candidate cut points: every aligned observed size, plus the
    # baseline's buckets up to the covering one — including the baseline
    # makes "the static ladder, trimmed" a reachable DP solution, which
    # is what makes the waste-vs-baseline guarantee unconditional when
    # max_programs admits it.
    cand = sorted({_align_up(s, align) for s in hist}
                  | {b for b in base if b <= cover} | {cover})
    n = len(cand)
    # Prefix sums over observed weight per candidate index: sizes are
    # assigned to the smallest chosen bucket >= them, so the waste of
    # choosing cand[i] after cand[j] is sum over sizes in (cand[j],
    # cand[i]] of w*(cand[i] - s).
    pw = [0.0] * (n + 1)   # cumulative weight of sizes <= cand[i-1]
    pws = [0.0] * (n + 1)  # cumulative weight*size
    sizes = sorted(hist)
    si = 0
    for i, c in enumerate(cand):
        pw[i + 1], pws[i + 1] = pw[i], pws[i]
        while si < len(sizes) and sizes[si] <= c:
            pw[i + 1] += hist[sizes[si]]
            pws[i + 1] += hist[sizes[si]] * sizes[si]
            si += 1

    def seg_cost(j: int, i: int) -> float:
        # Waste of sizes in (cand[j-1], cand[i-1]] padded to cand[i-1];
        # j == 0 means "no smaller bucket chosen".
        return cand[i - 1] * (pw[i] - pw[j]) - (pws[i] - pws[j])

    top = cand.index(cover) + 1  # 1-based index of the forced top bucket
    kmax = min(max_programs, top)
    INF = float("inf")
    # best[k][i]: min waste covering all sizes <= cand[i-1] with exactly
    # k buckets, the largest being cand[i-1].
    best = [[INF] * (top + 1) for _ in range(kmax + 1)]
    parent: dict[tuple[int, int], int] = {}
    for i in range(1, top + 1):
        best[1][i] = seg_cost(0, i)
    for k in range(2, kmax + 1):
        for i in range(k, top + 1):
            for j in range(k - 1, i):
                w = best[k - 1][j] + seg_cost(j, i)
                if w < best[k][i]:
                    best[k][i] = w
                    parent[(k, i)] = j
    waste_at = {k: best[k][top] for k in range(1, kmax + 1)
                if best[k][top] < INF}
    base_waste = expected_pad_waste(base, hist)
    # Never do worse than the static ladder when the budget allows
    # matching it; within the admissible set, minimize waste × count
    # (ties → fewer programs, then less waste).
    admissible = {k: w for k, w in waste_at.items()
                  if w <= base_waste + 1e-9} or waste_at
    k_star = min(admissible, key=lambda k: (admissible[k] * k, k,
                                            admissible[k]))
    chosen = []
    k, i = k_star, top
    while k >= 1:
        chosen.append(cand[i - 1])
        i = parent.get((k, i), 0)
        k -= 1
    return tuple(sorted(chosen))


# -- persistence -----------------------------------------------------------


def servable_fingerprint(servable) -> str:
    """Code-identity fingerprint for persisted-ladder validity: name,
    declared version, input geometry. Does NOT include
    ``params_version`` — a hot weight reload keeps the ladder valid
    (same traffic, same shapes) — and cannot include the factory ladder
    (at persist time ``batch_buckets`` already holds the DERIVED
    ladder); a deliberate factory-ladder change is instead caught at
    ``LadderManager.restore`` by comparing the entry's recorded
    ``baseline`` against the servable's registered buckets."""
    dtype = np.dtype(servable.input_dtype).name
    return "|".join([
        servable.name, str(servable.version),
        "x".join(str(d) for d in servable.input_shape), dtype,
    ])


def load_ladders(path: str) -> dict:
    """Persisted ladder entries ({model: {fingerprint, baseline, buckets,
    generation}}); {} on a missing or unreadable file — a corrupt ladder
    file must never block a worker boot, the factory ladder serves."""
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def save_ladders(path: str, entries: dict) -> None:
    """Atomic write (tmp + rename) — a crash mid-persist leaves the
    previous file intact, same discipline as every durable artifact."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(entries, fh, sort_keys=True)
    os.replace(tmp, path)


# -- the manager -----------------------------------------------------------


class LadderManager:
    """Owns per-servable cut histograms and the derive→compile→swap→
    persist loop. The batcher calls ``observe_cut`` at every batch cut;
    every ``period_s`` a background thread re-derives, prepares any new
    buckets through ``prepare_buckets`` (a run and a graph capture each on
    the card), and
    atomically swaps the servable's ladder (``ModelRuntime.apply_ladder``
    refuses a bucket without an executed program — the swap-safety
    invariant). ``dwell_s`` bounds swap churn. All knobs ride
    ``AI4E_RUNTIME_LADDER_*`` (docs/config.md)."""

    def __init__(self, runtime, *, window_s: float = 300.0,
                 max_programs: int = 16, period_s: float = 60.0,
                 dwell_s: float = 120.0, min_observations: int = 32,
                 persist_path: str | None = None, metrics=None,
                 clock=time.monotonic):
        from ..metrics import DEFAULT_REGISTRY
        self.runtime = runtime
        self.window_s = window_s
        self.max_programs = max_programs
        self.period_s = period_s
        self.dwell_s = dwell_s
        self.min_observations = min_observations
        self.persist_path = persist_path
        self._clock = clock
        self._lock = threading.Lock()
        # Serializes the load-modify-write of the ladder file: two
        # models' deriver threads swapping in the same period would
        # otherwise each read a stale snapshot and the last writer
        # would drop the other's entry (restart would then warm that
        # model's factory ladder — the restart-serves-hot contract).
        self._persist_lock = threading.Lock()
        self._hists: dict[str, ShapeHistogram] = {}
        self._baseline: dict[str, tuple[int, ...]] = {}
        self._generation: dict[str, int] = {}
        self._last_swap: dict[str, float] = {}
        self._next_check: dict[str, float] = {}
        self._busy: set[str] = set()
        self.metrics = metrics or DEFAULT_REGISTRY
        self._gen_gauge = self.metrics.gauge(
            "ai4e_ladder_generation",
            "Derived-ladder generation per model (0 = factory ladder)")
        self._buckets_gauge = self.metrics.gauge(
            "ai4e_ladder_buckets",
            "Compiled bucket count in the serving ladder per model")
        self._derives_total = self.metrics.counter(
            "ai4e_ladder_derives_total",
            "Ladder derivation attempts by model and outcome "
            "(swapped/unchanged/skipped/failed)")
        self._pad_waste_gauge = self.metrics.gauge(
            "ai4e_ladder_expected_pad_ratio",
            "Expected padded-slots / occupied-slots of the serving ladder "
            "on the current cut-size histogram, per model")

    # -- startup restore ---------------------------------------------------

    def restore(self) -> dict[str, tuple[int, ...]]:
        """Apply persisted derived ladders to registered servables —
        called BEFORE ``warmup`` so a restarted worker warms the
        traffic-tuned ladder, not the factory default, and its first
        serving call stamps ``execute``, never ``compile``. Entries with
        a stale fingerprint (model code changed) or a mesh whose
        alignment no longer admits the persisted buckets are discarded.
        Returns {model: restored buckets}."""
        restored: dict[str, tuple[int, ...]] = {}
        if not self.persist_path:
            return restored
        entries = load_ladders(self.persist_path)
        align = getattr(self.runtime, "data_axis_size", 1)
        for name, servable in self.runtime.models.items():
            self._adopt(name)
            entry = entries.get(name)
            if not isinstance(entry, dict):
                continue
            if entry.get("fingerprint") != servable_fingerprint(servable):
                continue
            if (tuple(int(b) for b in entry.get("baseline", ()))
                    != tuple(servable.batch_buckets)):
                # The operator changed the FACTORY ladder since this
                # entry persisted (docs/device_path.md invalidation
                # rule): the new factory buckets must serve — and be
                # re-derivable from — fresh traffic, not be shadowed by
                # a ladder tuned under the old config.
                continue
            buckets = tuple(int(b) for b in entry.get("buckets", ()))
            if not buckets or any(b % max(1, align) for b in buckets):
                continue
            servable.batch_buckets = tuple(sorted(set(buckets)))
            self._generation[name] = int(entry.get("generation", 1))
            self._gen_gauge.set(self._generation[name], model=name)
            self._buckets_gauge.set(len(servable.batch_buckets), model=name)
            restored[name] = servable.batch_buckets
            log.info("ladder restore %s: generation %d, buckets %s",
                     name, self._generation[name], servable.batch_buckets)
        return restored

    # -- hot-path surface --------------------------------------------------

    def _adopt(self, name: str) -> None:
        if name in self._baseline:
            return
        servable = self.runtime.models[name]
        self._baseline[name] = tuple(servable.batch_buckets)
        self._generation.setdefault(name, 0)
        self._hists[name] = ShapeHistogram(window_s=self.window_s,
                                           clock=self._clock)
        self._next_check[name] = self._clock() + self.period_s
        self._gen_gauge.set(self._generation[name], model=name)
        self._buckets_gauge.set(len(servable.batch_buckets), model=name)

    def observe_cut(self, name: str, n: int) -> None:
        """One batch cut's PRE-clamp demand of ``n`` examples — O(1),
        called by the batcher on the event loop. The demand is clamped
        to the FACTORY ladder's max (the operator-configured memory
        bound), NOT the current derived ladder's — otherwise a swap that
        shrank the top bucket would cap every later observation at it
        and the ladder could only ever ratchet down. Kicks the
        background deriver at most once per ``period_s`` per model;
        derivation/compile never runs here."""
        if name not in self._baseline:
            self._adopt(name)
        self._hists[name].observe(min(n, max(self._baseline[name])))
        now = self._clock()
        with self._lock:
            if now < self._next_check[name] or name in self._busy:
                return
            self._next_check[name] = now + self.period_s
            self._busy.add(name)
        threading.Thread(target=self._derive_in_background, args=(name,),
                         name=f"ladder-derive-{name}", daemon=True).start()

    # -- deriver -----------------------------------------------------------

    def _derive_in_background(self, name: str) -> None:
        try:
            outcome = self.derive_now(name)
            log.debug("ladder derive %s: %s", name, outcome)
        except Exception:  # noqa: BLE001 — counted outcome=failed below; a deriver crash must never reach serving
            self._derives_total.inc(model=name, outcome="failed")
            log.exception("ladder derivation failed for %s "
                          "(old ladder keeps serving)", name)
        finally:
            with self._lock:
                self._busy.discard(name)

    def derive_now(self, name: str) -> str:
        """One derivation pass (synchronous — the background thread's
        body, callable directly from tests): snapshot the
        histogram, derive, prepare new buckets, swap, persist.
        Returns the outcome recorded on ``ai4e_ladder_derives_total``."""
        self._adopt(name)
        hist_obj = self._hists[name]
        hist = hist_obj.snapshot()
        if hist_obj.observations < self.min_observations or not hist:
            self._derives_total.inc(model=name, outcome="skipped")
            return "skipped"
        align = getattr(self.runtime, "data_axis_size", 1)
        new = derive_ladder(hist, baseline=self._baseline[name],
                            max_programs=self.max_programs, align=align)
        current = tuple(self.runtime.models[name].batch_buckets)
        if new == current:
            self._pad_waste_gauge.set(self._expected_ratio(current, hist),
                                      model=name)
            self._derives_total.inc(model=name, outcome="unchanged")
            return "unchanged"
        now = self._clock()
        last = self._last_swap.get(name)
        if last is not None and now - last < self.dwell_s:
            # The gauge documents the SERVING ladder's expected ratio —
            # keep it tracking `current`, not the candidate that did not
            # swap in (a skipped/failed derive must not show a phantom
            # improvement next to ai4e_batch_pad_ratio).
            self._pad_waste_gauge.set(self._expected_ratio(current, hist),
                                      model=name)
            self._derives_total.inc(model=name, outcome="skipped")
            return "skipped"
        # Prepare (run + capture) every new bucket FIRST (background
        # thread, off the serving path), then the swap is one attribute
        # assignment — in-flight cuts hold the old tuple, whose programs
        # stay compiled.
        prepared = self.runtime.prepare_buckets(name, new)
        self.runtime.apply_ladder(name, prepared)
        self._pad_waste_gauge.set(self._expected_ratio(prepared, hist),
                                  model=name)
        self._generation[name] = self._generation.get(name, 0) + 1
        self._last_swap[name] = self._clock()
        self._gen_gauge.set(self._generation[name], model=name)
        self._buckets_gauge.set(len(prepared), model=name)
        self._derives_total.inc(model=name, outcome="swapped")
        log.info("ladder swap %s: generation %d, %s -> %s", name,
                 self._generation[name], current, prepared)
        self._persist(name, prepared)
        return "swapped"

    @staticmethod
    def _expected_ratio(ladder, hist: dict[int, float]) -> float:
        occupied = sum(s * w for s, w in hist.items())
        if occupied <= 0:
            return 0.0
        return expected_pad_waste(ladder, hist) / occupied

    def _persist(self, name: str, buckets: tuple[int, ...]) -> None:
        if not self.persist_path:
            return
        servable = self.runtime.models[name]
        with self._persist_lock:
            entries = load_ladders(self.persist_path)
            entries[name] = {
                "fingerprint": servable_fingerprint(servable),
                "baseline": list(self._baseline[name]),
                "buckets": list(buckets),
                "generation": self._generation[name],
            }
            try:
                save_ladders(self.persist_path, entries)
            except OSError:
                log.warning("ladder persist failed for %s at %s (the "
                            "swap is live; a restart re-derives)", name,
                            self.persist_path, exc_info=True)

    # -- introspection (bench / tests) -------------------------------------

    def generation(self, name: str) -> int:
        return self._generation.get(name, 0)

    def baseline(self, name: str) -> tuple[int, ...]:
        return self._baseline.get(name, ())
