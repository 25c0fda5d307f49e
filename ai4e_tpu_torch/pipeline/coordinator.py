"""Pipeline coordinator — executes declared DAGs over the existing fabric.
(A copy of ``ai4e_tpu/pipeline/coordinator.py``.)

One coordinator per platform assembly (``PlatformConfig(pipeline=True)``).
It owns no transport and no execution of its own; every mechanism is a
reuse of what the platform already has:

- the **root task** is an ordinary gateway-created task whose endpoint is
  the spec's internal entry path (``PipelineSpec.entry_path``) — the store
  publishes it onto the broker queue the coordinator consumes, so restart
  re-seeding (journal replay → ``unfinished_tasks`` republish) IS the
  resume path, with no coordinator-private durability;
- each **stage** runs as a store sub-record ``{root}~{stage}`` dispatched
  through the stage endpoint's ordinary dispatcher — admission deadline
  drops, resilience retries/failover, orchestration placement, and hop
  ledgers all apply to stage work because it *is* ordinary work;
- **stage results** land under the root TaskId's result-stage keys
  (``{root}:{stage}`` — the surface the reference's ensembles already
  used for intermediate outputs), which doubles as the resume marker: a
  relaunched run treats any present stage result as a completed stage;
- the **stage cache** is the inference result cache (``rescache/``) keyed
  on the stage endpoint's family + the canonical stage input hash, so a
  re-run pipeline (same payload) skips completed stages — and a worker
  checkpoint reload invalidates exactly the stages that model serves
  (the family IS the endpoint path the reload hook already invalidates);
- **budget carving**: each stage's sub-task carries
  ``stage_deadline(...)`` — its declared fraction of the request's
  remaining ``X-Deadline-Ms`` budget — and the coordinator sheds a stage
  whose budget is already spent BEFORE dispatch (``expired`` root, never
  a corpse through the broker), the same admission contract every other
  hop honors;
- **streaming**: every stage transition publishes onto the
  ``TaskEventHub`` (``events.py``) feeding the gateway's SSE surface,
  and the first stage completion is the run's time-to-first-partial
  (``ai4e_pipeline_ttfp_seconds``).
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import time

from ..metrics import DEFAULT_REGISTRY, MetricsRegistry
from ..observability import ledger as hop
from ..rescache.keys import request_key
from ..taskstore import APITask, TaskNotFound, TaskStatus
from .events import INLINE_RESULT_BYTES, STAGE, TaskEventHub
from .spec import (JoinInput, PipelineSpec, StageState, initial_states,
                   split_sub_task_id, stage_deadline, sub_task_id)

log = logging.getLogger("ai4e_tpu_torch.pipeline")


class PipelineCoordinator:
    """Drives registered ``PipelineSpec``s; one consumer loop per entry
    queue, one in-memory run per live root task."""

    def __init__(self, store, broker, hub: TaskEventHub | None = None,
                 result_cache=None, admission=None, observability=None,
                 metrics: MetricsRegistry | None = None,
                 queue_names=None):
        self.store = store
        self.broker = broker
        self.hub = hub
        self.result_cache = result_cache
        self.admission = admission
        self.observability = observability
        self.metrics = metrics or DEFAULT_REGISTRY
        # entry path -> [queue names] (shard sub-queues under a sharded
        # store; the identity mapping otherwise). Resolved by the platform
        # assembly, which knows the shard layout.
        self._queue_names = queue_names or (lambda path: [path])
        self.specs: dict[str, PipelineSpec] = {}       # by pipeline name
        self._by_entry: dict[str, PipelineSpec] = {}   # by entry path
        self._runs: dict[str, "_PipelineRun"] = {}     # by root task id
        self._loops: list[asyncio.Task] = []
        self._stop = asyncio.Event()
        self._started = False
        self._runs_total = self.metrics.counter(
            "ai4e_pipeline_runs_total",
            "Pipeline runs reaching a terminal outcome, by pipeline")
        self._stages_total = self.metrics.counter(
            "ai4e_pipeline_stages_total",
            "Pipeline stage transitions, by pipeline/stage/outcome "
            "(completed/failed/expired/shed, plus cached stage-cache "
            "hits and resumed replays that skipped execution)")
        self._ttfp = self.metrics.histogram(
            "ai4e_pipeline_ttfp_seconds",
            "Time from run launch to the first stage partial, by pipeline")
        # Sub-task terminal transitions arrive on the store's listener
        # thread; runs are driven on the coordinator's event loop.
        store.add_listener(self._on_task_change)
        self._loop: asyncio.AbstractEventLoop | None = None

    # -- registration --------------------------------------------------------

    def register(self, spec: PipelineSpec) -> None:
        if spec.name in self.specs:
            raise ValueError(f"pipeline {spec.name!r} already registered")
        self.specs[spec.name] = spec
        self._by_entry[spec.entry_path] = spec
        for qn in self._queue_names(spec.entry_path):
            self.broker.register_queue(qn)
        if self._started:
            # Late registration on a running platform: start its loops now.
            loop = asyncio.get_running_loop()
            for qn in self._queue_names(spec.entry_path):
                self._loops.append(loop.create_task(self._consume(spec, qn)))

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._stop.clear()
        self._started = True
        self._loop = asyncio.get_running_loop()
        for spec in self.specs.values():
            for qn in self._queue_names(spec.entry_path):
                self._loops.append(
                    self._loop.create_task(self._consume(spec, qn)))

    async def stop(self) -> None:
        self._started = False
        self._stop.set()
        for t in self._loops:
            t.cancel()
        for run in list(self._runs.values()):
            run.cancel()
        await asyncio.gather(*self._loops,
                             *(r.task for r in self._runs.values()
                               if r.task is not None),
                             return_exceptions=True)
        self._loops.clear()
        self._runs.clear()

    # -- entry-queue consumption --------------------------------------------

    async def _consume(self, spec: PipelineSpec, queue_name: str) -> None:
        """Pop root tasks off the entry queue and launch runs. The message
        is completed as soon as the run is adopted in memory: the run is
        event-driven from there, and a control-plane restart re-seeds the
        (still non-terminal) root task back onto this queue — which is the
        resume path, deliberately identical to first launch."""
        while not self._stop.is_set():
            msg = await self.broker.receive(queue_name, timeout=1.0)
            if msg is None:
                continue
            try:
                await self._adopt(spec, msg)
            except asyncio.CancelledError:
                self.broker.abandon(msg)
                raise
            except Exception:  # noqa: BLE001 — the consumer loop must never die
                log.exception("pipeline %s: adopting task %s crashed; "
                              "redelivering", spec.name, msg.task_id)
                self.broker.abandon(msg)

    async def _adopt(self, spec: PipelineSpec, msg) -> None:
        root_id = msg.task_id
        if root_id in self._runs:
            self.broker.complete(msg)  # duplicate delivery of a live run
            return
        try:
            record = self.store.get(root_id)
        except TaskNotFound:
            self.broker.complete(msg)  # evicted (tight retention)
            return
        if record.canonical_status in TaskStatus.TERMINAL:
            self.broker.complete(msg)  # redelivery of a finished run
            return
        self.broker.complete(msg)
        if self.hub is not None:
            # Buffer the run's events even with no subscriber yet — a
            # client attaching after stage 1 completed must still see
            # its partial (the replay window).
            self.hub.track(root_id)
        run = _PipelineRun(self, spec, record)
        self._runs[root_id] = run
        run.task = asyncio.get_running_loop().create_task(run.drive())
        run.task.add_done_callback(lambda _t: self._runs.pop(root_id, None))

    # -- store feed ----------------------------------------------------------

    def _on_task_change(self, task) -> None:
        """Store listener (any thread): route stage sub-task terminal
        transitions to their run's event queue on the coordinator loop."""
        status = task.canonical_status
        if status not in TaskStatus.TERMINAL:
            return
        parsed = split_sub_task_id(task.task_id)
        if parsed is None:
            return
        root_id, stage = parsed
        run = self._runs.get(root_id)
        if run is None or self._loop is None:
            return
        try:
            self._loop.call_soon_threadsafe(run.note_stage_terminal, stage,
                                            status, task.status)
        except RuntimeError:
            pass  # loop closed mid-shutdown

    # -- shared helpers (used by runs) ---------------------------------------

    def stamp(self, task_id: str, event: str, reason: str) -> None:
        if self.observability is None:
            return
        self.observability.stamp(
            task_id, hop.ledger_event(event, "pipeline", reason=reason))

    def count_stage(self, spec: PipelineSpec, stage: str,
                    outcome: str) -> None:
        self._stages_total.inc(pipeline=spec.name, stage=stage,
                               outcome=outcome)

    def count_run(self, spec: PipelineSpec, outcome: str) -> None:
        self._runs_total.inc(pipeline=spec.name, outcome=outcome)

    def observe_ttfp(self, spec: PipelineSpec, seconds: float) -> None:
        self._ttfp.observe(seconds, pipeline=spec.name)


class _PipelineRun:
    """One root task's DAG execution (coordinator-loop only)."""

    def __init__(self, coord: PipelineCoordinator, spec: PipelineSpec,
                 record: APITask):
        self.coord = coord
        self.spec = spec
        self.root_id = record.task_id
        self.deadline_at = record.deadline_at
        self.priority = record.priority
        # Stage-cache participation: a cache-enabled gateway stamps a
        # CacheKey on every cacheable non-bypassed request — its absence
        # means the caller opted out (X-Cache-Bypass), and the documented
        # bypass contract ("no cache read, no store") must hold for the
        # run's STAGES too, not just the whole-request key.
        self.use_stage_cache = (coord.result_cache is not None
                                and bool(record.cache_key))
        self.states: dict[str, StageState] = initial_states(spec)
        self.events: asyncio.Queue = asyncio.Queue()
        self.task: asyncio.Task | None = None
        self.launched_at = time.time()
        self._first_partial_at = 0.0

    # -- event intake (called via call_soon_threadsafe) ----------------------

    def note_stage_terminal(self, stage: str, canonical: str,
                            prose: str) -> None:
        self.events.put_nowait(("stage", stage, canonical, prose))

    def cancel(self) -> None:
        if self.task is not None:
            self.task.cancel()

    # -- drive ---------------------------------------------------------------

    async def drive(self) -> None:
        try:
            await self._update_root(
                f"running - pipeline {self.spec.name}", TaskStatus.RUNNING)
            self._resume_completed_stages()
            await self._dispatch_ready()
            while not self._all_resolved():
                try:
                    kind, stage, canonical, prose = await asyncio.wait_for(
                        self.events.get(),
                        timeout=self.spec.rescan_interval)
                except asyncio.TimeoutError:
                    # Safety rescan: a listener wakeup lost across a shard
                    # failover must not wedge the run — re-read every
                    # in-flight stage's sub-record from the store.
                    self._rescan()
                    await self._dispatch_ready()
                    continue
                if kind == "stage":
                    await self._on_stage_terminal(stage, canonical, prose)
                    await self._dispatch_ready()
            await self._finish()
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — a run crash must fail the root loudly
            log.exception("pipeline %s run %s crashed", self.spec.name,
                          self.root_id)
            try:
                if not self._root_terminal():
                    await self._update_root(
                        f"failed - pipeline {self.spec.name} coordinator "
                        "error", TaskStatus.FAILED)
                    self.coord.count_run(self.spec, "failed")
            except Exception:  # noqa: BLE001
                log.exception("could not fail pipeline run %s", self.root_id)

    # -- stage scheduling ----------------------------------------------------

    def _resume_completed_stages(self) -> None:
        """A relaunched run (restart re-seed, redelivered root) adopts any
        stage whose result already landed under the root's stage key —
        completed work is never re-executed across a crash."""
        for name, st in self.states.items():
            if self.coord.store.get_result(self.root_id, stage=name) is not None:
                st.status = "completed"
                st.resumed = True
                st.finished_at = time.time()
                self.coord.count_stage(self.spec, name, "resumed")

    def _ready_stages(self) -> list[StageState]:
        out = []
        for name in self.spec.order:
            st = self.states[name]
            if st.status != "pending":
                continue
            deps = [self.states[d] for d in st.spec.after]
            if any(not d.terminal for d in deps):
                continue
            out.append(st)
        return out

    async def _dispatch_ready(self) -> None:
        """Offer every ready stage once per pass; cache-satisfied stages
        resolve synchronously, so the pass loops until no new stage became
        ready (a fully-cached re-run completes in ONE pass, no broker
        round trips at all). Brownout-delayed stages stay pending but are
        offered at most once per pass (their timer re-enters the loop)."""
        if self._root_terminal():
            return
        offered: set[str] = set()
        progressed = True
        while progressed and not self._root_terminal():
            progressed = False
            for st in self._ready_stages():
                if st.spec.name in offered:
                    continue
                offered.add(st.spec.name)
                if not await self._launch_stage(st):
                    return  # run reached a terminal outcome mid-dispatch
                progressed = True

    async def _launch_stage(self, st: StageState) -> bool:
        """Dispatch one ready stage (or satisfy it from cache/quorum
        bookkeeping). Returns False when the RUN terminated instead."""
        spec, name = self.spec, st.spec.name
        successes = [d for d in st.spec.after
                     if self.states[d].status == "completed"]
        if len(successes) < st.spec.required_successes():
            # Join barrier unsatisfiable: more branches failed than the
            # declared quorum tolerates.
            failed = [d for d in st.spec.after
                      if self.states[d].status != "completed"]
            st.status = "failed"
            st.detail = (f"quorum {st.spec.required_successes()}/"
                         f"{len(st.spec.after)} unsatisfied "
                         f"(failed branches: {', '.join(failed)})")
            st.finished_at = time.time()
            self.coord.count_stage(spec, name, "failed")
            self._publish_stage_event(st)
            await self._fail_run(f"stage {name}: {st.detail}")
            return False

        join = self._stage_input(st.spec, successes)

        # Stage-budget admission check at the transition: a stage whose
        # carved window (or the whole request) is already spent sheds HERE
        # — before any broker message exists: a dead stage sheds before
        # dispatch.
        deadline = stage_deadline(st.spec, self.deadline_at)
        now = time.time()
        if deadline and now >= deadline:
            st.status = "expired"
            st.detail = "stage budget spent before dispatch"
            st.finished_at = now
            self.coord.count_stage(spec, name, "expired")
            if self.coord.admission is not None:
                self.coord.admission.note_expired(
                    "pipeline", self._stage_priority(st.spec))
            self.coord.stamp(self.root_id, hop.EXPIRED,
                             f"stage {name} pre-dispatch")
            self._publish_stage_event(st)
            await self._expire_run(f"stage {name} budget spent")
            return False

        # Brownout per stage class (orchestration ladder via admission):
        # a degraded mode refusing this stage's class delays the dispatch
        # instead of burning backend capacity the ladder just shed — the
        # stage's own deadline bounds the wait.
        adm = self.coord.admission
        if adm is not None:
            brown = adm.brownout_refusal(self._stage_priority(st.spec))
            if brown is not None:
                retry_after, _mode = brown
                adm.note_shed("pipeline", self._stage_priority(st.spec))
                self.coord.count_stage(spec, name, "shed")
                self.coord.stamp(self.root_id, hop.SHED,
                                 f"stage {name} brownout")
                wait = min(max(0.05, retry_after),
                           max(0.05, (deadline - now)
                               if deadline else retry_after))
                self._arm_retry(name, wait)
                return True

        # Stage result cache (rescache/): family = the stage endpoint's
        # path (the same namespace a worker checkpoint reload already
        # invalidates), extra = the pipeline/stage qualifier so two
        # pipelines sharing a backend never share entries by accident.
        cache = (self.coord.result_cache
                 if st.spec.cacheable and self.use_stage_cache else None)
        key = ""
        if cache is not None:
            key = request_key(st.spec.endpoint_path, join.body,
                              join.content_type,
                              extra=f"pipeline={spec.name}/{name}")
            found = cache.get(key, count=False)
            if found is not None:
                payload, ctype = found
                st.status = "completed"
                st.cached = True
                st.finished_at = time.time()
                self._record_stage_result(name, payload, ctype)
                self.coord.count_stage(spec, name, "cached")
                self.coord.stamp(self.root_id, hop.STAGE,
                                 f"{name} cached")
                self._note_partial(st)
                self._publish_stage_event(st, result=(payload, ctype))
                return True
        st.cache_key = key  # remembered for the fill on completion

        sub_id = sub_task_id(self.root_id, name)
        try:
            existing = self.coord.store.get(sub_id)
        except TaskNotFound:
            existing = None
        if existing is not None:
            canonical = existing.canonical_status
            if canonical == TaskStatus.COMPLETED:
                # Resume: the stage finished before the crash but its
                # result never got copied onto the root — adopt it now.
                found = self.coord.store.get_result(sub_id)
                if found is not None:
                    st.status = "completed"
                    st.resumed = True
                    st.finished_at = time.time()
                    self._record_stage_result(name, found[0], found[1])
                    self.coord.count_stage(spec, name, "resumed")
                    self._note_partial(st)
                    self._publish_stage_event(st, result=found)
                    return True
                # Completed with no retrievable result (evicted sub-record
                # payload): fall through and re-dispatch.
            elif canonical not in TaskStatus.TERMINAL:
                # Resume: the sub-task (and its broker message, re-seeded
                # by the restart) is already in flight — just wait for it.
                st.status = "dispatched"
                st.dispatched_at = time.time()
                return True
            # failed/expired predecessor: re-dispatch below is the retry —
            # the same created-rewrite the redrive surface performs.
        self.coord.store.upsert(APITask(
            task_id=sub_id,
            endpoint=st.spec.endpoint,
            body=join.body,
            content_type=join.content_type,
            status=TaskStatus.CREATED,
            backend_status=TaskStatus.CREATED,
            publish=True,
            deadline_at=deadline,
            priority=self._stage_priority(st.spec),
        ))
        st.status = "dispatched"
        st.dispatched_at = time.time()
        self.coord.count_stage(spec, name, "dispatched")
        self.coord.stamp(self.root_id, hop.STAGE, f"{name} dispatched")
        self._publish_stage_event(st)
        return True

    def _arm_retry(self, stage: str, wait: float) -> None:
        """Re-offer a brownout-delayed stage to the scheduler after
        ``wait`` seconds (run-loop timer; the event re-enters the
        ordinary dispatch path, deadline re-checked there)."""
        loop = asyncio.get_running_loop()

        def fire() -> None:
            self.events.put_nowait(("stage", "", "", ""))  # wake + rescan

        loop.call_later(wait, fire)

    def _stage_priority(self, stage_spec) -> int:
        return (stage_spec.priority if stage_spec.priority is not None
                else self.priority)

    # -- stage completion ----------------------------------------------------

    async def _on_stage_terminal(self, stage: str, canonical: str,
                                 prose: str) -> None:
        if not stage:
            return  # timer wakeup (_arm_retry)
        st = self.states.get(stage)
        if st is None or st.status != "dispatched":
            return  # late duplicate of an already-resolved stage
        if canonical == TaskStatus.COMPLETED:
            sub_id = sub_task_id(self.root_id, stage)
            found = self.coord.store.get_result(sub_id)
            if found is not None:
                payload, ctype = found
                st.status = "completed"
                st.finished_at = time.time()
                self._record_stage_result(stage, payload, ctype)
                cache = (self.coord.result_cache
                         if st.spec.cacheable and self.use_stage_cache
                         else None)
                if cache is not None and st.cache_key:
                    cache.put(st.cache_key, payload, ctype)
                self.coord.count_stage(self.spec, stage, "completed")
                self.coord.stamp(self.root_id, hop.STAGE,
                                 f"{stage} completed")
                self._note_partial(st)
                self._publish_stage_event(st, result=(payload, ctype))
                return
            # Completed WITHOUT a retrievable result (worker stored
            # nothing, or eviction raced the completion): fabricating an
            # empty payload would feed downstream stages garbage and
            # "complete" the run with a hollow answer — treat the branch
            # as failed (quorum may still tolerate it) via the shared
            # failure path below.
            canonical = TaskStatus.FAILED
            prose = "completed without a retrievable result"
        st.status = ("expired" if canonical == TaskStatus.EXPIRED
                     else "failed")
        st.detail = prose
        st.finished_at = time.time()
        self.coord.count_stage(self.spec, stage, st.status)
        self.coord.stamp(self.root_id, hop.STAGE, f"{stage} {st.status}")
        self._publish_stage_event(st)
        if not self._failure_tolerated(stage):
            if st.status == "expired":
                await self._expire_run(f"stage {stage} deadline")
            else:
                await self._fail_run(f"stage {stage}: {prose}")

    def _failure_tolerated(self, stage: str) -> bool:
        """A failed branch is tolerable iff every downstream join can still
        reach its quorum — and the stage feeds at least one downstream
        (a failed sink always fails the run)."""
        downstream = self.spec.downstream_of(stage)
        if not downstream:
            return False
        for name in downstream:
            st = self.states[name]
            possible = sum(
                1 for d in st.spec.after
                if self.states[d].status in ("pending", "dispatched",
                                             "completed"))
            if possible < st.spec.required_successes():
                return False
        return True

    def _rescan(self) -> None:
        """Re-read in-flight stages' sub-records — the lost-wakeup net."""
        for name, st in self.states.items():
            if st.status != "dispatched":
                continue
            try:
                record = self.coord.store.get(
                    sub_task_id(self.root_id, name))
            except TaskNotFound:
                continue
            canonical = record.canonical_status
            if canonical in TaskStatus.TERMINAL:
                self.events.put_nowait(("stage", name, canonical,
                                        record.status))

    # -- run terminal outcomes ----------------------------------------------

    def _all_resolved(self) -> bool:
        if self._root_terminal():
            return True
        return all(st.terminal for st in self.states.values())

    async def _finish(self) -> None:
        if self._root_terminal():
            return  # already failed/expired mid-run
        failed = [n for n, st in self.states.items()
                  if st.status in ("failed", "expired")]
        sinks = self.spec.sinks()
        sink_ok = [n for n in sinks
                   if self.states[n].status == "completed"]
        if not sink_ok:
            await self._fail_run(
                f"no sink stage completed (failed: {', '.join(failed)})")
            return
        # Final result: a single sink's payload verbatim; multiple sinks
        # (or a sink quorum with failures) produce a join document.
        if len(sinks) == 1:
            found = self.coord.store.get_result(self.root_id,
                                                stage=sinks[0])
            if found is not None:
                self._set_root_result(found[0], found[1])
        else:
            doc = self._sink_document(sink_ok)
            self._set_root_result(
                json.dumps(doc, separators=(",", ":")).encode(),
                "application/json")
        stages_run = sum(1 for st in self.states.values()
                         if st.status == "completed" and not st.cached
                         and not st.resumed)
        cached = sum(1 for st in self.states.values() if st.cached)
        summary = (f"completed - pipeline {self.spec.name} "
                   f"({stages_run} executed, {cached} cached"
                   + (f", {len(failed)} tolerated" if failed else "") + ")")
        await self._update_root(summary, TaskStatus.COMPLETED)
        self.coord.count_run(self.spec, "completed")

    async def _fail_run(self, why: str) -> None:
        if self._root_terminal():
            return
        await self._update_root(
            f"failed - pipeline {self.spec.name}: {why}", TaskStatus.FAILED)
        self.coord.count_run(self.spec, "failed")

    async def _expire_run(self, why: str) -> None:
        if self._root_terminal():
            return
        await self._update_root(
            f"expired - pipeline {self.spec.name}: {why} (pipeline)",
            TaskStatus.EXPIRED)
        self.coord.count_run(self.spec, "expired")

    def _root_terminal(self) -> bool:
        try:
            record = self.coord.store.get(self.root_id)
        except TaskNotFound:
            return True  # evicted — nothing left to drive
        return record.canonical_status in TaskStatus.TERMINAL

    async def _update_root(self, status: str, backend_status: str) -> None:
        """Conditional root transition (AIL003): the reaper's
        running-timeout rescue or the entry-queue dead-letter handler can
        race a terminal outcome onto the root from another thread — so
        the write is the store's ATOMIC compare-and-transition, keyed on
        the only two live states a pipeline root occupies (``created``
        fresh/re-adopted, ``running`` mid-run). Both misses mean the root
        is already terminal (or evicted): this run's outcome is dropped,
        never clobbered over one the client may have read."""
        try:
            for expected in (TaskStatus.RUNNING, TaskStatus.CREATED):
                if self.coord.store.update_status_if(
                        self.root_id, expected, status,
                        backend_status) is not None:
                    return
        except TaskNotFound:
            pass  # evicted mid-run (tight retention)

    # -- results + events ----------------------------------------------------

    def _record_stage_result(self, stage: str, payload: bytes,
                             ctype: str) -> None:
        try:
            self.coord.store.set_result(self.root_id, payload,
                                        content_type=ctype, stage=stage)
        except TaskNotFound:
            pass  # root evicted; the run is about to notice

    def _set_root_result(self, payload: bytes, ctype: str) -> None:
        try:
            self.coord.store.set_result(self.root_id, payload,
                                        content_type=ctype)
        except TaskNotFound:
            pass

    def _note_partial(self, st: StageState) -> None:
        if self._first_partial_at:
            return
        self._first_partial_at = time.time()
        self.coord.observe_ttfp(self.spec,
                                self._first_partial_at - self.launched_at)

    def _publish_stage_event(self, st: StageState,
                             result: tuple[bytes, str] | None = None) -> None:
        hub = self.coord.hub
        if hub is None:
            return
        data: dict = {"pipeline": self.spec.name, "stage": st.spec.name,
                      "state": ("cached" if st.cached else st.status)}
        if st.detail:
            data["detail"] = st.detail
        if result is not None:
            payload, ctype = result
            data["resultAvailable"] = True
            data["contentType"] = ctype
            if len(payload) <= INLINE_RESULT_BYTES:
                if ctype == "application/json":
                    try:
                        data["result"] = json.loads(payload.decode("utf-8"))
                    except (ValueError, UnicodeDecodeError):
                        data["resultB64"] = base64.b64encode(
                            payload).decode("ascii")
                else:
                    data["resultB64"] = base64.b64encode(
                        payload).decode("ascii")
        hub.publish(self.root_id, STAGE, data)

    def _sink_document(self, sink_ok: list[str]) -> dict:
        """Final answer for a multi-sink DAG: one JSON document over the
        completed sinks (same encoding rules as the fan-in join doc)."""
        stages_doc: dict = {}
        for name in sink_ok:
            found = self.coord.store.get_result(self.root_id, stage=name)
            if found is None:
                continue
            payload, ctype = found
            if ctype == "application/json":
                try:
                    stages_doc[name] = json.loads(payload.decode("utf-8"))
                    continue
                except (ValueError, UnicodeDecodeError):
                    pass
            stages_doc[name] = {"b64": base64.b64encode(payload).decode(),
                                "contentType": ctype}
        return {"pipeline": self.spec.name, "stages": stages_doc}

    # -- stage input composition --------------------------------------------

    def _stage_input(self, stage_spec, successes: list[str]) -> JoinInput:
        store = self.coord.store
        if stage_spec.input == "original" or not stage_spec.after:
            body = store.get_original_body(self.root_id)
            try:
                record = store.get(self.root_id)
                ctype = record.content_type
            except TaskNotFound:
                ctype = "application/octet-stream"
            return JoinInput(body=body, content_type=ctype,
                             arrived=tuple(successes))
        if len(stage_spec.after) == 1:
            found = store.get_result(self.root_id, stage=stage_spec.after[0])
            if found is None:
                return JoinInput(arrived=(), missing=stage_spec.after)
            return JoinInput(body=found[0], content_type=found[1],
                             arrived=tuple(successes))
        # Fan-in: a JSON join document over every arrived branch. JSON
        # branch results inline; binary ones ride base64 so the document
        # is always valid JSON.
        stages_doc: dict = {}
        for dep in successes:
            found = store.get_result(self.root_id, stage=dep)
            if found is None:
                continue
            payload, ctype = found
            if ctype == "application/json":
                try:
                    stages_doc[dep] = json.loads(payload.decode("utf-8"))
                    continue
                except (ValueError, UnicodeDecodeError):
                    pass
            stages_doc[dep] = {"b64": base64.b64encode(payload).decode(),
                               "contentType": ctype}
        missing = tuple(d for d in stage_spec.after if d not in successes)
        doc = {"pipeline": self.spec.name, "stages": stages_doc,
               "arrived": sorted(stages_doc), "missing": list(missing)}
        return JoinInput(
            body=json.dumps(doc, separators=(",", ":")).encode(),
            content_type="application/json",
            arrived=tuple(successes), missing=missing)
