"""Declared pipeline DAGs — the spec the coordinator executes.
(A copy of ``ai4e_tpu/pipeline/spec.py``.)

The platform's composition story so far is *emergent*: a stage finishes,
rewrites the task to ``created`` with the next endpoint, and republishes
(``service/task_manager.add_pipeline_task`` — the reference's
``distributed_api_task.py:67-100`` ensembles). That shape cannot express
fan-out, cannot carve a per-stage budget from the request's deadline, and
gives the platform no plan to resume from. A ``PipelineSpec`` is the same
composition *declared*: named stages, explicit edges, fan-in joins with a
failure-tolerance quorum, and per-stage deadline fractions — validated once
at registration, executed by ``coordinator.PipelineCoordinator`` under ONE
client-visible TaskId (docs/pipelines.md).

Stage sub-task naming: each stage of a run executes as a store sub-record
``{root_task_id}~{stage_name}`` — ``~`` never appears in platform-minted
GUIDs and stage names exclude it by validation, so the root id is always
recoverable with one ``rpartition``.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass

# SUB_TASK_SEP re-exported from the task module — it lives beside the
# ':' result-stage separator it complements, and the HTTP store surface
# enforces it (forged sub-record creates are refused there): '~' is
# valid in URLs, absent from GUIDs, and excluded from stage names below.
from ..taskstore.task import SUB_TASK_SEP, endpoint_path

_STAGE_NAME_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")


def sub_task_id(root_task_id: str, stage: str) -> str:
    return f"{root_task_id}{SUB_TASK_SEP}{stage}"


def split_sub_task_id(task_id: str) -> tuple[str, str] | None:
    """``(root, stage)`` when ``task_id`` is a stage sub-task id, else None."""
    root, sep, stage = task_id.rpartition(SUB_TASK_SEP)
    if not sep or not root or not stage:
        return None
    return root, stage


class PipelineSpecError(ValueError):
    """The spec is not a well-formed DAG (raised at registration, never at
    request time — a bad spec must fail the deployment, not a task)."""


@dataclass(frozen=True)
class StageSpec:
    """One node of the DAG.

    - ``name``: stage id (``[A-Za-z0-9_-]``; also the store's result-stage
      key under the root TaskId, and the hop-ledger/metric label);
    - ``endpoint``: the backend URI (or bare path) the stage's sub-task is
      dispatched to — a route the platform has a dispatcher for
      (``register_internal_route`` or a published API);
    - ``after``: upstream stage names (empty = an entry stage fed by the
      client's original body);
    - ``deadline_fraction``: share of the request's REMAINING deadline
      budget this stage may spend, carved at dispatch time from the
      ``X-Deadline-Ms`` the admission layer anchored (0 = no carve — the
      stage inherits the root deadline whole);
    - ``quorum``: fan-in tolerance — minimum number of upstream stages
      that must SUCCEED for this stage to run (0 = all of ``after``);
      failed branches below the quorum bar are recorded in the join
      input, not fatal;
    - ``input``: what the stage's sub-task body carries — ``"auto"``
      (original body for entry stages; the single upstream's result; a
      JSON join document for fan-in) or ``"original"`` (always replay the
      client's original body, the reference's ensemble semantics);
    - ``priority``: admission class override for this stage's sub-task
      (None = inherit the request's class) — the degradation ladder's
      brownout applies per stage class;
    - ``cacheable``: whether the stage participates in the stage result
      cache (``rescache/`` — key = stage endpoint family + canonical
      stage input hash, so a re-run or resumed pipeline skips completed
      stages).
    """

    name: str
    endpoint: str
    after: tuple[str, ...] = ()
    deadline_fraction: float = 0.0
    quorum: int = 0
    input: str = "auto"
    priority: int | None = None
    cacheable: bool = True

    def __post_init__(self):
        # dataclass(frozen) + normalization: tolerate lists in user specs.
        object.__setattr__(self, "after", tuple(self.after))

    @property
    def endpoint_path(self) -> str:
        return endpoint_path(self.endpoint)

    def required_successes(self) -> int:
        """Upstream successes this stage needs before it may run."""
        if not self.after:
            return 0
        return self.quorum if self.quorum > 0 else len(self.after)


@dataclass(frozen=True)
class PipelineSpec:
    """A validated DAG of stages published as one async API.

    ``prefix`` is the public gateway route clients POST; ``stages`` the
    nodes. Validation (at construction) guarantees: unique well-formed
    stage names, known edges, acyclicity, sane quorums, and that no
    root→sink path's deadline fractions exceed 1.0 — so budget carving
    can never promise a stage time the request does not have.
    """

    name: str
    prefix: str
    stages: tuple[StageSpec, ...] = ()
    # Maximum seconds a run may sit waiting on sub-task events before the
    # coordinator re-reads their records from the store — the safety net
    # against a lost listener wakeup (never the primary signal).
    rescan_interval: float = 15.0

    def __post_init__(self):
        object.__setattr__(self, "stages", tuple(self.stages))
        if not _STAGE_NAME_RE.match(self.name or ""):
            raise PipelineSpecError(
                f"pipeline name {self.name!r} must match "
                f"{_STAGE_NAME_RE.pattern}")
        if not self.stages:
            raise PipelineSpecError(f"pipeline {self.name!r} has no stages")
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise PipelineSpecError(
                f"pipeline {self.name!r}: duplicate stage name(s) {dupes}")
        by_name = {s.name: s for s in self.stages}
        for s in self.stages:
            if not _STAGE_NAME_RE.match(s.name):
                raise PipelineSpecError(
                    f"stage name {s.name!r} must match "
                    f"{_STAGE_NAME_RE.pattern} (it is a result-stage key "
                    f"and a sub-task id component)")
            if not s.endpoint:
                raise PipelineSpecError(f"stage {s.name!r} has no endpoint")
            for dep in s.after:
                if dep not in by_name:
                    raise PipelineSpecError(
                        f"stage {s.name!r} depends on unknown stage {dep!r}")
                if dep == s.name:
                    raise PipelineSpecError(
                        f"stage {s.name!r} depends on itself")
            if s.quorum < 0 or s.quorum > len(s.after):
                raise PipelineSpecError(
                    f"stage {s.name!r}: quorum {s.quorum} out of range for "
                    f"{len(s.after)} upstream stage(s)")
            if not 0.0 <= s.deadline_fraction <= 1.0:
                raise PipelineSpecError(
                    f"stage {s.name!r}: deadline_fraction "
                    f"{s.deadline_fraction} outside [0, 1]")
            if s.input not in ("auto", "original"):
                raise PipelineSpecError(
                    f"stage {s.name!r}: input must be 'auto' or 'original', "
                    f"got {s.input!r}")
        order = self._topo_order(by_name)
        object.__setattr__(self, "_order", order)
        # Budget sanity: along every path the carved fractions must fit in
        # one request budget. path_sum(s) = fraction(s) + max over deps.
        path_sum: dict[str, float] = {}
        for name in order:
            s = by_name[name]
            upstream = max((path_sum[d] for d in s.after), default=0.0)
            path_sum[name] = upstream + s.deadline_fraction
            if path_sum[name] > 1.0 + 1e-9:
                raise PipelineSpecError(
                    f"stage {s.name!r}: cumulative deadline fractions along "
                    f"its path reach {path_sum[name]:.3f} > 1.0 — the DAG "
                    f"would promise stages more budget than the request has")

    def _topo_order(self, by_name: dict[str, StageSpec]) -> tuple[str, ...]:
        """Deterministic topological order; raises on cycles."""
        state: dict[str, int] = {}  # 0 visiting / 1 done
        order: list[str] = []

        def visit(name: str, trail: tuple[str, ...]) -> None:
            mark = state.get(name)
            if mark == 1:
                return
            if mark == 0:
                cycle = " -> ".join((*trail[trail.index(name):], name))
                raise PipelineSpecError(
                    f"pipeline {self.name!r} has a cycle: {cycle}")
            state[name] = 0
            for dep in by_name[name].after:
                visit(dep, (*trail, name))
            state[name] = 1
            order.append(name)

        for s in self.stages:
            visit(s.name, ())
        return tuple(order)

    # -- derived views -------------------------------------------------------

    @property
    def order(self) -> tuple[str, ...]:
        """Stage names in topological order (dependencies first)."""
        return self._order  # set in __post_init__

    def stage(self, name: str) -> StageSpec:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(name)

    def downstream_of(self, name: str) -> tuple[str, ...]:
        return tuple(s.name for s in self.stages if name in s.after)

    def sinks(self) -> tuple[str, ...]:
        """Stages nothing depends on — their results form the final answer
        (a single sink's result verbatim; a JSON join document otherwise)."""
        have_downstream = {d for s in self.stages for d in s.after}
        return tuple(s.name for s in self.stages
                     if s.name not in have_downstream)

    @property
    def entry_path(self) -> str:
        """The internal endpoint path root tasks are published under — the
        coordinator's queue. Distinct namespace from any backend route so a
        root task can never be mistaken for dispatchable stage work."""
        return f"/v1/_pipelines/{self.name}"


def stage_deadline(stage: StageSpec, root_deadline_at: float,
                   now: float | None = None) -> float:
    """The absolute deadline a stage's sub-task carries: its declared
    fraction of the request's REMAINING budget, carved at dispatch time —
    never later than the root deadline (transport time already spent can
    only shrink a stage's window, exactly like every other hop's deadline
    propagation, ``admission/deadline.py``). 0.0 (no deadline) when the
    request carried none."""
    if not root_deadline_at:
        return 0.0
    if not stage.deadline_fraction:
        return root_deadline_at
    now = time.time() if now is None else now
    remaining = root_deadline_at - now
    if remaining <= 0:
        return root_deadline_at
    return min(root_deadline_at, now + remaining * stage.deadline_fraction)


@dataclass
class StageState:
    """Mutable per-run bookkeeping for one stage (coordinator-internal)."""

    spec: StageSpec
    status: str = "pending"   # pending|dispatched|completed|failed|expired
    cached: bool = False      # satisfied by the stage result cache
    resumed: bool = False     # satisfied by a pre-existing stage result
    dispatched_at: float = 0.0
    finished_at: float = 0.0
    detail: str = ""          # failure/shed prose for events + final status
    cache_key: str = ""       # stage-cache key captured at dispatch

    @property
    def terminal(self) -> bool:
        return self.status in ("completed", "failed", "expired")


def initial_states(spec: PipelineSpec) -> dict[str, StageState]:
    return {s.name: StageState(spec=s) for s in spec.stages}


@dataclass
class JoinInput:
    """Composed input for a stage with upstream dependencies."""

    body: bytes = b""
    content_type: str = "application/json"
    # Which upstream results fed the body (successes) / were tolerated
    # (failures below the quorum bar) — surfaced in events and the join doc.
    arrived: tuple[str, ...] = ()
    missing: tuple[str, ...] = ()
