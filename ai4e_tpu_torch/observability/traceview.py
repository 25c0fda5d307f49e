"""Terminal trace viewer over the JSONL span log; a copy of
``ai4e_tpu/observability/traceview.py``.

``python -m ai4e_tpu_torch trace --task-id …`` renders a task's span tree
across services from the ``AI4E_OBSERVABILITY_TRACE_EXPORT_PATH`` log.
Spans are the ``tracing.Span.to_dict`` records: one JSON object per
line, ``trace_id``/``span_id``/``parent_id`` linkage, ``task_id``
correlation, epoch ``start`` + ``duration`` seconds. The viewer reads a
live log: truncated or garbage lines are skipped, and orphan spans
(parent not exported yet, or sampled out) render as roots.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field


def load_spans(path: str) -> list[dict]:
    """Read a JSONL span log, skipping non-JSON / non-object lines (the
    file may be mid-write by a live service)."""
    spans = []
    with open(path, encoding="utf-8", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if (isinstance(rec, dict) and rec.get("trace_id")
                    and rec.get("span_id")):
                spans.append(rec)
    return spans


def select_traces(spans: list[dict], task_id: str | None = None,
                  trace_id: str | None = None) -> list[dict]:
    """Spans of the selected trace(s). ``task_id`` selects every trace any
    matching span belongs to (a pipeline task traverses several services
    under one trace; a redriven task may own several traces) and returns
    ALL spans of those traces — including infrastructure spans that don't
    carry the task_id themselves."""
    if trace_id:
        ids = {trace_id}
    elif task_id:
        ids = {s["trace_id"] for s in spans if s.get("task_id") == task_id}
    else:
        ids = {s["trace_id"] for s in spans}
    return [s for s in spans if s["trace_id"] in ids]


@dataclass
class _Node:
    span: dict
    children: list = field(default_factory=list)


def _ms(seconds: float) -> str:
    return f"{seconds * 1000.0:.1f}ms"


def _trees(spans: list[dict]) -> list[_Node]:
    """Parent-linked forest, roots and siblings in start order. A span
    whose parent is absent (not exported, sampled out) roots its subtree."""
    nodes = {s["span_id"]: _Node(s) for s in spans}
    roots = []
    for node in nodes.values():
        parent = nodes.get(node.span.get("parent_id") or "")
        if parent is not None and parent is not node:
            parent.children.append(node)
        else:
            roots.append(node)
    for node in nodes.values():
        node.children.sort(key=lambda n: n.span.get("start", 0.0))
    roots.sort(key=lambda n: n.span.get("start", 0.0))
    return roots


def _render_node(node: _Node, t0: float, prefix: str, last: bool,
                 out: list[str]) -> None:
    s = node.span
    connector = "└─ " if last else "├─ "
    line = (f"{prefix}{connector}{s.get('name', '?')} "
            f"[{s.get('service', '?')}]  "
            f"+{_ms(s.get('start', t0) - t0)} {_ms(s.get('duration', 0.0))}")
    if s.get("status") == "error":
        line += f"  ERROR: {s.get('error', '')}"
    attrs = s.get("attrs") or {}
    if attrs:
        line += "  " + " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
    out.append(line)
    child_prefix = prefix + ("   " if last else "│  ")
    for i, child in enumerate(node.children):
        _render_node(child, t0, child_prefix, i == len(node.children) - 1,
                     out)


def render_trace(spans: list[dict]) -> str:
    """One trace per block: header (trace id, span count, wall span, task),
    then the indented tree with per-span offset/duration/status."""
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    blocks = []
    for tid, trace_spans in sorted(
            by_trace.items(),
            key=lambda kv: min(s.get("start", 0.0) for s in kv[1])):
        t0 = min(s.get("start", 0.0) for s in trace_spans)
        t1 = max(s.get("start", 0.0) + s.get("duration", 0.0)
                 for s in trace_spans)
        tasks = sorted({s["task_id"] for s in trace_spans
                        if s.get("task_id")})
        errors = sum(1 for s in trace_spans if s.get("status") == "error")
        header = (f"trace {tid}  {len(trace_spans)} spans  {_ms(t1 - t0)}"
                  + (f"  task {', '.join(tasks)}" if tasks else "")
                  + (f"  {errors} ERROR" if errors else ""))
        out = [header]
        roots = _trees(trace_spans)
        for i, root in enumerate(roots):
            _render_node(root, t0, "", i == len(roots) - 1, out)
        blocks.append("\n".join(out))
    return "\n\n".join(blocks)


def render_list(spans: list[dict], limit: int = 20) -> str:
    """Most-recent-first trace summary — the transaction-search results
    list: trace id, root span name, span count, wall time, task, errors."""
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    rows = []
    for tid, trace_spans in by_trace.items():
        t0 = min(s.get("start", 0.0) for s in trace_spans)
        t1 = max(s.get("start", 0.0) + s.get("duration", 0.0)
                 for s in trace_spans)
        # Root = the parentless span (clock skew across services can give
        # a CHILD the earliest wall-clock start); _trees applies the same
        # rule and falls back to start order for orphans.
        root = _trees(trace_spans)[0].span
        tasks = sorted({s["task_id"] for s in trace_spans
                        if s.get("task_id")})
        errors = sum(1 for s in trace_spans if s.get("status") == "error")
        rows.append((t0, f"{tid}  {root.get('name', '?')} "
                         f"[{root.get('service', '?')}]  "
                         f"{len(trace_spans)} spans  {_ms(t1 - t0)}"
                         + (f"  task {tasks[0]}" if tasks else "")
                         + (f"  {errors} ERROR" if errors else "")))
    rows.sort(key=lambda r: r[0], reverse=True)
    return "\n".join(r[1] for r in rows[:limit])
