"""The closed-loop and open-loop load clients; a copy of
``ai4e_tpu/utils/loadclient.py``.

Closed loop: N clients each keep one request in flight against an async
task route (POST, then long-poll ``/task/{id}``, or follow its event
stream) or a sync route, with an untimed ramp before the measured window.
Open loop: request starts scheduled by the clock at an offered rate.

A non-503 error response, an undecodable body, a vanished task (404) or a
transport error counts as one failed request, by kind, and the run goes
on.
"""

from __future__ import annotations

import asyncio
import json
import time


def _latency_percentiles(window_lat: list[float]) -> dict:
    """p50/p95/p99 (ms) over a sorted window-latency list — ONE convention
    shared by the closed and open loops so their reported numbers stay
    comparable."""
    def pctl(q: float) -> float:
        return round(
            window_lat[max(0, int(len(window_lat) * q) - 1)] * 1000, 1)
    return {
        "p50_latency_ms": round(window_lat[len(window_lat) // 2] * 1000, 1),
        "p95_latency_ms": pctl(0.95),
        "p99_latency_ms": pctl(0.99),
    }


def _window_error_delta(close: dict, mark: dict) -> dict:
    """Per-kind client-error counts inside the measured window (close
    snapshot minus mark snapshot, zero-delta kinds dropped)."""
    return {k: close["errors"].get(k, 0) - mark["errors"].get(k, 0)
            for k in close["errors"]
            if close["errors"].get(k, 0) - mark["errors"].get(k, 0) > 0}


def _backoff(resp) -> float:
    """Sleep for a backpressure response: Retry-After when the server sent
    one (capped at 2 s — a closed-loop client that idles longer just
    under-measures), else a short yield."""
    retry_after = resp.headers.get("Retry-After")
    try:
        return min(float(retry_after), 2.0) if retry_after else 0.05
    except ValueError:
        return 0.05


async def run_closed_loop(
    session,
    *,
    post_url: str,
    payload: bytes,
    headers: dict,
    mode: str = "async",
    status_url_for=None,
    concurrency: int = 64,
    duration: float = 20.0,
    ramp: float = 5.0,
    task_timeout: float = 120.0,
    poll_wait: float = 30.0,
    post_url_for=None,
    headers_for=None,
    deadline_s: float | None = None,
    events_url_for=None,
    tenant_names: dict | None = None,
) -> dict:
    """Drive ``post_url`` closed-loop; returns window stats.

    ``status_url_for(task_id) -> url`` is required in async mode.
    ``post_url_for() -> url`` (optional) picks the POST target per request —
    the bench's duplicate-request mix rides this (identical requests POST
    the bare route, unique ones carry a never-repeating query param).
    ``headers_for() -> dict`` (optional) adds per-request headers on top of
    ``headers`` — the bench's deadline/priority mix rides this
    (admission control).
    ``deadline_s`` (optional): the per-request latency budget the traffic
    carries; completions are additionally bucketed into goodput (finished
    within the budget) vs ``late``, and tasks the platform shed on their
    deadline (terminal ``expired`` status / 504) count as ``expired``,
    not failed.
    ``tenant_names`` (optional): subscription key → tenant name. When
    set, every outcome is additionally bucketed by the tenant whose key
    the request carried (``Ocp-Apim-Subscription-Key``, set via
    ``headers``/``headers_for``) and the window JSON gains a
    ``by_tenant`` block — completions, goodput, and the tenant-quota
    429s (``quota_shed``) the gateway's per-tenant bucket refused
    (docs/tenancy.md). Keys absent from the map bucket under ``""``.
    ``events_url_for(task_id) -> url`` (optional, async mode): follow the
    task's SSE event stream (``GET /task/{id}/events``, pipeline
    platforms — docs/pipelines.md) instead of long-polling, recording
    **time-to-first-partial** — POST to the first stage partial (a
    ``stage`` event reaching completed/cached, or any ``chunk``) — and
    scoring the terminal event; the window JSON then carries
    ``time_to_first_partial_ms_p50``/``_p95`` and ``first_partials``. A
    failed/closed stream falls back to the ordinary status poll.
    Returns ``{"value", "p50_latency_ms", "p95_latency_ms", "completed",
    "failed", "expired", "duration_s", ...}`` where value is
    completions/second inside the measurement window that opens after
    ``ramp`` seconds; with ``deadline_s`` set the dict gains
    ``goodput`` (within-deadline completions/second) and ``late``.
    """
    import aiohttp

    if mode == "async" and status_url_for is None:
        raise ValueError("async mode needs status_url_for")

    latencies: list[float] = []
    ttfps: list[float] = []  # time-to-first-partial samples (events mode)
    completed = 0
    failed = 0
    expired = 0
    good = 0  # completions within deadline_s (== completed when unset)
    # Load-generator honesty: every POST the client actually attempted
    # (backpressure re-entries included) and a client-side error taxonomy,
    # so the window JSON records OFFERED vs ACHIEVED rate — a CPU-bound
    # run cannot silently report a lower rate as if it were the target.
    offered = 0
    errors: dict[str, int] = {}

    def _err(kind: str) -> None:
        errors[kind] = errors.get(kind, 0) + 1
    # Per-priority-class accounting, keyed by the X-Priority header each
    # request carried ("" = unlabeled). Only populated when headers_for
    # labels traffic — the bench's --mix profiles report per-class
    # goodput and deadline-miss rate off these buckets.
    by_class: dict[str, dict] = {}

    def _bucket(cls: str) -> dict:
        b = by_class.get(cls)
        if b is None:
            b = by_class[cls] = {"completed": 0, "good": 0, "failed": 0,
                                 "expired": 0}
        return b
    # Per-tenant accounting (docs/tenancy.md), keyed by the tenant whose
    # subscription key each request carried — only populated when the
    # caller supplies the key → name map.
    by_tenant: dict[str, dict] = {}

    def _tbucket(name: str) -> dict:
        b = by_tenant.get(name)
        if b is None:
            b = by_tenant[name] = {"offered": 0, "completed": 0, "good": 0,
                                   "failed": 0, "expired": 0,
                                   "quota_shed": 0}
        return b

    def _tenant_of(hdrs: dict) -> str | None:
        if tenant_names is None:
            return None
        return tenant_names.get(
            hdrs.get("Ocp-Apim-Subscription-Key", ""), "")

    def _headers() -> dict:
        if headers_for is None:
            return headers
        return {**headers, **headers_for()}

    def _score_completion(elapsed: float, cls: str, tname=None) -> None:
        nonlocal completed, good
        latencies.append(elapsed)
        completed += 1
        _bucket(cls)["completed"] += 1
        in_deadline = deadline_s is None or elapsed <= deadline_s
        if in_deadline:
            good += 1
            _bucket(cls)["good"] += 1
        if tname is not None:
            _tbucket(tname)["completed"] += 1
            if in_deadline:
                _tbucket(tname)["good"] += 1

    def _score_failed(cls: str, tname=None) -> None:
        nonlocal failed
        failed += 1
        _bucket(cls)["failed"] += 1
        if tname is not None:
            _tbucket(tname)["failed"] += 1

    def _score_expired(cls: str, tname=None) -> None:
        nonlocal expired
        expired += 1
        _bucket(cls)["expired"] += 1
        if tname is not None:
            _tbucket(tname)["expired"] += 1

    def _score_backpressure(resp, tname=None) -> None:
        # A tenant-quota 429 is the tenant's OWN contract (shed, carries
        # Retry-After) — bucket it to the tenant so the noisy-neighbor
        # A/B can show who paid; other 429/503s are platform pressure.
        reason = resp.headers.get("X-Shed-Reason", "")
        if "tenant-quota" in reason:
            _err("tenant_quota_429")
            if tname is not None:
                _tbucket(tname)["quota_shed"] += 1
        else:
            _err(f"backpressure_{resp.status}")

    def _score_terminal(status: str, elapsed: float, cls: str,
                        tname=None) -> None:
        # "failed" FIRST — the platform's canonical bucketing
        # (TaskStatus.canonical) tests it first.
        if "failed" in status:
            _score_failed(cls, tname)
        elif "completed" in status:
            _score_completion(elapsed, cls, tname)
        elif "expired" in status:
            _score_expired(cls, tname)
        else:
            _score_failed(cls, tname)  # stream ended on a non-terminal status

    async def _follow_events(task_id: str, t0: float, cls: str,
                             deadline: float, tname=None) -> bool:
        """Consume the task's SSE stream: record the first partial, score
        the terminal event. True when the request was scored; False →
        the caller falls back to status polling."""
        saw_partial = False
        try:
            budget = max(1.0, deadline - time.perf_counter())
            async with session.get(
                    events_url_for(task_id),
                    params={"wait": str(round(budget, 1))},
                    headers=headers) as resp:
                if resp.status != 200:
                    return False
                current: dict = {}
                async for raw in resp.content:
                    if time.perf_counter() > deadline:
                        # stuck task: don't hang the run
                        _score_failed(cls, tname)
                        return True
                    line = raw.decode("utf-8").rstrip("\r\n")
                    if line.startswith(":"):
                        continue  # keep-alive
                    if line:
                        if line.startswith("event: "):
                            current["event"] = line[len("event: "):]
                        elif line.startswith("data: "):
                            try:
                                current["data"] = json.loads(
                                    line[len("data: "):])
                            except ValueError:
                                pass
                        continue
                    etype = current.get("event")
                    data = current.get("data") or {}
                    current = {}
                    if etype in ("stage", "chunk") and not saw_partial:
                        state = data.get("state", "")
                        if etype == "chunk" or state in ("completed",
                                                         "cached"):
                            saw_partial = True
                            ttfps.append(time.perf_counter() - t0)
                    elif etype == "terminal":
                        _score_terminal(data.get("Status", ""),
                                        time.perf_counter() - t0, cls,
                                        tname)
                        return True
        except (aiohttp.ClientError, asyncio.TimeoutError):
            return False
        return False  # stream closed without a terminal event

    async def one_async() -> None:
        nonlocal offered
        t0 = time.perf_counter()
        url = post_url if post_url_for is None else post_url_for()
        hdrs = _headers()
        cls = hdrs.get("X-Priority", "")
        tname = _tenant_of(hdrs)
        offered += 1
        if tname is not None:
            _tbucket(tname)["offered"] += 1
        try:
            async with session.post(url, data=payload,
                                    headers=hdrs) as resp:
                if resp.status in (503, 429):
                    # Backpressure (admission 503 / per-key throttle 429 /
                    # tenant quota 429): not a failure — yield briefly and
                    # re-enter. The client honors Retry-After when present,
                    # capped so one long hint can't idle the closed loop
                    # past the window.
                    _score_backpressure(resp, tname)
                    await asyncio.sleep(_backoff(resp))
                    return
                if resp.status == 504:  # shed: budget spent at the edge
                    _err("shed_504")
                    _score_expired(cls, tname)
                    return
                if resp.status >= 400:
                    _err(f"http_{resp.status}")
                    _score_failed(cls, tname)
                    return
                task = await resp.json()
            task_id = task["TaskId"]
        except asyncio.TimeoutError:
            _err("timeout")
            _score_failed(cls, tname)
            return
        except aiohttp.ClientError as exc:
            _err("connect_error"
                 if isinstance(exc, aiohttp.ClientConnectorError)
                 else "transport_error")
            _score_failed(cls, tname)
            return
        except (ValueError, KeyError, TypeError):
            _err("bad_response")
            _score_failed(cls, tname)
            return
        deadline = t0 + task_timeout
        if events_url_for is not None:
            if await _follow_events(task_id, t0, cls, deadline, tname):
                return
            # Stream unavailable/interrupted: poll like everyone else.
        while True:
            try:
                async with session.get(status_url_for(task_id),
                                       params={"wait": str(int(poll_wait))},
                                       headers=headers) as resp:
                    if resp.status == 404:  # reaped/evicted task
                        _err("task_poll_404")
                        _score_failed(cls, tname)
                        return
                    record = await resp.json()
                status = record["Status"]
            except (aiohttp.ClientError, asyncio.TimeoutError, ValueError,
                    KeyError, TypeError):
                _err("poll_transport")
                _score_failed(cls, tname)
                return
            # "failed" FIRST — the platform's canonical bucketing
            # (TaskStatus.canonical) tests it first, so a status carrying
            # both words counts the same here as in the store's sets.
            if "failed" in status:
                _score_failed(cls, tname)
                return
            if "completed" in status:
                _score_completion(time.perf_counter() - t0, cls, tname)
                return
            if "expired" in status:
                # Admission shed the task on its deadline (terminal) —
                # shed work, not a platform failure.
                _score_expired(cls, tname)
                return
            if time.perf_counter() > deadline:  # stuck task: don't hang the run
                _err("stuck_timeout")
                _score_failed(cls, tname)
                return

    async def one_sync() -> None:
        # 503 backpressure: sleep briefly and return (neither completed nor
        # failed) — client_loop re-enters until the run deadline, same as
        # one_async, so sustained backpressure can never outlive the run.
        nonlocal offered
        t0 = time.perf_counter()
        url = post_url if post_url_for is None else post_url_for()
        hdrs = _headers()
        cls = hdrs.get("X-Priority", "")
        tname = _tenant_of(hdrs)
        offered += 1
        if tname is not None:
            _tbucket(tname)["offered"] += 1
        try:
            async with session.post(url, data=payload,
                                    headers=hdrs) as resp:
                if resp.status in (503, 429):
                    _score_backpressure(resp, tname)
                    await asyncio.sleep(_backoff(resp))
                    return
                if resp.status == 504:  # admission shed on deadline
                    _err("shed_504")
                    _score_expired(cls, tname)
                    return
                await resp.read()
                ok = resp.status == 200
                if not ok:
                    _err(f"http_{resp.status}")
        except asyncio.TimeoutError:
            _err("timeout")
            ok = False
        except aiohttp.ClientError as exc:
            _err("connect_error"
                 if isinstance(exc, aiohttp.ClientConnectorError)
                 else "transport_error")
            ok = False
        if ok:
            _score_completion(time.perf_counter() - t0, cls, tname)
        else:
            _score_failed(cls, tname)

    one = one_sync if mode == "sync" else one_async

    async def client_loop(stop_at: float) -> None:
        while time.perf_counter() < stop_at:
            await one()

    # Ramp: run load untimed until the pipeline is in steady state (cold
    # start — empty queues, small batches, cache touches — would otherwise
    # land inside the measured window). In-flight work at the open and
    # close of the window cancels to first order.
    mark: dict = {}
    close: dict = {}

    def _class_snapshot() -> dict:
        return {cls: dict(b) for cls, b in by_class.items()}

    def _tenant_snapshot() -> dict:
        return {name: dict(b) for name, b in by_tenant.items()}

    async def open_window() -> None:
        await asyncio.sleep(ramp)
        mark.update(t=time.perf_counter(), completed=completed,
                    failed=failed, expired=expired, good=good,
                    offered=offered, errors=dict(errors),
                    n_lat=len(latencies), n_ttfp=len(ttfps),
                    by_class=_class_snapshot(),
                    by_tenant=_tenant_snapshot())

    async def close_window() -> None:
        # Snapshot AT stop_at, not after the drain: gather() returns only
        # once every in-flight request resolves, and a single stuck task
        # would stretch the denominator by up to task_timeout with no
        # completions — deflating throughput several-fold.
        await asyncio.sleep(ramp + duration)
        close.update(t=time.perf_counter(), completed=completed,
                     failed=failed, expired=expired, good=good,
                     offered=offered, errors=dict(errors),
                     n_lat=len(latencies), n_ttfp=len(ttfps),
                     by_class=_class_snapshot(),
                     by_tenant=_tenant_snapshot())

    stop_at = time.perf_counter() + ramp + duration
    await asyncio.gather(open_window(), close_window(),
                         *[client_loop(stop_at) for _ in range(concurrency)])
    elapsed = close["t"] - mark["t"]

    window_lat = sorted(latencies[mark["n_lat"]:close["n_lat"]]) or [0.0]
    n = close["completed"] - mark["completed"]

    n_offered = close["offered"] - mark["offered"]
    window_errors = _window_error_delta(close, mark)
    out = {
        "value": round(n / elapsed, 2),
        **_latency_percentiles(window_lat),
        "completed": n,
        "failed": close["failed"] - mark["failed"],
        "expired": close["expired"] - mark["expired"],
        "duration_s": round(elapsed, 1),
        # Honesty block: what the client actually ATTEMPTED vs
        # what completed, plus the client-side error taxonomy — a
        # CPU-bound run reports its shortfall instead of silently
        # presenting the achieved rate as the target.
        "offered": n_offered,
        "offered_rate": round(n_offered / elapsed, 2),
        "achieved_rate": round(n / elapsed, 2),
        "client_errors": window_errors,
    }
    if events_url_for is not None:
        # Time-to-first-partial (docs/pipelines.md): POST → first stage
        # partial on the event stream, window-sliced like the latencies.
        window_ttfp = sorted(ttfps[mark["n_ttfp"]:close["n_ttfp"]])
        out["first_partials"] = len(window_ttfp)
        if window_ttfp:
            def tp(q: float) -> float:
                idx = max(0, int(len(window_ttfp) * q) - 1)
                return round(window_ttfp[idx] * 1000, 1)
            out["time_to_first_partial_ms_p50"] = round(
                window_ttfp[len(window_ttfp) // 2] * 1000, 1)
            out["time_to_first_partial_ms_p95"] = tp(0.95)
    if deadline_s is not None:
        n_good = close["good"] - mark["good"]
        # Goodput — THE saturation metric (PAPERS.md): completions that
        # landed inside the caller's budget, per second of the window.
        out["goodput"] = round(n_good / elapsed, 2)
        out["late"] = n - n_good
        # Deadline-miss rate: late + platform-shed (expired) work over
        # everything that asked for a deadline and resolved in-window.
        n_expired = close["expired"] - mark["expired"]
        resolved = n + n_expired
        if resolved:
            out["deadline_miss_rate"] = round(
                (out["late"] + n_expired) / resolved, 3)
    labeled = {cls for cls in close["by_class"] if cls}
    if labeled:
        # Per-priority window deltas (the --mix profiles' report): the
        # class label is the X-Priority value each request carried.
        per = {}
        for cls in sorted(labeled):
            at_close = close["by_class"].get(cls, {})
            at_open = mark["by_class"].get(
                cls, {"completed": 0, "good": 0, "failed": 0, "expired": 0})
            c = at_close.get("completed", 0) - at_open["completed"]
            g = at_close.get("good", 0) - at_open["good"]
            e = at_close.get("expired", 0) - at_open["expired"]
            entry = {
                "completed": c,
                "failed": at_close.get("failed", 0) - at_open["failed"],
                "expired": e,
            }
            if deadline_s is not None:
                entry["goodput"] = round(g / elapsed, 2)
                entry["late"] = c - g
                if c + e:
                    entry["deadline_miss_rate"] = round(
                        (entry["late"] + e) / (c + e), 3)
            per[cls] = entry
        out["by_priority"] = per
    if tenant_names is not None:
        # Per-tenant window deltas (docs/tenancy.md): who completed, who
        # ran late, and who paid the tenant-quota 429s — the bench's
        # --tenant-mix noisy-neighbor A/B reads its verdict off this.
        zero = {"offered": 0, "completed": 0, "good": 0, "failed": 0,
                "expired": 0, "quota_shed": 0}
        per_tenant = {}
        for name in sorted(close["by_tenant"]):
            at_close = close["by_tenant"][name]
            at_open = mark["by_tenant"].get(name, zero)
            entry = {k: at_close.get(k, 0) - at_open[k] for k in zero}
            g = entry.pop("good")
            if deadline_s is not None:
                entry["goodput"] = round(g / elapsed, 2)
                entry["late"] = entry["completed"] - g
            per_tenant[name] = entry
        out["by_tenant"] = per_tenant
    return out


async def run_open_loop(
    session,
    *,
    post_url: str,
    payload: bytes,
    headers: dict,
    rate: float,
    status_url_for,
    duration: float = 20.0,
    ramp: float = 2.0,
    max_inflight: int = 512,
    task_timeout: float = 120.0,
    poll_wait: float = 30.0,
    post_url_for=None,
    on_accepted=None,
    on_terminal=None,
) -> dict:
    """Drive ``post_url`` OPEN-loop at an offered ``rate`` (request starts
    per second) — the rig's load shape: unlike the closed loop,
    arrival times are scheduled by the clock, not by completions, so a
    slow platform faces the same offered rate as a fast one and the gap
    shows up as queueing/errors instead of silently lowering the load.

    Honesty contract: ``offered`` counts every scheduled start — including
    starts the CLIENT could not launch because ``max_inflight`` requests
    were already outstanding (taxonomy ``client_saturated``: the loadgen
    itself was the bottleneck; the platform never saw those). ``achieved``
    counts requests that reached a terminal outcome. The window JSON
    reports ``offered_rate`` vs ``achieved_rate`` plus the same client
    error taxonomy as the closed loop.

    ``on_accepted(task_id)`` / ``on_terminal(task_id, status)`` feed the
    rig's cross-process invariant verdict (every accepted task terminal).
    """
    import aiohttp

    offered = 0
    launched = 0
    completed = 0
    failed = 0
    expired = 0
    latencies: list[float] = []
    errors: dict[str, int] = {}
    inflight: set = set()

    def _err(kind: str) -> None:
        errors[kind] = errors.get(kind, 0) + 1

    async def one() -> None:
        t0 = time.perf_counter()
        url = post_url if post_url_for is None else post_url_for()
        nonlocal completed, failed, expired
        try:
            async with session.post(url, data=payload,
                                    headers=headers) as resp:
                if resp.status in (503, 429):
                    # Tenant-quota 429s get their own taxonomy line: the
                    # rig runs one open loop per tenant, so this count IS
                    # that tenant's shed tally in the verdict.
                    if "tenant-quota" in resp.headers.get(
                            "X-Shed-Reason", ""):
                        _err("tenant_quota_429")
                    else:
                        _err(f"backpressure_{resp.status}")
                    return
                if resp.status == 504:
                    _err("shed_504")
                    expired += 1
                    return
                if resp.status >= 400:
                    _err(f"http_{resp.status}")
                    failed += 1
                    return
                task = await resp.json()
            task_id = task["TaskId"]
        except asyncio.TimeoutError:
            _err("timeout")
            failed += 1
            return
        except aiohttp.ClientError as exc:
            _err("connect_error"
                 if isinstance(exc, aiohttp.ClientConnectorError)
                 else "transport_error")
            failed += 1
            return
        except (ValueError, KeyError, TypeError):
            _err("bad_response")
            failed += 1
            return
        if on_accepted is not None:
            on_accepted(task_id)
        deadline = t0 + task_timeout
        while True:
            try:
                async with session.get(status_url_for(task_id),
                                       params={"wait": str(int(poll_wait))},
                                       headers=headers) as resp:
                    if resp.status == 404:
                        _err("task_poll_404")
                        failed += 1
                        return
                    if resp.status >= 400:
                        # Transient poll refusal (a gateway mid-kill, a
                        # store mid-failover): back off and re-poll — the
                        # task is accepted, its verdict matters.
                        await asyncio.sleep(0.2)
                    else:
                        record = await resp.json()
                        status = record["Status"]
                        if ("failed" in status or "completed" in status
                                or "expired" in status):
                            if on_terminal is not None:
                                on_terminal(task_id, status)
                            if "failed" in status:
                                failed += 1
                            elif "completed" in status:
                                completed += 1
                                latencies.append(time.perf_counter() - t0)
                            else:
                                expired += 1
                            return
            except (aiohttp.ClientError, asyncio.TimeoutError, ValueError,
                    KeyError, TypeError):
                # A kill mid-poll is expected chaos: reconnect via the
                # balancer and keep polling until the task's own budget
                # runs out.
                _err("poll_transport")
                await asyncio.sleep(0.2)
            if time.perf_counter() > deadline:
                _err("stuck_timeout")
                failed += 1
                return

    def _reap(task: asyncio.Task) -> None:
        inflight.discard(task)

    mark: dict = {}
    close: dict = {}

    async def open_window() -> None:
        await asyncio.sleep(ramp)
        mark.update(t=time.perf_counter(), offered=offered,
                    completed=completed, failed=failed, expired=expired,
                    errors=dict(errors), n_lat=len(latencies))

    async def close_window() -> None:
        await asyncio.sleep(ramp + duration)
        close.update(t=time.perf_counter(), offered=offered,
                     completed=completed, failed=failed, expired=expired,
                     errors=dict(errors), n_lat=len(latencies))

    async def pacer() -> None:
        nonlocal offered, launched
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        stop_at = t0 + ramp + duration
        while True:
            now = loop.time()
            if now >= stop_at:
                return
            due = int(rate * (now - t0)) - offered
            for _ in range(due):
                offered += 1
                if len(inflight) >= max_inflight:
                    # The CLIENT is the bottleneck: record it as such —
                    # this offered start never reached the platform.
                    _err("client_saturated")
                    continue
                task = loop.create_task(one())
                inflight.add(task)
                task.add_done_callback(_reap)
                launched += 1
            await asyncio.sleep(0.005)

    await asyncio.gather(pacer(), open_window(), close_window())
    if inflight:
        # Bounded drain so accepted tasks get their verdict; the window
        # stats were snapshotted at close time already.
        await asyncio.wait(inflight, timeout=task_timeout)
        for task in list(inflight):
            task.cancel()
        await asyncio.gather(*inflight, return_exceptions=True)

    elapsed = close["t"] - mark["t"]
    n = close["completed"] - mark["completed"]
    n_offered = close["offered"] - mark["offered"]
    window_lat = sorted(latencies[mark["n_lat"]:close["n_lat"]]) or [0.0]

    window_errors = _window_error_delta(close, mark)
    return {
        "mode": "open",
        "target_rate": rate,
        "offered": n_offered,
        "offered_rate": round(n_offered / elapsed, 2),
        "achieved_rate": round(n / elapsed, 2),
        "value": round(n / elapsed, 2),
        "completed": n,
        "failed": close["failed"] - mark["failed"],
        "expired": close["expired"] - mark["expired"],
        **_latency_percentiles(window_lat),
        "client_errors": window_errors,
        "duration_s": round(elapsed, 1),
        # Totals over the WHOLE run (ramp + window + drain) — what the
        # rig's invariant verdict reconciles against accepted TaskIds.
        "total_offered": offered,
        "total_launched": launched,
        "total_completed": completed,
        "total_failed": failed,
        "total_expired": expired,
        "total_errors": dict(errors),
    }
