"""Loadgen PROCESS — one open-loop traffic source through the balancer;
a copy of ``ai4e_tpu/rig/loadgen.py``.

Each loadgen drives ``rate / loadgens`` request starts per second with
``utils.loadclient.run_open_loop`` (the clock schedules arrivals, so a
slow platform faces the same offered rate as a fast one and the shortfall
is REPORTED — offered vs achieved plus the client error taxonomy — never
silently re-labeled as the target). Beside the window JSON it records:

- every accepted TaskId and every client-observed terminal status — the
  rig verdict's reconciliation input;
- a 1 Hz sample curve of offered/accepted/terminal counts with wall-clock
  timestamps, which the driver joins against the chaos timeline to plot
  goodput during and after each fault.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time

from ..utils.loadclient import run_open_loop
from .topology import Topology

log = logging.getLogger("ai4e_tpu_torch.rig.loadgen")


async def run_loadgen(topo: Topology, index: int) -> None:
    import aiohttp

    base = topo.balancer_url()
    payload = json.dumps(
        {"loadgen": index,
         "pad": "x" * max(0, topo.payload_bytes - 32)}).encode("utf-8")
    headers = {"Content-Type": "application/json"}
    rate = topo.rate / max(1, topo.loadgens)
    tenant = None
    if index < len(topo.loadgen_tenants):
        # Tenant-pinned loadgen: ONE tenant's whole traffic stream, so
        # the window's error taxonomy (tenant_quota_429 vs backpressure)
        # IS that tenant's shed tally and the noisy-neighbor A/B reads
        # straight off the per-loadgen artifacts.
        assignment = topo.loadgen_tenants[index]
        tenant = assignment.get("name")
        headers["Ocp-Apim-Subscription-Key"] = assignment["key"]
        rate = float(assignment.get("rate", rate))
    accepted: list[str] = []
    terminal: dict[str, str] = {}
    samples: list[dict] = []

    def status_url_for(task_id: str) -> str:
        return f"{base}/v1/taskmanagement/task/{task_id}"

    started_at = time.time()
    done = asyncio.Event()

    async def sampler() -> None:
        while not done.is_set():
            samples.append({
                "t": round(time.time(), 2),
                "accepted": len(accepted),
                "terminal": len(terminal),
                "completed": sum(1 for s in terminal.values()
                                 if "completed" in s),
            })
            try:
                await asyncio.wait_for(done.wait(), 1.0)
            except asyncio.TimeoutError:
                continue

    sampler_task = asyncio.create_task(sampler())
    async with aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=90),
            connector=aiohttp.TCPConnector(limit=0)) as session:
        window = await run_open_loop(
            session,
            post_url=base + topo.route,
            payload=payload,
            headers=headers,
            rate=rate,
            status_url_for=status_url_for,
            duration=topo.duration,
            ramp=topo.ramp,
            max_inflight=topo.max_inflight,
            task_timeout=topo.task_timeout,
            poll_wait=topo.poll_wait,
            on_accepted=accepted.append,
            on_terminal=terminal.__setitem__,
        )
    done.set()
    await sampler_task

    out = {
        "loadgen": index,
        **({"tenant": tenant} if tenant else {}),
        "started_at": started_at,
        "finished_at": time.time(),
        "window": window,
        "samples": samples,
        "accepted": accepted,
        "terminal": terminal,
    }
    path = os.path.join(topo.workdir, f"loadgen-{index}.json")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(out, fh)
    os.replace(tmp, path)  # atomic: the driver must never read a torn file
    log.info("loadgen %d: offered %.0f/s achieved %.0f/s (%d accepted, "
             "%d terminal)", index, window["offered_rate"],
             window["achieved_rate"], len(accepted), len(terminal))
