"""The soak engine — ``scripts/soak.sh``'s body, moved onto the rig's
process supervision; a copy of ``ai4e_tpu/rig/soak.py`` that spawns the
port's control plane and worker (the echo model on ``--device cpu``, in
place of JAX's platform pin, which the port refuses) and drives them
with the port's load client.

The bash script used to hand-roll exactly what ``Supervisor`` now owns:
wait for a previous run's ports and SIGKILL-escalate on whatever still
holds them, health-gate both children, trap-kill on every exit path. The
script keeps its CLI contract (``scripts/soak.sh [minutes] [outdir]``)
as a thin wrapper over ``python -m ai4e_tpu_torch.rig soak``; the windowed
closed-loop measurement and the RSS-creep watch are unchanged.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time

from ..observability.vitals import read_rss_mb
from .supervisor import Supervisor, python_argv

log = logging.getLogger("ai4e_tpu_torch.rig.soak")

CP_PORT = 18889
WK_PORT = 18890


def _rss_mb(pid: int | None) -> float:
    """Child RSS via the shared vitals parser. The None guard is
    load-bearing: a vanished child's pid is None, and the helper's
    pid=None means '/proc/self' — without the guard a dead child would
    read as the soak DRIVER's own RSS and the death check below
    (`< 0` breaks the loop) would never fire."""
    return read_rss_mb(pid) if pid is not None else -1.0


def _write_specs(out: str) -> None:
    with open(os.path.join(out, "routes.json"), "w",
              encoding="utf-8") as fh:
        json.dump({"apis": [{
            "prefix": "/v1/echo/run-async",
            "backend": f"http://127.0.0.1:{WK_PORT}/v1/echo/run-async",
            "concurrency": 4, "retry_delay": 0.2}]}, fh)
    with open(os.path.join(out, "models.json"), "w",
              encoding="utf-8") as fh:
        json.dump({"service_name": "soak-echo", "prefix": "v1/echo",
                   "taskstore": f"http://127.0.0.1:{CP_PORT}",
                   "models": [{"family": "echo", "name": "echo",
                               "size": 16, "buckets": [8],
                               "async_path": "/run-async"}]}, fh)
    import io

    import numpy as np
    buf = io.BytesIO()
    np.save(buf, np.arange(16, dtype=np.float32))
    with open(os.path.join(out, "payload.npy"), "wb") as fh:
        fh.write(buf.getvalue())


async def _window(out: str) -> dict:
    """One 30 s closed-loop window of the async echo route through the
    control plane (``examples/loadgen.py``'s window, on the port's load
    client)."""
    import aiohttp

    from ..utils.loadclient import run_closed_loop

    gateway = f"http://127.0.0.1:{CP_PORT}"
    with open(os.path.join(out, "payload.npy"), "rb") as fh:
        payload = fh.read()
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0)) as session:
        window = await run_closed_loop(
            session, post_url=f"{gateway}/v1/echo/run-async",
            payload=payload,
            headers={"Content-Type": "application/octet-stream"},
            mode="async",
            status_url_for=lambda tid:
                f"{gateway}/v1/taskmanagement/task/{tid}",
            concurrency=32, duration=30.0, ramp=2.0)
    return {"metric": "async_loadgen_throughput", "unit": "req/s",
            "path": "/v1/echo/run-async", "concurrency": 32, **window}


async def run_soak(minutes: float = 10.0, out: str = "/tmp/soak") -> int:
    os.makedirs(out, exist_ok=True)
    _write_specs(out)
    env = {**os.environ, "AI4E_PLATFORM_RETRY_DELAY": "0.2"}
    windows: list[dict] = []
    failures = 0
    with Supervisor() as sup:
        sup.spawn("control-plane",
                  python_argv("ai4e_tpu_torch", "control-plane", "--routes",
                              os.path.join(out, "routes.json"),
                              "--port", str(CP_PORT)),
                  env={**env, "AI4E_PLATFORM_JOURNAL_PATH":
                       os.path.join(out, "tasks.jsonl")},
                  log_path=os.path.join(out, "cp.log"), port=CP_PORT,
                  health_url=f"http://127.0.0.1:{CP_PORT}/healthz")
        sup.spawn("worker",
                  python_argv("ai4e_tpu_torch", "worker", "--models",
                              os.path.join(out, "models.json"),
                              "--port", str(WK_PORT), "--device", "cpu"),
                  env=env, log_path=os.path.join(out, "wk.log"),
                  port=WK_PORT,
                  health_url=f"http://127.0.0.1:{WK_PORT}/v1/echo/")
        sup.wait_healthy("control-plane", timeout=120.0)
        sup.wait_healthy("worker", timeout=240.0)
        cp_pid, wk_pid = (sup.children["control-plane"].pid,
                          sup.children["worker"].pid)

        deadline = time.time() + minutes * 60.0
        while time.time() < deadline:
            try:
                rec = await _window(out)
            except Exception as exc:  # noqa: BLE001; ai4e: noqa[AIL005] — the failed window is recorded as its row
                rec = {"error": repr(exc)[:200]}
            rec["cp_rss_mb"] = _rss_mb(cp_pid)
            rec["wk_rss_mb"] = _rss_mb(wk_pid)
            windows.append(rec)
            failures += int(rec.get("failed", 0) or 0)
            print(json.dumps(rec), flush=True)
            if rec["cp_rss_mb"] < 0 or rec["wk_rss_mb"] < 0:
                break

    rss = [(w["cp_rss_mb"], w["wk_rss_mb"]) for w in windows]
    summary = {
        "soak_minutes": minutes,
        "windows": len(windows),
        "total_completed": sum(int(w.get("completed", 0) or 0)
                               for w in windows),
        "total_failed": failures,
        "throughput_first": windows[0].get("value") if windows else None,
        "throughput_last": windows[-1].get("value") if windows else None,
        "cp_rss_first_mb": rss[0][0] if rss else None,
        "cp_rss_last_mb": rss[-1][0] if rss else None,
        "wk_rss_first_mb": rss[0][1] if rss else None,
        "wk_rss_last_mb": rss[-1][1] if rss else None,
        "process_death": any(a < 0 or b < 0 for a, b in rss),
    }
    print(json.dumps(summary), flush=True)
    with open(os.path.join(out, "soak_summary.json"), "w",
              encoding="utf-8") as fh:
        json.dump({"summary": summary, "windows": windows}, fh, indent=1)
    ok = (not summary["process_death"] and failures == 0
          and summary["windows"] > 0)
    return 0 if ok else 1
