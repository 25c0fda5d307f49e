"""Closed-loop load generator for a deployed platform, on the port (the
counterpart of ``examples/loadgen.py``).

It drives a live gateway (the ``python -m ai4e_tpu_torch control-plane``
and ``worker`` processes, the rig's balancer, an ingress) and prints one
JSON summary line. Async mode POSTs the task route and long-polls
``/v1/taskmanagement/task/{id}`` to completion; sync mode times request
and response on the given path. The client loop (ramp window, error
tolerance, percentiles) is ``ai4e_tpu_torch/utils/loadclient.py``.

    python -m ai4e_tpu_torch.examples.loadgen --gateway http://localhost:8080 \\
        --path /v1/landcover/classify-async --payload tile.npy \\
        --concurrency 128 --duration 20 [--mode async] [--ramp 5] \\
        [--api-key KEY]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


async def run(args) -> dict:
    import aiohttp

    from ai4e_tpu_torch.utils.loadclient import run_closed_loop

    with open(args.payload, "rb") as f:  # noqa: ASYNC230  # read once, at start
        payload = f.read()
    headers = {"Content-Type": args.content_type}
    if args.api_key:
        headers["Ocp-Apim-Subscription-Key"] = args.api_key

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0)) as session:
        # Fail fast on a bad URL or key before the loop starts; a 503 is
        # backpressure (the deployment may be under load already), not a
        # configuration error: retry briefly, then leave it to the loop.
        for _ in range(20):
            async with session.post(f"{args.gateway}{args.path}",
                                    data=payload, headers=headers) as resp:
                if resp.status == 503:
                    await asyncio.sleep(0.25)
                    continue
                if resp.status >= 400:
                    raise SystemExit(
                        f"warm request failed: {resp.status} "
                        f"{(await resp.read())[:200]!r}")
                break
        window = await run_closed_loop(
            session,
            post_url=f"{args.gateway}{args.path}",
            payload=payload, headers=headers, mode=args.mode,
            status_url_for=lambda tid:
                f"{args.gateway}/v1/taskmanagement/task/{tid}",
            concurrency=args.concurrency, duration=args.duration,
            ramp=args.ramp, task_timeout=args.task_timeout)
    return {
        "metric": f"{args.mode}_loadgen_throughput",
        "unit": "req/s",
        "path": args.path,
        "concurrency": args.concurrency,
        **window,
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gateway", required=True)
    p.add_argument("--path", required=True)
    p.add_argument("--payload", required=True, help="file POSTed as the body")
    p.add_argument("--content-type", default="application/octet-stream")
    p.add_argument("--mode", choices=("async", "sync"), default="async")
    p.add_argument("--concurrency", type=int, default=64)
    p.add_argument("--duration", type=float, default=20.0)
    p.add_argument("--ramp", type=float, default=5.0)
    p.add_argument("--task-timeout", type=float, default=120.0,
                   help="give up polling a task after this many seconds")
    p.add_argument("--api-key", default=None)
    return p


def main() -> None:
    args = parser().parse_args()
    result = asyncio.run(run(args))
    print(json.dumps(result), flush=True)
    if result["completed"] == 0:
        sys.exit(1)


if __name__ == "__main__":
    main()
