"""The whole async platform in one process, on the port (the counterpart
of ``examples/async_platform.py``): gateway, task store, broker,
dispatcher and a backend service that pretends to score images.

Run:  python -m ai4e_tpu_torch.examples.async_platform [gateway_port] [backend_port]
Then: TID=$(curl -s -X POST localhost:8080/v1/camera-trap/detect -d @image.jpg | jq -r .TaskId)
      curl localhost:8080/v1/taskmanagement/task/$TID      # created → running → completed
"""

import asyncio
import sys

from aiohttp import web

from ai4e_tpu_torch.config import FrameworkConfig
from ai4e_tpu_torch.platform_assembly import LocalPlatform


async def main() -> None:
    gw_port = int(sys.argv[1]) if len(sys.argv) > 1 else 8080
    be_port = int(sys.argv[2]) if len(sys.argv) > 2 else 8083

    # Typed config: defaults and AI4E_* overrides (e.g.
    # AI4E_OBSERVABILITY_TRACE_EXPORT_PATH=/tmp/spans.jsonl for a span log,
    # AI4E_PLATFORM_RETRY_DELAY=0.1 for a faster redelivery).
    cfg = FrameworkConfig.from_env()
    cfg.observability.apply()
    pc = cfg.to_platform_config()
    pc.retry_delay = min(pc.retry_delay, 0.5)  # a demo's redelivery
    platform = LocalPlatform(pc)
    svc = platform.make_service("detector", prefix="v1/detector")

    @svc.api_async_func("/detect", maximum_concurrent_requests=2)
    def detect(taskId, body, content_type):
        async def drive():
            await platform.task_manager.update_task_status(
                taskId, "running - detector scoring image")
            await asyncio.sleep(1.0)  # a long inference, pretended
            await platform.task_manager.complete_task(
                taskId, f"completed - scored {len(body)} bytes")
        asyncio.run(drive())

    backend_uri = f"http://127.0.0.1:{be_port}/v1/detector/detect"
    platform.publish_async_api("/v1/camera-trap/detect", backend_uri)

    svc_runner = web.AppRunner(svc.app)
    await svc_runner.setup()
    await web.TCPSite(svc_runner, "127.0.0.1", be_port).start()

    gw_runner = web.AppRunner(platform.gateway.app)
    await gw_runner.setup()
    await web.TCPSite(gw_runner, "127.0.0.1", gw_port).start()

    await platform.start()
    print(f"gateway on :{gw_port}, backend on :{be_port}", flush=True)
    await asyncio.Event().wait()


if __name__ == "__main__":
    asyncio.run(main())
