"""Echo API — the platform's CPU smoke-test service, on the port (the
counterpart of ``examples/echo_service.py``).

Run:  python -m ai4e_tpu_torch.examples.echo_service [port]
Then: curl -X POST localhost:8081/v1/echo/echo -d '{"hello":"world"}'
      curl -X POST localhost:8081/v1/echo/echo-async -d '{"x":1}'   → {"TaskId": …}
      curl localhost:8081/v1/echo/task/<TaskId>
"""

import asyncio
import sys
import time

from ai4e_tpu_torch.config import FrameworkConfig
from ai4e_tpu_torch.service import APIService


def main() -> None:
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 8081
    # The observability env (AI4E_OBSERVABILITY_TRACE_EXPORT_PATH etc.) as
    # the launchers read it, so the spans show in ``python -m
    # ai4e_tpu_torch trace``.
    FrameworkConfig.from_env().observability.apply()
    svc = APIService("echo", prefix="v1/echo")

    @svc.api_sync_func("/echo", maximum_concurrent_requests=4)
    def echo(body, content_type):
        return {"echo": body.decode("utf-8", errors="replace")}

    @svc.api_sync_func("/slow", maximum_concurrent_requests=1)
    def slow(body, content_type):
        time.sleep(2)
        return {"slow": "done"}

    @svc.api_async_func("/echo-async")
    def echo_async(taskId, body, content_type):
        async def drive():
            await svc.task_manager.update_task_status(taskId, "running")
            await asyncio.sleep(0.5)  # a long inference, pretended
            await svc.task_manager.complete_task(
                taskId, f"completed - echoed {len(body)} bytes")
        asyncio.run(drive())

    svc.run(port=port)


if __name__ == "__main__":
    main()
