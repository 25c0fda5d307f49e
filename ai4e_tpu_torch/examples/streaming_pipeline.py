"""A chained streaming DAG on the port: two autoregressive stages under ONE
TaskId (the counterpart of ``examples/streaming_pipeline.py``).

Stage 1 ("transcribe") decodes a token stream from the client's prompt,
stage 2 ("summarize") decodes from stage 1's tokens, both through the
continuous-batching decode engine, both publishing each token as a
``chunk`` event through the ``TaskEventHub`` under the ROOT TaskId, so one
SSE subscription watches the whole pipeline stream:

    chunk {"stage": "transcribe", "index": 0, "data": {"token": ...}}
    ...
    stage {"stage": "transcribe", "state": "completed", ...}
    chunk {"stage": "summarize", "index": 0, "data": {"token": ...}}
    ...
    terminal {...}

Run:  python -m ai4e_tpu_torch.examples.streaming_pipeline [--device cpu]

It boots the whole platform in one process (gateway, store, broker,
dispatcher, pipeline coordinator and a worker holding both decode engines,
the LMs on ``cuda`` unless ``--device cpu``), POSTs one request and prints
the live event stream: tokens appear stage by stage, before the terminal
record exists.
"""

import argparse
import asyncio
import json
from types import SimpleNamespace

from aiohttp import ClientSession, web

from ai4e_tpu_torch.pipeline import PipelineSpec, StageSpec
from ai4e_tpu_torch.platform_assembly import LocalPlatform, PlatformConfig
from ai4e_tpu_torch.runtime.decode import DecodeEngine
from ai4e_tpu_torch.runtime.kvcache import (PagedDecodeRuntime,
                                            build_lm_servable)
from ai4e_tpu_torch.runtime.registry import ModelRuntime
from ai4e_tpu_torch.runtime.worker import InferenceWorker


async def main(device: str | None = None) -> None:
    platform = LocalPlatform(PlatformConfig(pipeline=True, retry_delay=0.1))

    # Two tiny LMs: "transcribe" makes a 24-token stream from the prompt,
    # "summarize" 12 tokens from that transcript. (Initial weights: the
    # tokens are arbitrary; the demo is the serving shape, not the model.)
    runtime = ModelRuntime(device)
    engines = {}
    for name in ("transcribe", "summarize"):
        servable = build_lm_servable(name=name, vocab_size=256, max_len=64,
                                     dim=48, depth=2, heads=4)
        backend = PagedDecodeRuntime(servable, runtime, slots=2,
                                     prompt_buckets=(8,))
        print(f"warming {name} (prefill buckets + step program)...",
              flush=True)
        backend.warm()
        engines[name] = DecodeEngine(backend)

    worker = InferenceWorker(
        "stream-demo",
        runtime=SimpleNamespace(models={}),
        batcher=SimpleNamespace(pending_count=0, max_pending=64),
        task_manager=platform.task_manager, prefix="v1/lm",
        store=platform.store)
    for engine in engines.values():
        worker.serve_stream(engine, event_hub=platform.task_events)

    be_runner = web.AppRunner(worker.service.app)
    await be_runner.setup()
    be_site = web.TCPSite(be_runner, "127.0.0.1", 0)
    await be_site.start()
    be_port = be_site._server.sockets[0].getsockname()[1]
    base = f"http://127.0.0.1:{be_port}/v1/lm"
    for name in engines:
        platform.register_internal_route(f"{base}/{name}-stream-async")

    platform.register_pipeline(PipelineSpec(
        "voicebrief", "/v1/voice/brief",
        stages=(
            StageSpec("transcribe",
                      endpoint=f"{base}/transcribe-stream-async"),
            # input="auto": the summarize stage's body is transcribe's
            # stored result ({"tokens": [...]}), which serve_stream takes
            # as the prompt.
            StageSpec("summarize",
                      endpoint=f"{base}/summarize-stream-async",
                      after=("transcribe",)),
        )))

    gw_runner = web.AppRunner(platform.gateway.app)
    await gw_runner.setup()
    gw_site = web.TCPSite(gw_runner, "127.0.0.1", 0)
    await gw_site.start()
    gw_port = gw_site._server.sockets[0].getsockname()[1]
    gw = f"http://127.0.0.1:{gw_port}"

    await platform.start()
    for engine in engines.values():
        await engine.start()

    async with ClientSession() as session:
        body = json.dumps({"prompt": [5, 17, 42, 99, 7, 3],
                           "max_new_tokens": 24})
        async with session.post(f"{gw}/v1/voice/brief", data=body) as resp:
            task = await resp.json()
        task_id = task["TaskId"]
        print(f"\nTaskId {task_id} — streaming "
              f"{gw}/v1/taskmanagement/task/{task_id}/events\n", flush=True)

        tokens: dict[str, list[int]] = {}
        async with session.get(
                f"{gw}/v1/taskmanagement/task/{task_id}/events",
                params={"wait": "60"}) as resp:
            event, current = "", {}
            async for raw in resp.content:
                line = raw.decode().rstrip("\n")
                if line.startswith("event: "):
                    event = line[7:]
                elif line.startswith("data: "):
                    current = json.loads(line[6:])
                elif line == "" and event:
                    if event == "chunk":
                        stage = current["stage"]
                        tokens.setdefault(stage, []).append(
                            current["data"]["token"])
                        print(f"  chunk  [{stage}] #{current['index']} "
                              f"token={current['data']['token']}",
                              flush=True)
                    elif event == "stage":
                        print(f"  stage  [{current['stage']}] "
                              f"{current.get('state')}", flush=True)
                    elif event == "terminal":
                        print(f"\nterminal: {current.get('Status')}",
                              flush=True)
                        break
                    event, current = "", {}

    print(f"\ntranscribe streamed {len(tokens.get('transcribe', []))} "
          f"tokens, summarize streamed "
          f"{len(tokens.get('summarize', []))} — one TaskId, one SSE "
          f"stream, two stages.", flush=True)

    for engine in engines.values():
        await engine.stop()
    await platform.stop()
    await gw_runner.cleanup()
    await be_runner.cleanup()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (default), cuda:N or cpu: where the LMs run")
    return p


if __name__ == "__main__":
    asyncio.run(main(parser().parse_args().device))
