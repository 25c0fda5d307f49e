"""Command line: ``python -m ai4e_tpu_torch worker --models <spec.json>``.

Counterpart of the worker half of ``ai4e_tpu/cli.py``. It reads the same
models.json schema (``service_name``, ``prefix``, ``models`` with
``family`` plus the family's keyword arguments, ``sync_path``,
``async_path``, ``maximum_concurrent_requests`` and ``checkpoint``) and
serves on the card unless ``--device cpu`` is given. A spec key this port
does not serve yet raises and names itself.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal

log = logging.getLogger("ai4e_tpu_torch.cli")

#: Spec keys of the JAX worker that this port does not serve yet.
_UNPORTED_SPEC_KEYS = {
    "taskstore": "serving behind the control plane's task store "
                 "(HttpTaskManager/HttpResultStore)",
}
_UNPORTED_MODEL_KEYS = {
    "pipeline_to": "pipeline handoffs",
    "batch": "the batch API (serve_batch)",
}


def load_spec(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def restore_checkpoint(servable, path: str) -> None:
    """Load a flax params tree saved flat with ``convert.save_npz`` into
    ``servable.module``. An orbax checkpoint directory raises: reading it
    needs JAX, so convert it first."""
    from .convert import load_npz

    if not path.endswith(".npz"):
        raise ValueError(
            f"checkpoint {path!r}: the port reads .npz trees written by "
            "ai4e_tpu_torch.convert.save_npz; orbax restore is not ported yet")
    if servable.state_dict_from_flax is None:
        raise ValueError(f"model {servable.name!r} has no weights to restore")
    servable.module.load_state_dict(
        servable.state_dict_from_flax(load_npz(path)))
    servable.checkpoint_path = path
    log.info("restored %s params from %s", servable.name, path)


def build_worker(models: dict, device=None, max_wait_ms: float = 5.0,
                 max_pending: int = 256):
    """Assemble a worker from a models spec; returns ``(worker, batcher,
    task_manager)``. ``device`` defaults to ``cuda``."""
    from .metrics import MetricsRegistry
    from .runtime.batcher import MicroBatcher
    from .runtime.families import build_servable
    from .runtime.registry import ModelRuntime
    from .runtime.worker import InferenceWorker
    from .service.task_manager import LocalTaskManager
    from .taskstore import InMemoryTaskStore

    for key, what in _UNPORTED_SPEC_KEYS.items():
        if key in models:
            raise ValueError(f"spec key {key!r} ({what}) is not ported yet")
    runtime = ModelRuntime(device=device)
    to_serve = []
    for spec in models.get("models", []):
        spec = dict(spec)
        family = spec.pop("family")
        for key, what in _UNPORTED_MODEL_KEYS.items():
            if key in spec:
                raise ValueError(
                    f"model {spec.get('name', family)!r}: {key!r} ({what}) is "
                    "not ported yet")
        sync_path = spec.pop("sync_path", None)
        async_path = spec.pop("async_path", None)
        cap = spec.pop("maximum_concurrent_requests", 64)
        checkpoint = spec.pop("checkpoint", None)
        servable = build_servable(family, **spec)
        if checkpoint:
            restore_checkpoint(servable, checkpoint)
        runtime.register(servable)
        to_serve.append((servable, sync_path, async_path, cap))

    metrics = MetricsRegistry()
    store = InMemoryTaskStore()
    task_manager = LocalTaskManager(store)
    batcher = MicroBatcher(runtime, max_wait_ms=max_wait_ms,
                           max_pending=max_pending, metrics=metrics)
    worker = InferenceWorker(models.get("service_name", "gpu-worker"), runtime,
                             batcher, task_manager=task_manager,
                             prefix=models.get("prefix", "v1"),
                             metrics=metrics, store=store)
    for servable, sync_path, async_path, cap in to_serve:
        worker.serve_model(servable, sync_path=sync_path,
                           async_path=async_path,
                           maximum_concurrent_requests=cap)
    runtime.warmup()
    return worker, batcher, task_manager


async def serve(worker, batcher, host: str, port: int,
                stop: asyncio.Event, drain_timeout: float = 30.0) -> None:
    """Serve ``worker`` on ``host:port`` until ``stop`` is set, then drain
    in-flight async tasks and stop the batcher."""
    from aiohttp import web

    await batcher.start()
    runner = web.AppRunner(worker.service.app)
    await runner.setup()
    try:
        await web.TCPSite(runner, host, port).start()
        log.info("worker on %s:%s serving %s on %s", host, port,
                 list(worker.runtime.models), worker.runtime.device)
        await stop.wait()
    finally:
        await worker.service.drain(timeout=drain_timeout)
        await batcher.stop()
        await runner.cleanup()


async def run_worker(models: dict, host: str, port: int, device=None) -> None:
    worker, batcher, _ = build_worker(models, device=device)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await serve(worker, batcher, host, port, stop)


def main(argv=None) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    parser = argparse.ArgumentParser(prog="ai4e_tpu_torch")
    sub = parser.add_subparsers(dest="component", required=True)
    wk = sub.add_parser("worker", help="GPU inference worker")
    wk.add_argument("--models", required=True, help="models.json path")
    wk.add_argument("--host", default="0.0.0.0")
    wk.add_argument("--port", type=int, default=8081)
    wk.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    if args.component == "worker":
        asyncio.run(run_worker(load_spec(args.models), args.host, args.port,
                               device=args.device))


if __name__ == "__main__":
    main()
