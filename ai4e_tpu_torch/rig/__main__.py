"""``python -m ai4e_tpu_torch.rig`` — the rig's process entrypoints; a
copy of ``ai4e_tpu/rig/__main__.py``.

``up`` is the driver (``make rig`` runs it); every other subcommand is a
child role the driver launches with ``--spec <resolved topology.json>``.
Children derive EVERYTHING from the spec file — the ``AI4E_RIG_*`` env
knobs are driver-side only (docs/config.md documents each).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import sys

from .topology import Topology


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return default if raw is None or raw == "" else int(raw)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return default if raw is None or raw == "" else float(raw)


def _topology_from_args(args) -> Topology:
    return Topology(
        gateways=args.gateways, shards=args.shards,
        replicas=args.replicas, dispatchers=args.dispatchers,
        workers=args.workers, loadgens=args.loadgens,
        rate=args.rate, duration=args.duration, ramp=args.ramp,
        chaos=not args.no_chaos, seed=args.seed,
        collector=not args.no_collector,
        observability=not args.no_observability,
        work_ms=args.work_ms, base_port=args.base_port,
        workdir=args.workdir, max_inflight=args.max_inflight,
        task_timeout=args.task_timeout,
        tenants=args.tenants,
        loadgen_tenants=(json.loads(args.loadgen_tenants)
                         if args.loadgen_tenants else []),
        mesh=args.mesh, mesh_poison_nths=args.mesh_poison_nths,
        mesh_recovery_s=args.mesh_recovery_s,
        rollout=args.rollout, rollout_error_rate=args.rollout_error_rate,
        rollout_steps=args.rollout_steps,
        rollout_hold_s=args.rollout_hold_s,
        rollout_drain_timeout_ms=args.rollout_drain_timeout_ms)


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    # Per-request INFO noise (access lines, tracer spans) costs real CPU
    # at rig rates and buries the supervision/chaos/failover lines the
    # run is recorded for.
    logging.getLogger("aiohttp.access").setLevel(logging.WARNING)
    logging.getLogger("ai4e_tpu_torch.trace").setLevel(logging.WARNING)
    parser = argparse.ArgumentParser(prog="ai4e_tpu_torch.rig")
    sub = parser.add_subparsers(dest="cmd", required=True)

    up = sub.add_parser("up", help="launch the rig, drive load, replay "
                                   "chaos, record the artifact")
    up.add_argument("--gateways", type=int,
                    default=_env_int("AI4E_RIG_GATEWAYS", 3))
    up.add_argument("--shards", type=int,
                    default=_env_int("AI4E_RIG_SHARDS", 2))
    up.add_argument("--replicas", type=int,
                    default=_env_int("AI4E_RIG_REPLICAS", 1))
    up.add_argument("--dispatchers", type=int,
                    default=_env_int("AI4E_RIG_DISPATCHERS", 2))
    up.add_argument("--workers", type=int,
                    default=_env_int("AI4E_RIG_WORKERS", 1))
    up.add_argument("--loadgens", type=int,
                    default=_env_int("AI4E_RIG_LOADGENS", 2))
    up.add_argument("--rate", type=float,
                    default=_env_float("AI4E_RIG_RATE", 10000.0))
    up.add_argument("--duration", type=float,
                    default=_env_float("AI4E_RIG_DURATION", 30.0))
    up.add_argument("--ramp", type=float,
                    default=_env_float("AI4E_RIG_RAMP", 3.0))
    up.add_argument("--seed", type=int,
                    default=_env_int("AI4E_RIG_SEED", 20260803))
    up.add_argument("--work-ms", type=float, default=0.0)
    up.add_argument("--base-port", type=int,
                    default=_env_int("AI4E_RIG_BASE_PORT", 18800))
    up.add_argument("--workdir",
                    default=os.environ.get("AI4E_RIG_WORKDIR",
                                           "/tmp/ai4e-rig"))
    up.add_argument("--max-inflight", type=int, default=512)
    up.add_argument("--task-timeout", type=float, default=60.0)
    up.add_argument("--no-chaos", action="store_true",
                    help="measure only; skip the fault timeline")
    up.add_argument("--no-collector", action="store_true",
                    help="skip the fleet-telemetry collector role")
    up.add_argument("--no-observability", action="store_true",
                    help="no hop-ledger stamps / flight rings / vitals "
                         "samplers / timeline (the serving fleet "
                         "without its telemetry)")
    up.add_argument("--tenants",
                    default=os.environ.get("AI4E_RIG_TENANTS", ""),
                    help="tenant registry spec "
                         "('name=key:weight:rps:burst,...') — enables "
                         "per-gateway quota edges + weighted-fair shard "
                         "lanes (docs/tenancy.md); empty = tenancy off")
    up.add_argument("--loadgen-tenants",
                    default=os.environ.get("AI4E_RIG_LOADGEN_TENANTS", ""),
                    help="JSON list pinning loadgen i to a tenant: "
                         '[{"name": ..., "key": ..., "rate": rps}, ...] — '
                         "rate overrides the even rate/loadgens split "
                         "(the noisy-neighbor lever)")
    up.add_argument("--mesh",
                    default=os.environ.get("AI4E_RIG_MESH", ""),
                    help="mesh layout spec ('dp=8', 'dp=2,tp=2') — boots "
                         "every worker as a mesh endpoint with the tier "
                         "label in its route (docs/mesh_serving.md); "
                         "empty = plain echo workers")
    up.add_argument("--mesh-poison-nths",
                    default=os.environ.get("AI4E_RIG_MESH_POISON_NTHS", ""),
                    help="comma-separated 1-based delivery ordinals each "
                         "mesh worker poisons (503 result-invalidated → "
                         "per-task redelivery; consecutive poisons flip "
                         "the endpoint unhealthy)")
    up.add_argument("--mesh-recovery-s", type=float,
                    default=_env_float("AI4E_RIG_MESH_RECOVERY_S", 2.0),
                    help="seconds a flipped-unhealthy mesh worker stays "
                         "dark before its follower-restart probe")
    up.add_argument("--rollout", default=os.environ.get("AI4E_RIG_ROLLOUT",
                                                        ""),
                    choices=["", "clean", "bad-canary"],
                    help="rolling-upgrade scenario under load "
                         "(docs/deployment.md#rollouts): 'clean' must "
                         "promote with zero loss; 'bad-canary' seeds "
                         "errors into generation 2 and must auto-rollback "
                         "before its share passes 50%%")
    up.add_argument("--rollout-error-rate", type=float,
                    default=_env_float("AI4E_RIG_ROLLOUT_ERROR_RATE", 0.0),
                    help="seeded 500 rate at generations >= 2 "
                         "(bad-canary; 0 with --rollout bad-canary "
                         "defaults to 0.25)")
    up.add_argument("--rollout-steps",
                    default=os.environ.get("AI4E_RIG_ROLLOUT_STEPS",
                                           "25,50,100"),
                    help="canary weight ladder in percent, ending at 100")
    up.add_argument("--rollout-hold-s", type=float,
                    default=_env_float("AI4E_RIG_ROLLOUT_HOLD_S", 3.0),
                    help="clean-burn hold per canary step (s)")
    up.add_argument("--rollout-drain-timeout-ms", type=float,
                    default=_env_float("AI4E_RIG_ROLLOUT_DRAIN_TIMEOUT_MS",
                                       5000.0),
                    help="per-worker drain budget before force-retire")
    up.add_argument("--out", default=None,
                    help="artifact directory (rig.json is written here)")

    soak = sub.add_parser(
        "soak", help="the scripts/soak.sh engine: control plane + worker "
                     "under rig supervision, windowed closed-loop load")
    soak.add_argument("--minutes", type=float, default=10.0)
    soak.add_argument("--out", default="/tmp/soak")

    for role in ("storenode", "gatewaynode", "balancer", "dispatchernode",
                 "workernode", "loadgen", "collector"):
        p = sub.add_parser(role)
        p.add_argument("--spec", required=True)
        if role in ("storenode", "dispatchernode", "workernode"):
            p.add_argument("--shard", type=int, required=True)
        if role not in ("balancer", "collector"):
            p.add_argument("--index", type=int,
                           required=role != "storenode",
                           default=-1 if role == "storenode" else None)

    args = parser.parse_args(argv)

    if args.cmd == "up":
        from .run import run_rig, summarize
        topo = _topology_from_args(args)
        result = asyncio.run(run_rig(topo, out_dir=args.out))
        print(summarize(result))
        print(json.dumps({"ok": result["ok"],
                          "verdict": {k: v for k, v in
                                      result["verdict"].items()
                                      if k != "windows"}}))
        return 0 if result["ok"] else 1
    if args.cmd == "soak":
        from .soak import run_soak
        return asyncio.run(run_soak(minutes=args.minutes, out=args.out))

    topo = Topology.load(args.spec)
    if args.cmd == "storenode":
        from .storenode import run_storenode
        asyncio.run(run_storenode(topo, args.shard, args.index))
    elif args.cmd == "gatewaynode":
        from .gatewaynode import run_gatewaynode
        asyncio.run(run_gatewaynode(topo, args.index))
    elif args.cmd == "balancer":
        from .balancer import run_balancer
        asyncio.run(run_balancer(topo))
    elif args.cmd == "collector":
        from .collectornode import run_collectornode
        asyncio.run(run_collectornode(topo))
    elif args.cmd == "dispatchernode":
        from .dispatchernode import run_dispatchernode
        asyncio.run(run_dispatchernode(topo, args.shard, args.index))
    elif args.cmd == "workernode":
        from .workernode import run_workernode
        asyncio.run(run_workernode(topo, args.shard, args.index))
    elif args.cmd == "loadgen":
        from .loadgen import run_loadgen
        asyncio.run(run_loadgen(topo, args.index))
    return 0


if __name__ == "__main__":
    sys.exit(main())
