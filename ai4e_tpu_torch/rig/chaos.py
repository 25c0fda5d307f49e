"""The rig's seeded chaos timeline — the existing chaos vocabulary where
a "kill" is a real SIGKILL of a real OS process (docs/deployment.md); a
copy of ``ai4e_tpu/rig/chaos.py``.

Four verbs, mirroring what PRs 6–10 proved in-process:

- ``kill_gateway``        — SIGKILL one gateway replica; the balancer's
  connect-failover re-homes clients, in-flight long-polls re-poll;
- ``kill_dispatcher``     — SIGKILL one dispatcher process mid-lease,
  respawn it after a gap; the server-side lease expires and redelivers
  (duplicate suppression must absorb the overlap);
- ``move_slot``           — live cross-process rebalance of one hash
  slot under load (``storenode`` wire protocol);
- ``kill_shard_primary``  — SIGKILL one shard's primary store process;
  its wire replica's watchdog drains the journal FILE, promotes at the
  next fencing epoch, and every wire client re-homes by rotation.

The schedule is derived from the topology's seed, so a red run replays
identically (the ``make chaos`` precedent). Offsets are from the moment
the measured window opens (after the loadgens' ramp).
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import time
import urllib.error
import urllib.request

from .supervisor import Supervisor
from .topology import Topology

log = logging.getLogger("ai4e_tpu_torch.rig.chaos")


def build_timeline(topo: Topology) -> list[dict]:
    """The seeded fault schedule. Spread across the window so each fault's
    recovery is observable before the next lands; the primary kill goes
    last-but-one so the promoted replica serves real traffic for the rest
    of the window (including the post-move keyspace — the fence
    propagation path)."""
    rng = random.Random(topo.seed)
    window = max(8.0, topo.duration)
    gateway = rng.randrange(topo.gateways)
    d_shard = rng.randrange(topo.shards)
    dispatcher = rng.randrange(topo.dispatchers)
    kill_shard = rng.randrange(topo.shards)
    # Move a slot OFF the shard whose primary dies later: the promoted
    # replica must respect a fence flip it only heard about via
    # propagation — the exact cross-process window this rig exists to
    # exercise.
    src_shard = kill_shard
    dest_shard = (src_shard + 1) % topo.shards if topo.shards > 1 else None
    slot = rng.choice([s for s in range(topo.slots)
                       if s % topo.shards == src_shard])
    events = [
        {"at": round(window * 0.15, 1), "verb": "kill_gateway",
         "gateway": gateway},
        {"at": round(window * 0.35, 1), "verb": "kill_dispatcher",
         "shard": d_shard, "dispatcher": dispatcher,
         "respawn_after": 3.0},
    ]
    if dest_shard is not None:
        events.append({"at": round(window * 0.55, 1), "verb": "move_slot",
                       "slot": slot, "src": src_shard, "dest": dest_shard})
    if topo.replicas >= 1:
        events.append({"at": round(window * 0.7, 1),
                       "verb": "kill_shard_primary", "shard": kill_shard})
    return events


async def run_timeline(topo: Topology, sup: Supervisor,
                       events: list[dict], window_opens_at: float) -> None:
    """Execute the schedule against the live rig; stamps each event with
    the wall-clock ``t`` it actually fired at (the goodput curve joins on
    these)."""
    for event in sorted(events, key=lambda e: e["at"]):
        delay = window_opens_at + event["at"] - time.time()
        if delay > 0:
            await asyncio.sleep(delay)
        event["t"] = round(time.time(), 2)
        try:
            await _fire(topo, sup, event)
            event["ok"] = True
        except Exception as exc:  # noqa: BLE001 — a failed injection must not abort the run; it is recorded in the artifact
            log.exception("chaos verb %s failed", event["verb"])
            event["ok"] = False
            event["error"] = repr(exc)


async def _fire(topo: Topology, sup: Supervisor, event: dict) -> None:
    verb = event["verb"]
    if verb == "kill_gateway":
        pid = sup.kill(f"gateway{event['gateway']}")
        log.warning("chaos: SIGKILLed gateway%d (pid %d)",
                    event["gateway"], pid)
    elif verb == "kill_dispatcher":
        name = f"dispatcher{event['shard']}.{event['dispatcher']}"
        pid = sup.kill(name)
        log.warning("chaos: SIGKILLed %s (pid %d); respawning in %.1fs",
                    name, pid, event["respawn_after"])
        await asyncio.sleep(event["respawn_after"])
        sup.respawn(name)
        event["respawned_t"] = round(time.time(), 2)
    elif verb == "move_slot":
        url = (topo.shard_urls(event["src"])[0] + "/v1/rig/move_slot")
        body = json.dumps({"slot": event["slot"],
                           "dest": event["dest"]}).encode()

        def post() -> dict:
            req = urllib.request.Request(
                url, data=body, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as exc:
                # A refused move is a chaos OUTCOME, not a driver crash:
                # 409 = the slot is already mid-handoff (fence held by a
                # previous move), 503 = the source node is not primary /
                # draining. Either way the schedule continues.
                exc.read()
                if exc.code in (409, 503):
                    return {"refused": exc.code}
                raise

        result = await asyncio.to_thread(post)
        if "refused" in result:
            event["refused"] = result["refused"]
            log.warning("chaos: move_slot %d shard %d -> %d refused "
                        "(HTTP %s); schedule continues",
                        event["slot"], event["src"], event["dest"],
                        result["refused"])
        else:
            event["moved"] = result.get("moved")
            log.warning("chaos: moved slot %d shard %d -> %d (%s tasks)",
                        event["slot"], event["src"], event["dest"],
                        result.get("moved"))
    elif verb == "kill_shard_primary":
        pid = sup.kill(f"store{event['shard']}")
        log.warning("chaos: SIGKILLed shard %d primary (pid %d); replica "
                    "watchdog owns the failover now", event["shard"], pid)
    else:
        raise ValueError(f"unknown chaos verb {verb!r}")
