"""The port's sharded task store (``ai4e_tpu_torch/taskstore/sharding.py``,
``feed.py``, the store's write fence, export/import and forget, the
reaper's per-shard scan, the broker's sub-queues, the store surface's 409
and ``/v1/taskstore/shards``, the platform's sharded assembly) held
against the JAX package's on the CPU.

Exact comparisons throughout (no tolerance applies): ``stable_hash`` and
the slot tables; one script of creates, transitions, inline, offloaded and
stage results, two live slot moves, a shard primary's kill and promotion,
a redrive, an eviction and a memory-only cache hit, run on both facades
under a frozen clock, writes byte-equal journals for every shard primary
and replica (the moves' full records, ``Evict`` + ``KeepBlobs`` records and
the promotion's epoch included), equal blob directories, equal topologies
and equal records; each package's shard journals replay in the other's
store. Then the facade's behaviour, each scenario on both packages with
equal observations: failover with zero loss and its wiring, the fence,
re-routes across an ownership flip, records that do not migrate, the
change feed, the per-shard reaper, the assembly's refusals (text-equal),
a sharded platform end to end with long polls, the replica link over
HTTP across the packages, and the move-slot and feed-attach interleavings
through JAX's ``explore_interleavings``. Every journaled store gets a
registry of its own."""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

import ai4e_tpu.platform_assembly as jax_pa
import ai4e_tpu.taskstore.feed as jax_feed
import ai4e_tpu.taskstore.http as jax_http
import ai4e_tpu.taskstore.reaper as jax_reaper
import ai4e_tpu.taskstore.results as jax_results
import ai4e_tpu.taskstore.sharding as jax_sharding
import ai4e_tpu.taskstore.store as jax_store
import ai4e_tpu.taskstore.task as jax_task
import ai4e_tpu_torch.platform_assembly as port_pa
import ai4e_tpu_torch.taskstore.feed as port_feed
import ai4e_tpu_torch.taskstore.http as port_http
import ai4e_tpu_torch.taskstore.reaper as port_reaper
import ai4e_tpu_torch.taskstore.results as port_results
import ai4e_tpu_torch.taskstore.sharding as port_sharding
import ai4e_tpu_torch.taskstore.store as port_store
import ai4e_tpu_torch.taskstore.task as port_task
from ai4e_tpu.analysis.race import explore_interleavings, yield_point
from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu_torch.broker.queue import (InMemoryBroker, base_queue_name,
                                         shard_queue_name)
from ai4e_tpu_torch.metrics import MetricsRegistry as PortRegistry

ROOT = Path(__file__).resolve().parent.parent
JAX = types.SimpleNamespace(
    name="jax", sharding=jax_sharding, store=jax_store, task=jax_task,
    results=jax_results, feed=jax_feed, reaper=jax_reaper, http=jax_http,
    pa=jax_pa, Registry=JaxRegistry)
PORT = types.SimpleNamespace(
    name="port", sharding=port_sharding, store=port_store, task=port_task,
    results=port_results, feed=port_feed, reaper=port_reaper,
    http=port_http, pa=port_pa, Registry=PortRegistry)
NS = {"jax": JAX, "port": PORT}
OFFLOAD_AT = 64        # result bytes at or over this go to the backend
SEED = 20260803        # the interleaving explorer's, as in JAX's regression
SCHEDULES = 60


def run(coro):
    return asyncio.run(coro)


def both(scenario, *args, **kw) -> dict:
    """``scenario(ns, ...)`` on each package; asserts equal observations
    and returns the port's."""
    seen = {name: scenario(ns, *args, **kw) for name, ns in NS.items()}
    assert seen["port"] == seen["jax"]
    return seen["port"]


def own_dir(tmp_path, ns) -> Path:
    """A directory of ``tmp_path`` for one package's files."""
    d = tmp_path / ns.name
    d.mkdir(exist_ok=True)
    return d


def make_sharded(ns, tmp_path=None, shards=4, replicas=1, **kw):
    journal = str(tmp_path / "journal") if tmp_path is not None else None
    if journal is not None:
        kw.setdefault("metrics", ns.Registry())
        kw.setdefault("fsync", "never")
    return ns.sharding.ShardedTaskStore(
        shards, journal_path=journal, replicas=replicas if journal else 0,
        **kw)


def accept(ns, store, n=20, endpoint="/v1/x/op", body=b"payload",
           prefix="t"):
    """``n`` published tasks with explicit TaskIds (the ids decide the
    shards, so both packages place them alike)."""
    return [store.upsert(ns.task.APITask(
        task_id=f"{prefix}{i:03d}", endpoint=endpoint, body=body,
        publish=True)).task_id for i in range(n)]


def raised(fn, *args, **kw):
    """``("ok", value)`` or ``(exception class name, message)``."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as exc:  # noqa: BLE001 — the outcome is the observation
        return (type(exc).__name__, str(exc))


def record(task) -> dict:
    return {**task.to_dict(), "body": task.body.hex()}


def store_state(store) -> dict:
    """What one shard store holds: durable records, sets, results, bodies
    and epoch."""
    with store._lock:
        tasks = {tid: record(t) for tid, t in store._tasks.items()
                 if t.durable}
        return {
            "tasks": tasks,
            "sets": {f"{p}|{s}": dict(m) for (p, s), m in
                     store._sets.items() if m},
            "results": {k: (v[0].hex() if v[0] is not None else None, v[1])
                        for k, v in store._results.items()},
            "orig": {k: (v[0].hex(), v[1])
                     for k, v in store._orig_bodies.items()},
            "epoch": getattr(store, "epoch", 0),
        }


class FrozenClock:
    def __init__(self, start: float = 1_700_000_000.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def tick(self, s: float = 1.0) -> None:
        self.now += s


# -- the ring -----------------------------------------------------------------


def test_stable_hash_and_slot_tables_equal_jax():
    rng = np.random.default_rng(7)
    ids = ([f"task-{i}" for i in range(300)]
           + [rng.bytes(int(rng.integers(0, 24))).hex() for _ in range(300)]
           + ["", "é✓", "a:b", "root~stage", port_task.new_task_id()])
    for tid in ids:
        assert (port_sharding.stable_hash(tid)
                == jax_sharding.stable_hash(tid))
    for shards, slots in ((1, 1), (2, 8), (4, 64), (5, 61), (8, 128)):
        rings = {name: ns.sharding.ShardRing(shards, slots=slots)
                 for name, ns in NS.items()}
        moves = np.random.default_rng(shards).integers(0, slots, 12)
        for k, slot in enumerate(moves):
            for ring in rings.values():
                ring.assign(int(slot), (int(slot) + k) % shards)
        got, want = rings["port"], rings["jax"]
        assert got.assignments() == want.assignments()
        assert got.version == want.version == len(moves)
        assert [got.slot_for(t) for t in ids] == [want.slot_for(t)
                                                 for t in ids]
        assert [got.shard_for(t) for t in ids] == [want.shard_for(t)
                                                  for t in ids]
        assert ([got.slots_of(s) for s in range(shards)]
                == [want.slots_of(s) for s in range(shards)])


@pytest.mark.parametrize("args", [((0,), {}), ((8,), {"slots": 4}),
                                  ((2,), {"slots": 8}, 0, 5)],
                         ids=["no-shards", "too-few-slots", "bad-assign"])
def test_ring_bounds_refuse_with_jax_s_text(args):
    def outcome(ns):
        ctor, kw, *assign = args

        def go():
            ring = ns.sharding.ShardRing(*ctor, **kw)
            if assign:
                ring.assign(*assign)
        return raised(go)

    assert both(outcome)[0] == "ValueError"


# -- one script, byte-equal journals ------------------------------------------


def sharded_script(ns, tmp_path, clock: FrozenClock) -> dict:
    """Creates, transitions, results (inline, offloaded, a stage's), two
    live slot moves, a shard primary killed and promoted by the next
    write, a redrive, an eviction and a cache hit; returns what the
    facade and its files hold afterwards."""
    APITask = ns.task.APITask
    backend = ns.results.FileResultBackend(str(tmp_path / "blobs"))
    store = make_sharded(ns, tmp_path, result_backend=backend,
                         result_offload_threshold=OFFLOAD_AT)
    published, events = [], []
    store.set_publisher(lambda t: published.append(t.task_id))
    store.add_listener(lambda t: events.append((t.task_id, t.status)))
    rng = np.random.default_rng(3)
    ids = [f"s{i:02d}" for i in range(24)]
    for i, tid in enumerate(ids):
        clock.tick()
        store.upsert(APITask(
            task_id=tid, endpoint=("http://w:1/v1/landcover/classify"
                                   + ("?tile=1" if i % 3 == 0 else "")),
            body=rng.bytes(16 + i), content_type="application/octet-stream",
            cache_key=f"k{i}" if i % 2 else "", priority=1 + i % 2,
            deadline_at=1_800_000_000.0 if i % 4 == 0 else 0.0,
            publish=True))
    for tid in ids[:16]:
        clock.tick(0.25)
        store.update_status(tid, "running", "running")
    for i, tid in enumerate(ids[:10]):
        clock.tick(0.25)
        store.update_status(tid, "completed - class_histogram", "completed")
        if i % 3 == 2:
            store.set_result(tid, rng.bytes(OFFLOAD_AT + i),
                             content_type="application/octet-stream")
        else:
            store.set_result(tid, json.dumps({"i": i}).encode())
    store.set_result(ids[10], rng.bytes(OFFLOAD_AT + 1), stage="detector")
    store.set_result(ids[11], b'{"stage": 1}', stage="detector")
    store.append_ledger(ids[0], [{"e": "admitted", "t": 1.0}])
    moves = []
    for tid in (ids[2], ids[11]):
        clock.tick()
        slot = store.ring.slot_for(tid)
        src = store.ring.shard_of_slot(slot)
        moves.append((slot, src, store.move_slot(slot, (src + 1) % 4)))
    victim = store.shard_for(ids[12])
    store.kill_shard_primary(victim)
    clock.tick()
    store.update_status(ids[12], "completed - after kill", "completed")
    store.set_result(ids[12], b'{"after": "kill"}')
    clock.tick()
    store.update_status(ids[13], "failed - boom", "failed")
    assert store.requeue_if(ids[13], "failed") is not None
    clock.tick(100.0)
    store.update_status(ids[14], "completed - late", "completed")
    evicted = store.evict_terminal_older_than(50.0)
    store.upsert(APITask(
        task_id="hit", endpoint="http://w:1/v1/landcover/classify",
        body=b"x", status="completed - served from cache",
        backend_status="completed", cache_key="k1", durable=False))
    store.set_result("hit", b'{"cached": 1}')
    topology = store.topology()
    for g in topology["groups"]:
        g["journal"] = os.path.basename(g["journal"])
    out = {
        "moves": moves, "victim": victim, "evicted": evicted,
        "published": published, "events": events, "topology": topology,
        "stats": {k: v for k, v in store.journal_stats().items()
                  if not k.startswith("append_")},
        "records": {t.task_id: record(t) for t in store.snapshot()},
        "results": {tid: store.get_result(tid) for tid in ids + ["hit"]},
        "stages": {tid: store.get_result(tid, stage="detector")
                   for tid in ids[10:12]},
        "ledger": store.get_ledger(ids[0]),
        "unfinished": sorted(t.task_id for t in store.unfinished_tasks()),
        "depths": store.depths(),
        "replayed": sorted(store.replayed_task_ids),
    }
    store.close()
    out["files"] = {p.name: p.read_bytes()
                    for p in sorted(tmp_path.glob("journal.*"))}
    out["blobs"] = sorted(p.name for p in (tmp_path / "blobs").iterdir())
    return out


@pytest.fixture()
def scripted(tmp_path, monkeypatch):
    clock = FrozenClock()
    monkeypatch.setattr(time, "time", clock)
    out = {}
    for name, ns in NS.items():
        clock.now = 1_700_000_000.0
        d = tmp_path / name
        d.mkdir()
        out[name] = sharded_script(ns, d, clock)
    monkeypatch.undo()
    return out, tmp_path


def test_same_script_writes_byte_equal_shard_journals(scripted):
    out, _ = scripted
    port, want = out["port"], out["jax"]
    assert sorted(port["files"]) == sorted(want["files"]) == sorted(
        [f"journal.shard{i}" for i in range(4)]
        + [f"journal.shard{i}.replica0" for i in range(4)])
    for name, data in want["files"].items():
        assert port["files"][name] == data, name
    allbytes = b"".join(want["files"].values())
    # The moves' import and forget records and the promotion's epoch.
    assert b'"KeepBlobs": true' in allbytes
    assert b'"Evict": true' in allbytes
    assert b'"Offloaded": true' in allbytes
    assert (b'"Epoch": 1' in
            want["files"][f"journal.shard{want['victim']}.replica0"])
    for key in want:
        if key != "files":
            assert port[key] == want[key], key
    assert all(n >= 1 for _, _, n in want["moves"])
    assert want["topology"]["groups"][want["victim"]]["epoch"] == 1
    assert want["results"]["hit"] == (b'{"cached": 1}', "application/json")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_replays_the_others_shard_journals(scripted, writer):
    out, tmp_path = scripted
    src = tmp_path / writer
    states = {}
    for reader, ns in NS.items():
        d = tmp_path / f"{writer}-by-{reader}"
        shutil.copytree(src, d)
        backend = ns.results.FileResultBackend(str(d / "blobs"))
        states[reader] = {}
        for path in sorted(d.glob("journal.*")):
            store = ns.store.FollowerTaskStore(
                str(path), start_as_primary=True, result_backend=backend,
                result_offload_threshold=OFFLOAD_AT, fsync="never",
                metrics=ns.Registry())
            states[reader][path.name] = (store_state(store),
                                         store.chain_head,
                                         sorted(store.replayed_task_ids))
            store.close()
    assert states["port"] == states["jax"]
    # Each live shard's journal replays to what the facade served: the
    # moved range on its new owner and forgotten on its old one.
    victim = out[writer]["victim"]
    live = {}
    for i in range(4):
        name = (f"journal.shard{i}.replica0" if i == victim
                else f"journal.shard{i}")
        live.update(states["port"][name][0]["tasks"])
    want = {tid: rec for tid, rec in out[writer]["records"].items()
            if tid != "hit"}
    assert {tid: rec["TaskId"] for tid, rec in live.items()} == {
        tid: tid for tid in want}


# -- the facade's behaviour, on both packages -----------------------------------


def crud_and_fan_in(ns):
    store = make_sharded(ns)
    events, published = [], []
    store.add_listener(lambda t: events.append((t.task_id,
                                                t.canonical_status)))
    store.set_publisher(lambda t: published.append(t.task_id))
    ids = accept(ns, store, 20)
    owners = {tid: store.shard_for(tid) for tid in ids}
    placed = all(store.groups[owners[tid]].active.get(tid).task_id == tid
                 for tid in ids)
    for tid in ids[:5]:
        store.update_status(tid, "completed - ok", "completed")
        store.set_result(tid, b"RES", "text/plain")
    seen = {"events": list(events), "published": list(published)}
    fresh = store.upsert(ns.task.APITask(endpoint="/v1/x"))
    return {"owners": owners, "placed": placed, **seen,
            "results": [store.get_result(t) for t in ids[:6]],
            "created": store.set_len("/v1/x/op", "created"),
            "endpoints": store.endpoints(), "depths": store.depths(),
            "snapshot": len(list(store.snapshot())),
            "unfinished": len(store.unfinished_tasks()),
            "members": sorted(store.set_members("/v1/x/op", "completed")),
            "minted": store.get(fresh.task_id).task_id == fresh.task_id
            and bool(fresh.task_id)}


def test_verbs_route_by_ring_and_side_effects_fan_in():
    seen = both(crud_and_fan_in)
    assert len(set(seen["owners"].values())) == 4 and seen["placed"]
    assert len(seen["published"]) == 20
    assert [e for e in seen["events"] if e[1] == "completed"] == [
        (f"t{i:03d}", "completed") for i in range(5)]
    assert seen["created"] == 15 and seen["unfinished"] == 16


def test_an_in_process_task_manager_sees_the_facade_s_publisher():
    from ai4e_tpu_torch.service.task_manager import LocalTaskManager

    store = port_sharding.ShardedTaskStore(2)
    manager = LocalTaskManager(store)
    assert manager.redelivers is False
    store.set_publisher(lambda task: None)
    assert manager.redelivers is True


def conditional_verbs(ns):
    store = make_sharded(ns)
    [tid] = accept(ns, store, 1)
    out = [store.update_status_if(tid, "running", "x")]
    store.update_status(tid, "completed", "completed")
    requeued = store.requeue_if(tid, "completed")
    out += [requeued.body, store.get_original_body(tid),
            store.get_original_body("nope")]
    return out


def test_conditional_verbs_and_original_body_replay():
    assert both(conditional_verbs) == [None, b"payload", b"payload", b""]


def kill_then_write(ns, tmp_path):
    store = make_sharded(ns, own_dir(tmp_path, ns))
    events, published = [], []
    store.add_listener(lambda t: events.append(t.canonical_status))
    store.set_publisher(lambda t: published.append(t.task_id))
    ids = accept(ns, store, 30)
    for tid in ids[:10]:
        store.update_status(tid, "completed", "completed")
        store.set_result(tid, b"R", "text/plain")
    before = {tid: record(store.get(tid)) for tid in ids}
    victim = store.shard_for(ids[10])
    pre_epoch = store.groups[victim].epoch
    store.kill_shard_primary(victim)
    dead = store.groups[victim].dead
    n_events = len(events)
    task = store.update_status(ids[10], "completed", "completed")
    after = {tid: record(store.get(tid)) for tid in ids if tid != ids[10]}
    n_pub = len(published)
    again = store.requeue_if(ids[10], "completed") is not None
    out = {"dead": dead, "status": task.canonical_status,
           "epochs": (pre_epoch, store.groups[victim].epoch),
           "kept": all(after[t] == before[t] for t in after),
           "results": [store.get_result(t) for t in ids[:10]],
           "new_events": events[n_events:],
           "republished": again and len(published) == n_pub + 1,
           "promoted_role": store.groups[victim].active.role}
    store.close()
    return out


def test_kill_then_write_promotes_a_replica_with_zero_loss(tmp_path):
    seen = both(kill_then_write, tmp_path)
    assert seen["dead"] and seen["status"] == "completed"
    assert seen["epochs"] == (0, 1) and seen["kept"]
    assert seen["results"] == [(b"R", "text/plain")] * 10
    # The listener relay and the publisher rewired onto the promoted store.
    assert seen["new_events"] == ["completed", "created"]
    assert seen["republished"] and seen["promoted_role"] == "primary"


def dead_without_replica(ns):
    store = make_sharded(ns)
    [tid] = accept(ns, store, 1)
    store.kill_shard_primary(store.shard_for(tid))
    return (raised(store.update_status, tid, "completed", "completed"),
            raised(store.get, tid)[0])


def test_a_dead_shard_without_a_replica_fails_loudly():
    (kind, text), read = both(dead_without_replica)
    assert kind == "StoreClosedError" and "no promotable replica" in text
    assert read == "StoreClosedError"


def victim_setup(ns, tmp_path=None, **kw):
    store = make_sharded(ns, tmp_path, **kw)
    ids = accept(ns, store, 30)
    tid = ids[0]
    slot = store.ring.slot_for(tid)
    src = store.ring.shard_of_slot(slot)
    return store, ids, tid, slot, src, (src + 1) % store.ring.shards


def move_migrates(ns, tmp_path):
    store, ids, tid, slot, src, dest = victim_setup(
        ns, own_dir(tmp_path, ns))
    store.update_status(tid, "running", "running")
    store.set_result(tid, b"partial", "text/plain", stage="s1")
    old_owner = store.groups[src].active
    moved = store.move_slot(slot, dest)
    out = {"moved": moved, "owner": store.shard_for(tid) == dest,
           "status": store.get(tid).canonical_status,
           "stage": store.get_result(tid, stage="s1"),
           "body": store.get_original_body(tid),
           "forgotten": raised(old_owner.get, tid)[0],
           "stale_upsert": raised(old_owner.upsert, ns.task.APITask(
               task_id=tid, endpoint="/v1/x/op", body=b"zz")),
           "stale_result": raised(old_owner.set_result, tid, b"stale")[0],
           "stale_update": raised(old_owner.update_status, tid, "x")[0],
           "stale_ledger": raised(old_owner.append_ledger, tid, [])[0]}
    store.update_status(tid, "completed", "completed")
    out["landed"] = store.groups[dest].active.get(tid).canonical_status
    ts = store.get(tid).timestamp
    journal = store.groups[dest].journal_path
    store.close()
    restarted = ns.store.FollowerTaskStore(journal, start_as_primary=True,
                                           metrics=ns.Registry())
    out["restart"] = (restarted.get(tid).canonical_status,
                      restarted.get(tid).timestamp == ts)
    restarted.close()
    return out


def test_move_slot_migrates_and_fences_the_stale_owner(tmp_path):
    seen = both(move_migrates, tmp_path)
    assert seen["moved"] >= 1 and seen["owner"]
    assert seen["status"] == "running"
    assert seen["stage"] == (b"partial", "text/plain")
    assert seen["body"] == b"payload"
    assert seen["forgotten"] == "TaskNotFound"
    assert seen["stale_upsert"][0] == "NotOwnerError"
    assert "no longer owned by this shard" in seen["stale_upsert"][1]
    # The record is gone from the old owner: a result finds no task.
    assert seen["stale_result"] == "TaskNotFound"
    assert seen["stale_update"] == "NotOwnerError"
    assert seen["stale_ledger"] == "NotOwnerError"
    assert seen["landed"] == "completed"
    assert seen["restart"] == ("completed", True)


def source_keeps_blobs(ns, tmp_path):
    d = own_dir(tmp_path, ns)
    backend = ns.results.FileResultBackend(str(d / "blobs"))
    store = make_sharded(ns, d, result_backend=backend,
                         result_offload_threshold=1)
    [tid] = accept(ns, store, 1)
    store.set_result(tid, b"BLOBBY", "text/plain")
    slot = store.ring.slot_for(tid)
    src = store.ring.shard_of_slot(slot)
    src_path = store.groups[src].journal_path
    store.move_slot(slot, (src + 1) % 4)
    out = [store.get_result(tid)]
    store.groups[src].active.close()
    replayed = ns.store.FollowerTaskStore(
        src_path, start_as_primary=True, result_backend=backend,
        result_offload_threshold=1, metrics=ns.Registry())
    out += [raised(replayed.get, tid)[0], store.get_result(tid)]
    replayed.close()
    store.close()
    return out


def test_a_source_replay_keeps_the_moved_range_s_blobs(tmp_path):
    assert both(source_keeps_blobs, tmp_path) == [
        (b"BLOBBY", "text/plain"), "TaskNotFound", (b"BLOBBY", "text/plain")]


def nondurable(ns):
    store = make_sharded(ns)
    task = store.upsert(ns.task.APITask(
        task_id="hit0", endpoint="/v1/x",
        status="completed - served from cache",
        backend_status="completed", durable=False))
    slot = store.ring.slot_for(task.task_id)
    src = store.ring.shard_of_slot(slot)
    moved = store.move_slot(slot, (src + 1) % 4)
    return moved, raised(store.get, task.task_id)[0]


def test_non_durable_records_do_not_migrate():
    # Counted as moved with its slot, but never exported.
    assert both(nondurable) == (1, "TaskNotFound")


def flip_mid_call(ns, verb: str):
    store, ids, tid, slot, src, dest = victim_setup(ns)
    store.set_result(tid, b"R", "text/plain")
    src_store = store.groups[src].active
    real = getattr(src_store, verb)
    fired = []

    def racing(*args, **kw):
        if not fired:
            fired.append(1)
            store.move_slot(slot, dest)  # the flip lands mid-call
        return real(*args, **kw)

    setattr(src_store, verb, racing)
    if verb == "get":
        return store.get(tid).task_id
    if verb == "get_result":
        return store.get_result(tid)
    return store.get_original_body(tid)


@pytest.mark.parametrize("verb,want", [
    ("get", "t000"), ("get_result", (b"R", "text/plain")),
    ("get_original_body", b"payload")])
def test_a_miss_during_an_ownership_flip_is_rerouted(verb, want):
    assert both(flip_mid_call, verb) == want


def evicted_between_phases(ns, tmp_path):
    store, ids, tid, slot, src, dest = victim_setup(
        ns, own_dir(tmp_path, ns))
    store.update_status(tid, "completed", "completed")
    src_store = store.groups[src].active
    real = src_store.export_task_records
    fired = []

    def racing_export(task_ids):
        recs = real(task_ids)
        if not fired and any(r.get("TaskId") == tid for r in recs):
            fired.append(1)
            src_store.evict_terminal_older_than(-1.0)
        return recs

    src_store.export_task_records = racing_export
    store.move_slot(slot, dest)
    out = (raised(store.get, tid)[0],
           tid in store.groups[dest].active._tasks)
    store.close()
    return out


def test_a_task_evicted_between_the_phases_does_not_resurrect(tmp_path):
    assert both(evicted_between_phases, tmp_path) == ("TaskNotFound", False)


def failover_mid_move(ns, tmp_path):
    store, ids, tid, slot, src, dest = victim_setup(
        ns, own_dir(tmp_path, ns))
    src_store = store.groups[src].active
    real = src_store.export_task_records
    fired = []

    def racing_export(task_ids):
        recs = real(task_ids)
        if not fired:
            fired.append(1)
            store.kill_shard_primary(src)
            store.update_status(tid, "completed - after kill", "completed")
        return recs

    src_store.export_task_records = racing_export
    moved = store.move_slot(slot, dest)
    out = (moved >= 1, store.shard_for(tid) == dest, store.get(tid).status,
           store.groups[src].epoch)
    store.close()
    return out


def test_a_failover_mid_move_keeps_the_promoted_store_s_writes(tmp_path):
    assert both(failover_mid_move, tmp_path) == (
        True, True, "completed - after kill", 1)


def round_trip(ns):
    store = make_sharded(ns)
    [tid] = accept(ns, store, 1)
    store.update_status(tid, "completed - run 1", "completed")
    slot = store.ring.slot_for(tid)
    a = store.ring.shard_of_slot(slot)
    b = (a + 1) % store.ring.shards
    out = [store.feeds[a].recent_terminal(tid) is not None]
    store.move_slot(slot, b)
    out.append(store.feeds[a].recent_terminal(tid) is None)
    out.append(store.requeue_if(tid, "completed") is not None)
    store.move_slot(slot, a)

    async def wait():
        return await store.feed_for(tid).wait_terminal(tid, 0.05)

    out.append(run(wait()))
    out.append((store.move_slot(slot, a), store.ring.version))
    return out


def test_a_round_trip_move_does_not_replay_a_stale_terminal():
    assert both(round_trip) == [True, True, True, None, (0, 2)]


# -- the change feed -----------------------------------------------------------


def feed_sequence(ns):
    APITask = ns.task.APITask
    feed = ns.feed.ShardChangeFeed(3, recent=4)

    async def main():
        out = []
        waiter = asyncio.ensure_future(feed.wait_terminal("w", 5.0))
        await asyncio.sleep(0)
        out.append(feed.watcher_count)
        feed.publish(APITask(task_id="w", endpoint="/v1/x",
                             status="running", backend_status="running"))
        feed.publish(APITask(task_id="w", endpoint="/v1/x", body=b"x" * 99,
                             status="completed", backend_status="completed"))
        got = await waiter
        out += [got.status, got.body, feed.watcher_count]
        # Before attach: replayed. Non-terminal: ignored, times out.
        out.append((await feed.wait_terminal("w", 0.01)).status)
        feed.publish(APITask(task_id="r", endpoint="/v1/x",
                             status="running", backend_status="running"))
        out.append(await feed.wait_terminal("r", 0.01))
        for i in range(6):
            feed.publish(APITask(task_id=f"b{i}", endpoint="/v1/x",
                                 status="failed - x",
                                 backend_status="failed"))
        out.append([feed.recent_terminal(f"b{i}") is not None
                    for i in range(6)])
        feed.invalidate({"b5", "nope"})
        # A task that runs again drops its replay entry.
        feed.publish(APITask(task_id="b4", endpoint="/v1/x",
                             status="created", backend_status="created"))
        out += [feed.recent_terminal("b5"), feed.recent_terminal("b4"),
                feed.seq, feed.shard_index, feed.watcher_count]
        return out

    return run(main())


def test_the_change_feed_replays_bounds_and_invalidates_like_jax():
    seen = both(feed_sequence)
    assert seen == [1, "completed", b"", 0, "completed", None,
                    [False, False, True, True, True, True], None, None, 7,
                    3, 0]


def owning_feed(ns):
    store = make_sharded(ns)
    [tid] = accept(ns, store, 1)
    store.update_status(tid, "completed", "completed")
    owner = store.shard_for(tid)
    record = store.feed_for(tid).recent_terminal(tid)
    return ([f.recent_terminal(tid) is not None for f in store.feeds],
            owner, record.body, "Body" in record.to_dict())


def test_terminal_events_reach_the_owning_shard_s_feed():
    hits, owner, body, has_body = both(owning_feed)
    assert hits == [i == owner for i in range(4)]
    assert body == b"" and not has_body


# -- the reaper -----------------------------------------------------------------


def sharded_reaper(ns):
    async def main():
        store = make_sharded(ns)
        published = []
        store.set_publisher(lambda t: published.append(t.task_id))
        ids = accept(ns, store, 12)
        for tid in ids:
            store.update_status(tid, "running", "running")
        for g in store.groups:
            for task in g.active.snapshot():
                task.timestamp -= 100.0
        # A reaper serving one shard skips a task whose slot moved away.
        tid = ids[0]
        src = store.shard_for(tid)
        old_owner = store.groups[src].active
        mine = ns.reaper.TaskReaper(
            store, running_timeout=1.0,
            owns=lambda t, _s=src: store.shard_for(t) == _s,
            metrics=ns.Registry())
        store.move_slot(store.ring.slot_for(tid), (src + 1) % 4)
        published.clear()
        own_acted = await mine.sweep()
        stale = (old_owner.requeue_if(tid, "running"),
                 raised(old_owner.upsert, ns.task.APITask(
                     task_id=tid, endpoint="/v1/x/op"))[0])
        whole = ns.reaper.TaskReaper(store, running_timeout=1.0,
                                     metrics=ns.Registry())
        acted = await whole.sweep()
        return (own_acted, stale, acted, sorted(published),
                sorted(store.get(t).canonical_status for t in ids))

    return run(main())


def test_the_reaper_scans_per_shard_and_skips_a_moved_task():
    own, stale, acted, published, statuses = both(sharded_reaper)
    assert stale == (None, "NotOwnerError")
    # The one-shard reaper rescued its shard's tasks but not the moved one;
    # the facade's reaper rescued the rest, each through the ring.
    assert own + acted == 12 and own < 12
    assert len(published) == 12 and statuses == ["created"] * 12


# -- the assembly -------------------------------------------------------------


def test_an_unsharded_platform_keeps_its_store_and_broker():
    platform = port_pa.LocalPlatform(port_pa.PlatformConfig(),
                                     metrics=PortRegistry())
    assert not isinstance(platform.store, port_sharding.ShardedTaskStore)
    assert platform.broker._shard_router is None


@pytest.mark.parametrize("fields", [
    {"native_store": True}, {"native_broker": True},
    {"replicate_from": "http://p"},
    {"replicate_from": "http://p", "journal_path": "J"},
    {"autoscale": True}, {}],
    ids=["native-store", "native-broker", "replicate-from",
         "replicate-from-journaled", "autoscale", "none"])
def test_the_sharded_assembly_refuses_with_jax_s_text(fields, tmp_path):
    def outcome(ns):
        kw = dict(fields)
        autoscale = kw.pop("autoscale", False)
        if kw.get("journal_path"):
            kw["journal_path"] = str(own_dir(tmp_path, ns) / "j")

        def go():
            platform = ns.pa.LocalPlatform(
                ns.pa.PlatformConfig(task_shards=2, **kw),
                metrics=ns.Registry())
            policy = None
            if autoscale:
                from ai4e_tpu.scaling import AutoscalePolicy as JaxPolicy
                from ai4e_tpu_torch.scaling import AutoscalePolicy
                policy = (JaxPolicy if ns is JAX else AutoscalePolicy)(
                    max_replicas=4)
            platform.publish_async_api("/v1/pub/x", "http://w/v1/be/x",
                                       autoscale=policy)
            return sorted(platform.dispatchers.dispatchers)
        return raised(go)

    kind, value = both(outcome)
    if fields:
        assert kind == "ValueError"
    else:
        assert value == [f"/v1/be/x#s{i}" for i in range(2)]


def test_the_broker_puts_each_task_on_its_shard_s_sub_queue():
    async def main():
        store = port_sharding.ShardedTaskStore(4)
        broker = InMemoryBroker(shard_router=store.shard_for,
                                metrics=PortRegistry())
        broker.bind_loop(asyncio.get_running_loop())
        broker.register_queue("/v1/be/x")
        store.set_publisher(broker.publish)
        ids = accept(PORT, store, 16, endpoint="http://w/v1/be/x/op")
        got = {}
        for i in range(4):
            name = shard_queue_name("/v1/be/x", i)
            first = await broker.receive(name, timeout=0.01)
            broker.abandon(first)   # back onto its own sub-queue
            while True:
                msg = await broker.receive(name, timeout=0.01)
                if msg is None:
                    break
                got[msg.task_id] = (i, msg.queue_name)
                broker.complete(msg)
            assert got[first.task_id] == (i, name)
        assert got == {t: (store.shard_for(t),
                           f"/v1/be/x#s{store.shard_for(t)}") for t in ids}
        assert broker.resolve_queue_name("/v1/be/x/op") == "/v1/be/x"
        assert base_queue_name("/v1/be/x#s3") == "/v1/be/x"

    run(main())


async def serve(app) -> TestClient:
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


def test_a_sharded_platform_serves_end_to_end_with_long_polls(tmp_path):
    async def main():
        platform = port_pa.LocalPlatform(port_pa.PlatformConfig(
            task_shards=4, journal_path=str(tmp_path / "j"),
            retry_delay=0.01, lease_seconds=2.0, shard_tail_interval=0.02,
            taskstore_fsync="never"), metrics=PortRegistry())

        async def handler(request):
            tid = request.headers["taskId"]
            platform.store.update_status_if(
                tid, "created", "completed - ok", "completed")
            platform.store.set_result(tid, f'{{"id": "{tid}"}}'.encode())
            return web.Response(text="ok")

        app = web.Application()
        app.router.add_post("/v1/be/x", handler)
        be = await serve(app)
        platform.publish_async_api("/v1/pub/x", str(be.make_url("/v1/be/x")))
        port_http.make_app(platform.store, app=platform.gateway.app)
        gw = await serve(platform.gateway.app)
        await platform.start()
        try:
            assert sorted(platform.dispatchers.dispatchers) == [
                f"/v1/be/x#s{i}" for i in range(4)]
            assert len(platform.store._tail_tasks) == 4
            tids = []
            for _ in range(16):
                resp = await gw.post("/v1/pub/x", data=b"hello")
                assert resp.status == 200
                tids.append((await resp.json())["TaskId"])
            async def poll(t):
                resp = await gw.get(f"/v1/taskmanagement/task/{t}?wait=10")
                return await resp.json()

            bodies = await asyncio.gather(*(poll(t) for t in tids))
            assert all(b["Status"] == "completed - ok" for b in bodies)
            for t in tids:
                resp = await gw.get("/v1/taskstore/result",
                                    params={"taskId": t})
                assert json.loads(await resp.read()) == {"id": t}
            # The replicas catch up with their primaries.
            deadline = time.monotonic() + 10
            while True:
                topo = await (await gw.get("/v1/taskstore/shards")).json()
                if all(g["replica_chain_heads"] == [g["chain_head"]]
                       for g in topo["groups"]):
                    break
                assert time.monotonic() < deadline, topo
                await asyncio.sleep(0.02)
            assert topo["shards"] == 4 and len(topo["slots"]) == 64
            assert [g["shard"] for g in topo["groups"]] == [0, 1, 2, 3]
            assert sum(g["feed_seq"] for g in topo["groups"]) == 16
            keys = set(jax_sharding.ShardedTaskStore(2).topology()
                       ["groups"][0])
            assert set(topo["groups"][0]) == keys
        finally:
            await platform.stop()
            await gw.close()
            await be.close()
        assert platform.store._tail_tasks == []
        platform.store.close()
        # A restart re-seeds every shard's unfinished task through the
        # facade (none here: all completed) and keeps the results.
        again = port_pa.LocalPlatform(port_pa.PlatformConfig(
            task_shards=4, journal_path=str(tmp_path / "j"),
            taskstore_fsync="never"), metrics=PortRegistry())
        assert again.store.replayed_task_ids == set(tids)
        assert again.store.get_result(tids[0]) == (
            f'{{"id": "{tids[0]}"}}'.encode(), "application/json")
        again.store.close()

    run(main())


def stale_owner_over_http(ns):
    async def main():
        store = make_sharded(ns)
        [tid] = accept(ns, store, 1)
        slot = store.ring.slot_for(tid)
        src = store.ring.shard_of_slot(slot)
        old = store.groups[src].active
        store.move_slot(slot, (src + 1) % 4)
        client = await serve(ns.http.make_app(old))
        facade = await serve(ns.http.make_app(store))
        try:
            out = []
            for path, kw in (
                    ("/v1/taskstore/upsert",
                     {"json": {"TaskId": tid, "Endpoint": "/v1/x/op"}}),
                    ("/v1/taskstore/ledger",
                     {"json": {"TaskId": tid, "Events": []}})):
                resp = await client.post(path, **kw)
                out.append((resp.status, resp.headers.get("X-Not-Owner"),
                            await resp.json()))
            resp = await client.get("/v1/taskstore/shards")
            out.append(resp.status)
            resp = await facade.get("/v1/taskstore/shards")
            topo = await resp.json()
            out.append((resp.status, topo["version"], topo["slots"]))
            resp = await facade.post("/v1/taskstore/upsert", json={
                "TaskId": tid, "Endpoint": "/v1/x/op", "Status": "running",
                "BackendStatus": "running"})
            out.append((resp.status, (await resp.json())["Status"]))
            return out
        finally:
            await client.close()
            await facade.close()

    return run(main())


def test_a_stale_owner_answers_409_not_owner_over_http():
    seen = both(stale_owner_over_http)
    assert seen[0][:2] == (409, "1") and seen[1][:2] == (409, "1")
    assert seen[0][2]["error"].startswith("not owner: ")
    assert seen[2] == 404 and seen[3][0] == 200 and seen[3][1] == 1
    assert seen[4] == (200, "running")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_control_plane_names_its_shards_and_checksum(tmp_path):
    """The startup line says the store is sharded and which CRC-32C runs;
    SIGTERM stops the replica tails and closes every shard's journal."""
    (tmp_path / "routes.json").write_text(json.dumps({"apis": [
        {"prefix": "/v1/pub/x", "backend": "http://127.0.0.1:9/v1/be/x"}]}))
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           "AI4E_PLATFORM_TASK_SHARDS": "4",
           "AI4E_PLATFORM_JOURNAL_PATH": str(tmp_path / "j"),
           "AI4E_TASKSTORE_FSYNC": "never"}
    port = free_port()
    log_path = tmp_path / "cp.log"
    with open(log_path, "wb") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ai4e_tpu_torch", "control-plane",
             "--routes", str(tmp_path / "routes.json"), "--port", str(port)],
            stdout=fh, stderr=subprocess.STDOUT, env=env, cwd=tmp_path)
    try:
        deadline = time.monotonic() + 60
        while "control plane on" not in log_path.read_text():
            assert proc.poll() is None, log_path.read_text()
            assert time.monotonic() < deadline, log_path.read_text()
            time.sleep(0.05)
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    text = log_path.read_text()
    assert rc == 0, text
    line = next(x for x in text.splitlines() if "control plane on" in x)
    assert ", task store sharded x4" in line
    assert " fsync=never crc32c=native" in line
    assert "journal stats " in text
    assert sorted(p.name for p in tmp_path.glob("j.*")) == sorted(
        [f"j.shard{i}" for i in range(4)]
        + [f"j.shard{i}.replica0" for i in range(4)])


def test_the_checksum_names_the_loop_where_the_build_failed(monkeypatch):
    from ai4e_tpu_torch.taskstore import journal

    assert journal.crc32c_impl() == "native"
    monkeypatch.setattr(journal, "_NATIVE", [None])
    assert journal.crc32c_impl() == "python loop"
    assert journal.crc32c(b"123456789") == 0xE3069283


def test_replicas_absorb_while_the_primaries_serve(tmp_path):
    async def main():
        store = make_sharded(PORT, tmp_path, tail_interval=0.02)
        await store.start_replication()
        try:
            ids = accept(PORT, store, 16)
            for tid in ids[:8]:
                store.update_status(tid, "completed", "completed")
            deadline = time.monotonic() + 10
            while not all(g.links[0].standby.replica_chain_head
                          == g.active.chain_head for g in store.groups):
                assert time.monotonic() < deadline
                await asyncio.sleep(0.02)
            for g in store.groups:
                assert (store_state(g.links[0].standby)["tasks"]
                        == store_state(g.active)["tasks"])
        finally:
            await store.stop_replication()
            store.close()

    run(main())


def test_concurrent_writes_and_slot_moves_lose_no_update(tmp_path):
    """Writer threads (more than cores) transition their own tasks through
    the facade while another thread moves slots back and forth under a
    shortened switch interval: every task ends at its last write and
    result, on its ring owner alone."""
    import threading

    store = make_sharded(PORT, tmp_path)
    writers, rounds = 2 * (os.cpu_count() or 1) + 2, 25
    ids = {w: [f"w{w}-{i}" for i in range(4)] for w in range(writers)}
    for tids in ids.values():
        for tid in tids:
            store.upsert(port_task.APITask(task_id=tid, endpoint="/v1/x/op",
                                           body=b"b", publish=False))
    done = threading.Event()
    errors: list = []

    def write(w: int) -> None:
        try:
            for r in range(rounds):
                for tid in ids[w]:
                    # A full upsert, as a requeue writes one: on a stale
                    # owner without the fence it would re-create the task.
                    store.upsert(port_task.APITask(
                        task_id=tid, endpoint="/v1/x/op",
                        status=f"running {r}", backend_status="running",
                        publish=False))
                    store.set_result(tid, f"{tid} {r}".encode())
        except Exception as exc:  # noqa: BLE001 — reported by the test
            errors.append(exc)

    def move() -> None:
        rng = np.random.default_rng(1)
        try:
            while not done.is_set():
                slot = int(rng.integers(0, store.ring.slots))
                src = store.ring.shard_of_slot(slot)
                store.move_slot(slot, (src + 1 + int(rng.integers(0, 3))) % 4)
        except Exception as exc:  # noqa: BLE001 — reported by the test
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mover = threading.Thread(target=move)
        threads = [threading.Thread(target=write, args=(w,))
                   for w in range(writers)]
        mover.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        done.set()
        mover.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not mover.is_alive() and not any(t.is_alive() for t in threads)
    assert errors == []
    assert store.ring.version > 0
    last = rounds - 1
    for tids in ids.values():
        for tid in tids:
            assert store.get(tid).status == f"running {last}"
            assert store.get_result(tid) == (f"{tid} {last}".encode(),
                                             "application/json")
            holders = [g.index for g in store.groups
                       if tid in g.active._tasks]
            assert holders == [store.shard_for(tid)]
    store.close()


# -- the replica link over HTTP, across the packages --------------------------


@pytest.mark.parametrize("primary,link", [
    ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_the_wire_replica_link_absorbs_across_packages(primary, link,
                                                      tmp_path):
    P, L = NS[primary], NS[link]

    async def main():
        store = P.store.FollowerTaskStore(
            str(tmp_path / "p.jsonl"), start_as_primary=True,
            metrics=P.Registry())
        client = await serve(P.http.make_app(store))
        url = str(client.make_url("")).rstrip("/")
        standby = L.store.FollowerTaskStore(str(tmp_path / "r.jsonl"),
                                            metrics=L.Registry())
        wire = L.sharding.ShardReplicaLink(None, standby, primary_url=url)
        try:
            ids = [store.upsert(P.task.APITask(
                task_id=f"w{i}", endpoint="/v1/x/op", body=b"b")).task_id
                for i in range(6)]
            store.set_result(ids[0], b"out")
            store.update_status(ids[0], "completed", "completed")
            while await asyncio.to_thread(wire.sync_once):
                pass
            assert set(standby._tasks) == set(ids)
            assert standby.get(ids[0]).status == "completed"
            assert standby.replica_chain_head == store.chain_head
            # A compaction bumps the generation: the link resyncs.
            store.compact()
            gen = wire.generation
            while await asyncio.to_thread(wire.sync_once):
                pass
            assert wire.generation != gen
            assert standby.replica_chain_head == store.chain_head
            assert store_state(standby)["tasks"] == store_state(
                store)["tasks"]
        finally:
            await client.close()
            store.close()
            standby.close()

    run(main())


def test_the_wire_link_parks_on_a_corrupt_line_until_compaction(tmp_path):
    async def main():
        path = str(tmp_path / "p.jsonl")
        primary = port_store.FollowerTaskStore(path, start_as_primary=True,
                                               metrics=PortRegistry())
        client = await serve(port_http.make_app(primary))
        url = str(client.make_url("")).rstrip("/")
        standby = port_store.FollowerTaskStore(str(tmp_path / "r.jsonl"),
                                               metrics=PortRegistry())
        link = port_sharding.ShardReplicaLink(None, standby,
                                              primary_url=url)
        try:
            good = [primary.upsert(port_task.APITask(
                endpoint="/v1/x/op", body=b"b")).task_id for _ in range(3)]
            while await asyncio.to_thread(link.sync_once):
                pass
            bad = primary.upsert(port_task.APITask(endpoint="/v1/x/op",
                                                   body=b"b")).task_id
            data = Path(path).read_bytes()
            flip = link.offset + 20
            Path(path).write_bytes(data[:flip] + b"\x00" + data[flip + 1:])
            for _ in range(3):
                await asyncio.to_thread(link.sync_once)
            assert link._corrupt_at is not None
            assert set(standby._tasks) == set(good)
            parked = link.offset
            await asyncio.to_thread(link.sync_once)
            assert link.offset == parked
            primary.compact()
            for _ in range(4):
                await asyncio.to_thread(link.sync_once)
            assert link._corrupt_at is None
            assert set(standby._tasks) == set(good) | {bad}
            assert standby.replica_chain_head == primary.chain_head
        finally:
            await client.close()
            primary.close()
            standby.close()

    run(main())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_absorb_journal_file_drains_a_dead_primary(writer, tmp_path):
    W = NS[writer]
    path = str(tmp_path / "p.jsonl")
    primary = W.store.JournaledTaskStore(path, metrics=W.Registry())
    ids = [primary.upsert(W.task.APITask(
        task_id=f"d{i}", endpoint="/v1/x/op", body=b"b")).task_id
        for i in range(5)]
    primary.set_result(ids[0], b"out")
    primary.update_status(ids[0], "completed", "completed")
    primary.close()
    with open(path, "ab") as fh:
        fh.write(b'{"torn": tr')
    states = {}
    for reader, ns in NS.items():
        standby = ns.store.FollowerTaskStore(
            str(tmp_path / f"r-{reader}.jsonl"), metrics=ns.Registry())
        absorbed = ns.sharding.absorb_journal_file(standby, path)
        standby.promote()
        states[reader] = (absorbed, store_state(standby), standby.role,
                          standby.get_result(ids[0]))
        standby.close()
    assert states["port"] == states["jax"]
    assert states["port"][0] == 7 and states["port"][2] == "primary"
    assert set(states["port"][1]["tasks"]) == set(ids)


# -- the interleavings, through JAX's explorer ---------------------------------


def handoff_scenario(fenced: bool):
    def make():
        store = port_sharding.ShardedTaskStore(2, slots=8)
        if not fenced:
            for g in store.groups:
                g.active.set_write_fence(None)
        store.upsert(port_task.APITask(task_id="t-race", endpoint="/v1/q/op",
                                       body=b"b", publish=False))
        slot = store.ring.slot_for("t-race")
        src = store.ring.shard_of_slot(slot)
        dest = 1 - src

        async def stale_writer():
            owner = store.groups[store.ring.shard_for("t-race")].active
            await yield_point()  # the hop the flip can slot into
            retry = port_task.APITask(
                task_id="t-race", endpoint="/v1/q/op", body=b"",
                status="Awaiting service availability",
                backend_status="created", publish=False)
            try:
                owner.upsert(retry)
            except port_store.NotOwnerError:
                store.upsert(retry)  # the facade's re-route

        async def mover():
            await yield_point()
            store.move_slot(slot, dest)

        def check():
            assert "t-race" not in store.groups[src].active._tasks, (
                "a stale-owner write resurrected the task on the old owner")
            assert (store.groups[dest].active.get("t-race").status
                    == "Awaiting service availability")

        return [stale_writer(), mover()], check

    return make


def test_the_fenced_handoff_is_race_free():
    report = explore_interleavings(handoff_scenario(fenced=True),
                                   schedules=SCHEDULES, seed=SEED)
    assert report.ok, report.describe()


def test_the_unfenced_handoff_race_is_caught():
    report = explore_interleavings(handoff_scenario(fenced=False),
                                   schedules=SCHEDULES, seed=SEED)
    assert not report.ok


def feed_scenario(feed_cls):
    def make():
        store = port_sharding.ShardedTaskStore(2, slots=8)
        feed = feed_cls(0)
        store.feeds = [feed, feed]
        store.upsert(port_task.APITask(task_id="t-watch",
                                       endpoint="/v1/q/op", body=b"b",
                                       publish=False))
        results = []

        async def watcher():
            record = store.get("t-watch")
            if record.canonical_status in port_task.TaskStatus.TERMINAL:
                results.append(record)
                return
            await yield_point()  # the window the event can fire in
            results.append(await feed.wait_terminal("t-watch", 30.0))

        async def completer():
            await yield_point()
            store.update_status("t-watch", "completed", "completed")

        def check():
            assert results and results[0] is not None, (
                "the watcher missed the terminal wakeup")
            assert results[0].canonical_status == "completed"

        return [watcher(), completer()], check

    return make


def test_the_feed_attach_is_race_free():
    report = explore_interleavings(feed_scenario(port_feed.ShardChangeFeed),
                                   schedules=SCHEDULES, seed=SEED)
    assert report.ok, report.describe()


def test_a_feed_without_its_replay_map_misses_wakeups():
    class NoReplayFeed(port_feed.ShardChangeFeed):
        async def wait_terminal(self, task_id, timeout):
            loop = asyncio.get_running_loop()
            fut = loop.create_future()
            entry = (loop, fut)
            with self._lock:  # registers, never checks _recent
                self._waiters[task_id] = self._waiters.get(
                    task_id, frozenset()) | {entry}
            try:
                return await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                return None
            finally:
                self._drop_waiter(task_id, entry)

    report = explore_interleavings(feed_scenario(NoReplayFeed),
                                   schedules=SCHEDULES, seed=SEED)
    assert not report.ok
