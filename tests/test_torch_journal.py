"""The port's journal (``ai4e_tpu_torch/taskstore/journal.py``) and its
journaled store (``JournaledTaskStore``, ``FollowerTaskStore``) held
against the JAX package's on the CPU: the envelope, checksum, chain and
fsync policy equal on the same inputs, error texts included; the same
scripted operations under a frozen clock write byte-equal journals; each
package replays the other's journal to the same state; every prefix of a
journal boots both stores to the same state with equal salvage reports;
degraded mode and ``recover()`` behave alike under JAX's disk-fault
injector. Every store gets a registry of its own, so nothing is left in
the process-default ones."""

from __future__ import annotations

import json
import shutil
import time

import numpy as np
import pytest

from ai4e_tpu.chaos.disk import DiskFaultInjector, attach_journal_faults
from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu.taskstore import journal as jax_journal
from ai4e_tpu.taskstore import results as jax_results
from ai4e_tpu.taskstore import store as jax_store
from ai4e_tpu.taskstore import task as jax_task
from ai4e_tpu_torch.metrics import MetricsRegistry as PortRegistry
from ai4e_tpu_torch.taskstore import journal as port_journal
from ai4e_tpu_torch.taskstore import results as port_results
from ai4e_tpu_torch.taskstore import store as port_store
from ai4e_tpu_torch.taskstore import task as port_task

PKGS = {
    "jax": (jax_journal, jax_store, jax_task, jax_results, JaxRegistry),
    "port": (port_journal, port_store, port_task, port_results,
             PortRegistry),
}
OFFLOAD_AT = 64   # result bytes at or over this go to the result backend


# -- the envelope ------------------------------------------------------------


def _payloads(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        size = int(rng.integers(0, 200))
        out.append({"TaskId": f"t{i}", "Status": "created",
                    "BodyHex": rng.bytes(size).hex(),
                    "Unicode": "é✓" * int(rng.integers(0, 4)),
                    "N": float(rng.normal())})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc_chain_and_envelope_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(32):
        data = rng.bytes(int(rng.integers(0, 300)))
        assert port_journal.crc32c(data) == jax_journal.crc32c(data)
    chain_p = chain_j = port_journal.GENESIS
    for rec in _payloads(seed, 24):
        line_p, chain_p = port_journal.encode_record(rec, chain_p)
        line_j, chain_j = jax_journal.encode_record(rec, chain_j)
        assert (line_p, chain_p) == (line_j, chain_j)
    assert port_journal.GENESIS == jax_journal.GENESIS == "00000000"
    # The published CRC-32C check value.
    assert port_journal.crc32c(b"123456789") == 0xE3069283


def test_native_checksum_equals_the_table_loop():
    """The checksum runs natively (``native/crc32c.cpp``, g++ is here),
    equal to the table loop at every length around the 8-byte words."""
    rng = np.random.default_rng(9)
    port_journal.crc32c(b"")
    assert port_journal._NATIVE[0] is not None
    for n in list(range(0, 33)) + [1000, 4099, 200_003]:
        data = rng.bytes(n)
        assert (port_journal.crc32c(data) == port_journal._crc32c_py(data)
                == jax_journal.crc32c(data))


def _verify(mod, line: str, prev):
    try:
        return ("ok", mod.verify_line(line, prev))
    except mod.JournalCorruptError as exc:
        return ("error", str(exc), exc.reason)


def _bad_lines() -> list[tuple[str, str | None]]:
    good, _ = jax_journal.encode_record({"TaskId": "a", "Status": "x"},
                                        jax_journal.GENESIS)
    payload = '{"TaskId": "a"'
    crc = f"{jax_journal.crc32c(payload.encode()):08x}"
    bad_json = (f"J1:{crc}:{jax_journal.chain_next(jax_journal.GENESIS, crc)}"
                f":{payload}")
    flipped = good[:-3] + ("y" if good[-3] != "y" else "z") + good[-2:]
    return [
        (good, jax_journal.GENESIS),
        (good, None),
        (good, "12345678"),                  # a broken chain
        (flipped, jax_journal.GENESIS),       # a checksum mismatch
        (good[:15], jax_journal.GENESIS),     # a malformed envelope
        ("J1:zzzzzzzz:00000000:{}", jax_journal.GENESIS),
        (bad_json, jax_journal.GENESIS),      # clean checksum, bad JSON
        ('{"TaskId": "legacy", "Status": "created"}', jax_journal.GENESIS),
        ('{"TaskId": "legacy"}', None),
        ("[1, 2]", jax_journal.GENESIS),      # a legacy non-object
        ("not json at all", jax_journal.GENESIS),
    ]


@pytest.mark.parametrize("case", range(11))
def test_verify_line_equals_jax_error_texts_included(case):
    line, prev = _bad_lines()[case]
    assert _verify(port_journal, line, prev) == _verify(jax_journal, line,
                                                        prev)


FSYNC_INPUTS = [None, "", "never", "NEVER", " always ", "group:20",
                "group:0.5", "GROUP:20", "group:0", "group:-1", "group:nan",
                "group:inf", "group:", "group:x", "sometimes", "always2"]


def _policy(mod, raw):
    try:
        return ("ok", mod.parse_fsync_policy(raw))
    except ValueError as exc:
        return ("error", str(exc))


@pytest.mark.parametrize("raw", FSYNC_INPUTS)
def test_parse_fsync_policy_equals_jax(raw, monkeypatch):
    monkeypatch.delenv(port_journal.FSYNC_ENV, raising=False)
    assert port_journal.FSYNC_ENV == jax_journal.FSYNC_ENV
    assert _policy(port_journal, raw) == _policy(jax_journal, raw)


@pytest.mark.parametrize("env", ["always", "group:15", "bogus", ""])
def test_fsync_policy_from_the_environment(env, monkeypatch):
    monkeypatch.setenv("AI4E_TASKSTORE_FSYNC", env)
    assert _policy(port_journal, None) == _policy(jax_journal, None)


# -- one script on both stores -------------------------------------------------


class FrozenClock:
    def __init__(self, start: float = 1_700_000_000.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def tick(self, s: float = 1.0) -> None:
        self.now += s


def _open(pkg: str, path, blobs=None, cls="FollowerTaskStore", **kw):
    _, store_mod, _, results_mod, registry = PKGS[pkg]
    backend = (results_mod.FileResultBackend(str(blobs)) if blobs
               else None)
    return getattr(store_mod, cls)(
        str(path), result_backend=backend,
        result_offload_threshold=OFFLOAD_AT if backend else None,
        fsync="never", metrics=registry(), **kw)


def run_script(pkg: str, store, clock: FrozenClock, until: int = 99) -> None:
    """Upserts, transitions, inline, offloaded and stage results, a failed
    task's redrive, evictions, a compaction, a memory-only cache hit and
    an epoch, with explicit TaskIds; ``until`` stops after that step."""
    APITask = PKGS[pkg][2].APITask
    rng = np.random.default_rng(11)
    ids = [f"t{i:02d}" for i in range(12)]
    store.promote()  # mints Epoch 1
    for i, tid in enumerate(ids):
        clock.tick()
        store.upsert(APITask(
            task_id=tid,
            endpoint=("http://w:1/v1/landcover/classify"
                      + ("?tile=1" if i % 3 == 0 else "")),
            body=rng.bytes(16 + i), content_type="application/octet-stream",
            cache_key=f"k{i}" if i % 2 else "",
            deadline_at=1_800_000_000.0 if i % 4 == 0 else 0.0,
            # Not 0: JAX's from_dict reads Priority 0 back as 1, and the
            # port's record matches it.
            priority=1 + i % 2))
    if until <= 1:
        return
    for tid in ids[:9]:
        clock.tick(0.25)
        store.update_status(tid, "running", "running")
    for tid in ids[:6]:
        clock.tick(0.25)
        store.update_status(tid, "completed - class_histogram", "completed")
    for i, tid in enumerate(ids[:3]):
        store.set_result(tid, json.dumps({"i": i}).encode())
    for tid in ids[3:5]:
        store.set_result(tid, rng.bytes(OFFLOAD_AT + 10),
                         content_type="application/octet-stream")
    store.set_result(ids[5], rng.bytes(OFFLOAD_AT + 3), stage="megadetector")
    store.set_result(ids[5], b'{"final": true}')
    # An inline value over an offloaded pointer.
    store.set_result(ids[4], b'{"small": 1}')
    if until <= 2:
        return
    clock.tick()
    store.update_status(ids[7], "failed - boom", "failed")
    clock.tick()
    assert store.requeue_if(ids[7], "failed") is not None
    clock.tick(100.0)
    store.update_status(ids[8], "completed - late", "completed")
    # Evicts the six completed more than 50 s ago, blobs included.
    assert store.evict_terminal_older_than(50.0) == 6
    store.set_result(ids[8], rng.bytes(OFFLOAD_AT + 5),
                     content_type="application/octet-stream")
    if until <= 3:
        return
    store.compact()
    clock.tick()
    store.update_status(ids[9], "running", "running")
    # A cache hit: memory-only, never journaled.
    store.upsert(APITask(
        task_id="hit", endpoint="http://w:1/v1/landcover/classify",
        body=b"x", status="completed - served from cache",
        backend_status="completed", cache_key="k1", durable=False))
    store.set_result("hit", b'{"cached": 1}')
    store.set_result(ids[6], b'{"after": "compaction"}')
    clock.tick()
    store.update_status(ids[10], "running", "running")
    store.demote(3)  # an Epoch 3 fence


def state(store) -> dict:
    """What a store holds, durable records only."""
    with store._lock:
        tasks = {tid: (t.to_dict(), t.body)
                 for tid, t in store._tasks.items() if t.durable}
        return {
            "tasks": tasks,
            "sets": {f"{p}|{s}": {t: sc for t, sc in m.items() if t in tasks}
                     for (p, s), m in store._sets.items()
                     if any(t in tasks for t in m)},
            "results": {k: v for k, v in store._results.items()
                        if k.split(":", 1)[0] in tasks},
            "result_keys": {k: sorted(v) for k, v in
                            store._result_keys.items() if v and k in tasks},
            "orig": {k: v for k, v in store._orig_bodies.items()
                     if k in tasks},
            "epoch": store.epoch,
        }


@pytest.fixture()
def scripted(tmp_path, monkeypatch):
    """Both packages' journals and blob directories after the script, with
    their live states."""
    clock = FrozenClock()
    monkeypatch.setattr(time, "time", clock)
    out = {}
    for pkg in PKGS:
        clock.now = 1_700_000_000.0
        d = tmp_path / pkg
        d.mkdir()
        store = _open(pkg, d / "journal.jsonl", d / "blobs")
        run_script(pkg, store, clock)
        out[pkg] = {"path": d / "journal.jsonl", "blobs": d / "blobs",
                    "state": state(store), "chain": store.chain_head,
                    "generation": store.journal_generation,
                    "role": store.role}
        store.close()
    return out


def test_same_script_writes_byte_equal_journals(scripted):
    jax_bytes = scripted["jax"]["path"].read_bytes()
    assert scripted["port"]["path"].read_bytes() == jax_bytes
    assert jax_bytes.count(b"\n") > 10
    assert b'"Epoch": 1' in jax_bytes and b'"Epoch": 3' in jax_bytes
    assert b'"Offloaded": true' in jax_bytes
    assert scripted["port"]["state"] == scripted["jax"]["state"]
    for key in ("chain", "generation", "role"):
        assert scripted["port"][key] == scripted["jax"][key]
    assert scripted["port"]["role"] == "follower"
    assert (sorted(p.name for p in scripted["port"]["blobs"].iterdir())
            == sorted(p.name for p in scripted["jax"]["blobs"].iterdir()))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_replays_the_others_journal(scripted, writer, tmp_path):
    states = {}
    for reader in PKGS:
        d = tmp_path / f"{writer}-by-{reader}"
        shutil.copytree(scripted[writer]["path"].parent, d)
        store = _open(reader, d / "journal.jsonl", d / "blobs",
                      cls="JournaledTaskStore")
        states[reader] = (state(store), store.chain_head,
                          store.journal_generation,
                          sorted(t.task_id for t in store.unfinished_tasks()),
                          store.get_result("t06"))
        store.close()
    assert states["port"] == states["jax"]
    assert states["port"][0] == scripted[writer]["state"]
    assert states["port"][3] == ["t06", "t07", "t09", "t10", "t11"]
    assert states["port"][4] == (b'{"after": "compaction"}',
                                 "application/json")


def _journal_until(tmp_path, monkeypatch, until: int) -> dict:
    """Each package's journal of the script stopped after step ``until``."""
    clock = FrozenClock()
    monkeypatch.setattr(time, "time", clock)
    d = tmp_path / f"until{until}"
    d.mkdir()
    for pkg in PKGS:
        clock.now = 1_700_000_000.0
        store = _open(pkg, d / f"{pkg}.jsonl", d / f"{pkg}-blobs")
        run_script(pkg, store, clock, until=until)
        store.close()
    monkeypatch.undo()
    return {pkg: (d / f"{pkg}.jsonl", d / f"{pkg}-blobs") for pkg in PKGS}


def test_replaying_an_offloaded_pointer_without_a_backend_raises(
        tmp_path, monkeypatch):
    # Cut before the eviction: offloaded pointers live.
    paths = _journal_until(tmp_path, monkeypatch, 2)
    assert paths["port"][0].read_bytes() == paths["jax"][0].read_bytes()
    errors = {}
    for pkg in PKGS:
        with pytest.raises(RuntimeError) as exc:
            _open(pkg, paths[pkg][0], cls="JournaledTaskStore")
        errors[pkg] = str(exc.value)
    assert errors["port"] == errors["jax"]
    assert "no result backend is configured" in errors["port"]


# -- every prefix --------------------------------------------------------------


def _cut_points(data: bytes, seed: int = 5) -> list[int]:
    bounds = [0] + [i + 1 for i, b in enumerate(data) if b == 0x0A]
    rng = np.random.default_rng(seed)
    mids = []
    for a, b in zip(bounds, bounds[1:]):
        if b - a > 2:
            mids.append(int(rng.integers(a + 1, b - 1)))
    return sorted(set(bounds) | set(mids[::2]))


def _boot(pkg: str, d, data: bytes, cut: int):
    """Boot ``pkg``'s store on the first ``cut`` bytes; its state, the
    file it left, and its salvage report (without the wall time)."""
    path = d / "journal.jsonl"
    path.write_bytes(data[:cut])
    store = _open(pkg, path, d / "blobs", cls="JournaledTaskStore")
    out = (state(store), store.chain_head, store.journal_stats()["salvages"],
           len(store.unfinished_tasks()))
    store.close()
    report = None
    sidecar = d / "journal.jsonl.salvage.json"
    if sidecar.exists():
        report = json.loads(sidecar.read_text())
        report.pop("ts")
        report["path"] = report["path"].rsplit("/", 1)[-1]
        sidecar.unlink()
    return out, path.read_bytes(), report


def test_every_prefix_boots_both_stores_alike(tmp_path, monkeypatch):
    # The whole history, before the compaction rewrites it.
    paths = _journal_until(tmp_path, monkeypatch, 3)
    data = paths["jax"][0].read_bytes()
    assert paths["port"][0].read_bytes() == data
    cuts = _cut_points(data)
    assert len(cuts) > 50
    dirs = {}
    for pkg in PKGS:
        dirs[pkg] = tmp_path / f"prefix-{pkg}"
        shutil.copytree(paths["jax"][1], dirs[pkg] / "blobs")
    salvaged = 0
    for cut in cuts:
        got = {pkg: _boot(pkg, dirs[pkg], data, cut) for pkg in PKGS}
        assert got["port"] == got["jax"], f"cut at byte {cut}"
        salvaged += got["port"][2] is not None
    # Every mid-record cut is a torn tail both salvage the same way.
    assert salvaged == len([c for c in cuts if c and data[c - 1] != 0x0A])


def test_interior_corruption_refuses_to_open_with_the_offset(scripted,
                                                            tmp_path):
    data = bytearray(scripted["jax"]["path"].read_bytes())
    second = data.index(b"\n") + 1
    data[second + 30] ^= 0x01
    offsets = {}
    for pkg in PKGS:
        path = tmp_path / f"{pkg}.jsonl"
        path.write_bytes(bytes(data))
        with pytest.raises(PKGS[pkg][0].JournalCorruptError) as exc:
            _open(pkg, path, tmp_path / "blobs", cls="JournaledTaskStore")
        offsets[pkg] = (exc.value.offset, exc.value.line_no,
                        exc.value.reason)
        assert path.read_bytes() == bytes(data)  # nothing truncated
    assert offsets["port"] == offsets["jax"] == (second, 2, "checksum")


def test_verify_tool_exit_codes_and_verdicts(scripted, tmp_path, capsys):
    data = scripted["port"]["path"].read_bytes()
    clean = tmp_path / "clean.jsonl"
    torn = tmp_path / "torn.jsonl"
    clean.write_bytes(data)
    torn.write_bytes(data[:-7])
    assert port_journal.main([str(clean), str(torn)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith(f"chain head {scripted['port']['chain']}")
    assert "TORN TAIL" in out[1]
    assert port_journal.main([]) == 2
    corrupt = tmp_path / "corrupt.jsonl"
    raw = bytearray(data)
    raw[40] ^= 0x02
    corrupt.write_bytes(bytes(raw))
    assert port_journal.main([str(corrupt)]) == 1
    assert "CORRUPT interior record" in capsys.readouterr().out


# -- the fsync policies ----------------------------------------------------------


@pytest.mark.parametrize("policy,fsyncs", [("never", 0), ("always", 5)])
def test_fsync_policies_count_like_jax(policy, fsyncs, tmp_path,
                                       monkeypatch):
    # Frozen, so both journals' timestamps have the same digits.
    monkeypatch.setattr(time, "time", FrozenClock())
    stats = {}
    for pkg in PKGS:
        _, store_mod, task_mod, _, registry = PKGS[pkg]
        reg = registry()
        store = store_mod.JournaledTaskStore(str(tmp_path / f"{pkg}.jsonl"),
                                             fsync=policy, metrics=reg)
        for i in range(5):
            store.upsert(task_mod.APITask(task_id=f"a{i}", endpoint="/v1/x",
                                          body=b"b"))
        full = store.journal_stats()
        # The port adds append p50 and p95 to JAX's keys.
        if pkg == "port":
            assert (full.pop("append_p50_ms") <= full.pop("append_p95_ms")
                    <= full["append_p99_ms"])
        stats[pkg] = {k: v for k, v in full.items() if k != "append_p99_ms"}
        store.close()
        assert "ai4e_journal_append_seconds" in reg.render_prometheus()
    assert stats["port"] == stats["jax"]
    assert stats["port"]["fsyncs"] == fsyncs
    assert stats["port"]["fsync_policy"] == policy


def test_group_commit_timer_syncs_an_idle_tail(tmp_path):
    store = port_store.JournaledTaskStore(str(tmp_path / "g.jsonl"),
                                          fsync="group:30",
                                          metrics=PortRegistry())
    APITask = port_task.APITask
    store.upsert(APITask(task_id="a", endpoint="/v1/x", body=b"1"))
    first = store.journal_stats()["fsyncs"]
    store.upsert(APITask(task_id="b", endpoint="/v1/x", body=b"2"))
    deadline = time.monotonic() + 5.0
    while store.journal_stats()["fsyncs"] == first:
        assert time.monotonic() < deadline, "the group timer never fired"
        time.sleep(0.01)
    assert store.journal_stats()["fsync_policy"] == "group:30"
    store.close()
    assert store._fsync_timer is None


def test_a_bad_policy_fails_at_construction(tmp_path):
    with pytest.raises(ValueError, match="group:<ms>"):
        port_store.JournaledTaskStore(str(tmp_path / "x.jsonl"),
                                      fsync="group:0", metrics=PortRegistry())
    assert not (tmp_path / "x.jsonl").exists()


# -- degraded mode under JAX's disk-fault injector ------------------------------


def _fault_run(pkg: str, d, rules: list[dict], policy: str) -> dict:
    """Two upserts, a fault per ``rules``, a refused write, ``recover()``,
    one more write, then a restart on the journal."""
    _, store_mod, task_mod, _, registry = PKGS[pkg]
    APITask = task_mod.APITask
    path = d / f"{pkg}.jsonl"
    store = store_mod.JournaledTaskStore(str(path), fsync=policy,
                                         metrics=registry())
    store.upsert(APITask(task_id="a", endpoint="/v1/x", body=b"1"))
    injector = DiskFaultInjector(seed=3)
    for rule in rules:
        injector.add_rule(**rule)
    attach_journal_faults(store, injector)
    out = {}
    try:
        store.upsert(APITask(task_id="b", endpoint="/v1/x", body=b"2"))
        out["fault"] = None
    except store_mod.JournalDegradedError as exc:
        out["fault"] = ("degraded", exc.rollback)
    out["after_fault"] = sorted(store._tasks)
    out["reads"] = store.get("a").task_id
    try:
        store.update_status("a", "running", "running")
        out["refused"] = None
    except store_mod.JournalDegradedError as exc:
        out["refused"] = exc.rollback
    out["degraded"] = store.degraded
    injector.clear()
    out["recovered"] = store.recover()
    store.upsert(APITask(task_id="c", endpoint="/v1/x", body=b"3"))
    out["live"] = state(store)
    out["generation"] = store.journal_generation
    store.close()
    again = store_mod.JournaledTaskStore(str(path), fsync=policy,
                                         metrics=registry())
    out["replayed"] = state(again)
    again.close()
    for key in ("live", "replayed"):
        for rec, _ in out[key]["tasks"].values():
            rec.pop("Timestamp")
        out[key]["sets"] = {k: sorted(v) for k, v in out[key]["sets"].items()}
    return out


@pytest.mark.parametrize("rules,policy", [
    ([{"op": "write", "errno": 28}], "never"),
    ([{"op": "write", "errno": 5, "torn_bytes": 9}], "never"),
    ([{"op": "flush", "errno": 28}], "never"),
    ([{"op": "fsync", "errno": 5}], "always"),
], ids=["enospc-write", "torn-write", "flush", "fsync-eio"])
def test_degraded_mode_and_recover_equal_jax(rules, policy, tmp_path):
    got = {pkg: _fault_run(pkg, tmp_path, rules, policy) for pkg in PKGS}
    assert got["port"] == got["jax"]
    run = got["port"]
    assert run["fault"] == ("degraded", rules[0]["op"] != "fsync")
    assert run["refused"] is False and run["degraded"] is True
    assert run["recovered"] is True
    assert run["live"] == run["replayed"]
    # A refused-and-unwound write never comes back; an fsync-refused one
    # is in the file, so it stays.
    assert ("b" in run["replayed"]["tasks"]) == (rules[0]["op"] == "fsync")
