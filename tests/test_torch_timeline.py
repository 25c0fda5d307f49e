"""The port's timeline export and ``timeline`` verb
(``ai4e_tpu_torch/observability/timeline.py``, ``cli.py``), and the store's
``dump_ledgers``, held against the JAX package's.

``tests/test_timeline.py`` runs whole on the port (``port_suite``). Then
one synthetic run directory (ledgers dumped from a store, vitals, chaos
verbs fired and not, load-generator curves) goes through both packages'
``build_from_rig_dir`` and both ``timeline`` verbs: the same document, the
same file byte for byte. And the same scripted stamps give the same
``dump_ledgers`` from both packages' stores.
"""

from __future__ import annotations

import json
import random

import pytest

import ai4e_tpu.cli as jax_cli
import ai4e_tpu.observability.timeline as jax_timeline
import ai4e_tpu.taskstore as jax_taskstore
import ai4e_tpu_torch.cli as port_cli
import ai4e_tpu_torch.observability.timeline as port_timeline
import ai4e_tpu_torch.taskstore as port_taskstore
from tests.test_torch_tenancy import port_suite

globals().update(port_suite("test_timeline"))

T0 = 1_760_000_000.0
STORES = {"jax": jax_taskstore, "port": port_taskstore}
HOPS = [("admitted", "gateway"), ("published", "gateway"),
        ("popped", "dispatcher"), ("delivered", "dispatcher"),
        ("execute", "worker"), ("completed", "store")]


def scripted_ledgers(ts, seed: int, n: int = 12):
    """A store with ``n`` tasks, each stamped a seeded hop timeline (some
    past the per-task cap, some unfinished), and their names by creation
    order."""
    rng = random.Random(seed)
    store = ts.InMemoryTaskStore()
    names = {}
    for i in range(n):
        task = store.upsert(ts.APITask(endpoint="/v1/x/run-async"))
        names[task.task_id] = f"task{i}"
        t = T0 + i * 0.01
        events = []
        for e, h in HOPS[:rng.randint(2, len(HOPS))]:
            t += rng.random() * 0.005
            ev = {"e": e, "h": h, "t": round(t, 6)}
            if e == "execute":
                ev["ms"] = round(rng.random() * 4, 3)
            if e in ("delivered", "completed"):
                ev["r"] = "completed" if e == "completed" else "127.0.0.1:1"
            events.append(ev)
        if i % 5 == 4:
            events = events * 30  # past MAX_EVENTS: a truncation marker
        store.append_ledger(task.task_id, events)
    return store, names


def named_dump(store, names: dict, limit: int) -> dict:
    out = {}
    for tid, events in store.dump_ledgers(limit=limit).items():
        # The truncation marker is stamped with the store's clock.
        out[names[tid]] = [{k: v for k, v in ev.items()
                            if not (ev["e"] == "truncated" and k == "t")}
                           for ev in events]
    return out


@pytest.mark.parametrize("limit", [5000, 3, 0, -1])
def test_dump_ledgers_equal_jax(limit):
    got = {pkg: named_dump(*scripted_ledgers(ts, 7), limit)
           for pkg, ts in STORES.items()}
    assert got["port"] == got["jax"]
    assert len(got["port"]) == {5000: 12, 3: 3, 0: 0, -1: 12}[limit]


def rig_dir(tmp_path):
    store, names = scripted_ledgers(port_taskstore, 3)
    ledgers = {names[tid]: evs for tid, evs in store.dump_ledgers().items()}
    (tmp_path / "ledgers.json").write_text(json.dumps({"Ledgers": ledgers}))
    (tmp_path / "rig.json").write_text(json.dumps({
        "chaos": [{"verb": "kill_dispatcher", "t": T0 + 0.03, "ok": True,
                   "queue": "/v1/be/x"},
                  {"verb": "restart_dispatcher", "t": T0 + 0.07, "ok": True},
                  {"verb": "kill_worker", "t": None}],
        "verdict": {"windows": [
            {"loadgen": 0, "samples": [{"t": T0, "accepted": 3,
                                        "terminal": 1},
                                       {"t": T0 + 1, "accepted": 9,
                                        "terminal": 8}]},
            {"loadgen": 1, "samples": []}]}}))
    (tmp_path / "vitals.json").write_text(json.dumps({
        "cp": [{"t": T0 + 0.01, "lag_s": 0.002, "rss_bytes": 52428800},
               {"t": T0 + 0.02, "lag_s": 0.0, "rss_bytes": -1}],
        "a": [{"t": T0 + 0.015, "rss_bytes": 1073741824}]}))
    return tmp_path


def test_build_from_rig_dir_equal_jax(tmp_path):
    d = str(rig_dir(tmp_path))
    got = port_timeline.build_from_rig_dir(d)
    assert got == jax_timeline.build_from_rig_dir(d)
    assert got["otherData"]["tasks"] == 12
    assert sum(ev["pid"] == 1 and ev["ph"] == "i"
               for ev in got["traceEvents"]) == 2


def test_timeline_verbs_write_the_same_file(tmp_path, capsys):
    d = rig_dir(tmp_path)
    jax_cli.main(["timeline", "--rig-dir", str(d), "--out",
                  str(tmp_path / "jax.json")])
    port_cli.main(["timeline", "--rig-dir", str(d), "--out",
                   str(tmp_path / "port.json")])
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())
    port_cli.main(["timeline", "--rig-dir", str(d)])
    assert ((d / "timeline.json").read_bytes()
            == (tmp_path / "jax.json").read_bytes())
    assert "12 tasks" in capsys.readouterr().out


@pytest.mark.parametrize("what", ["missing", "empty"])
def test_timeline_verbs_refuse_alike(tmp_path, what):
    target = tmp_path / ("nowhere" if what == "missing" else "")
    for cli in (jax_cli, port_cli):
        with pytest.raises(SystemExit) as got:
            cli.main(["timeline", "--rig-dir", str(target)])
        assert "timeline:" in str(got.value)
