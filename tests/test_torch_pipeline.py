"""The port's pipeline DAGs (``ai4e_tpu_torch/pipeline/``, ROADMAP A18.12)
held against the JAX package's.

``tests/test_pipeline_dag.py`` and ``tests/test_pipeline_coordinator.py``
run on the port (``port_suite``), the SDK's ``iter_task_events`` against
the port's gateway among them; the coordinator test that drives
``utils/loadclient.py`` runs in ``test_torch_loadclient.py``. Then the same
specs and runs go through both packages: validation errors word for word,
sub-task ids and carved deadlines, the join and multi-sink documents byte
for byte, quorum, the rerun through the stage cache and its bypass, the
assembly's refusals and the store's refusal of forged sub-task creates.
"""

from __future__ import annotations

import asyncio
import json
import types

import pytest
from aiohttp.test_utils import TestClient, TestServer

import ai4e_tpu.pipeline as jax_pipeline
import ai4e_tpu.platform_assembly as jax_pa
import ai4e_tpu.taskstore.http as jax_http
from ai4e_tpu.taskstore import APITask as JaxTask
import ai4e_tpu_torch.pipeline as port_pipeline
import ai4e_tpu_torch.platform_assembly as port_pa
import ai4e_tpu_torch.taskstore.http as port_http
from ai4e_tpu_torch.taskstore import APITask as PortTask
from ai4e_tpu.metrics import MetricsRegistry as JaxRegistry
from ai4e_tpu_torch.metrics import MetricsRegistry as PortRegistry
from tests import test_pipeline_coordinator as jax_harness
from tests.test_torch_tenancy import port_module, port_suite

globals().update(port_suite("test_pipeline_dag"))
globals().update(port_suite(
    "test_pipeline_coordinator",
    # Its load-client half runs in test_torch_loadclient.py.
    leave_out=("TestStreamingClients",)))

_port_harness = port_module("test_pipeline_coordinator")


class TestStreamingClients:
    """The SDK half of JAX's ``TestStreamingClients`` on the port."""

    test_blocking_sdk_iter_task_events = (
        _port_harness.TestStreamingClients.test_blocking_sdk_iter_task_events)


JAX = types.SimpleNamespace(pipe=jax_pipeline, pa=jax_pa, http=jax_http,
                            APITask=JaxTask, Registry=JaxRegistry,
                            harness=jax_harness)
PORT = types.SimpleNamespace(pipe=port_pipeline, pa=port_pa, http=port_http,
                             APITask=PortTask, Registry=PortRegistry,
                             harness=_port_harness)
NS = {"jax": JAX, "port": PORT}


def run(coro):
    return asyncio.run(coro)


def both(fn):
    return {pkg: fn(ns) for pkg, ns in NS.items()}


# -- the spec ------------------------------------------------------------------


BAD_SPECS = {
    "bad-name": lambda S, P: P("bad name", "/v1/p", [S("a", "/v1/a")]),
    "no-stages": lambda S, P: P("p", "/v1/p", []),
    "duplicate": lambda S, P: P("p", "/v1/p", [S("a", "/v1/a"),
                                               S("a", "/v1/b")]),
    "bad-stage-name": lambda S, P: P("p", "/v1/p", [S("a:b", "/v1/a")]),
    "no-endpoint": lambda S, P: P("p", "/v1/p", [S("a", "")]),
    "unknown-dep": lambda S, P: P("p", "/v1/p", [S("a", "/v1/a",
                                                   after=("z",))]),
    "self-dep": lambda S, P: P("p", "/v1/p", [S("a", "/v1/a",
                                                after=("a",))]),
    "quorum": lambda S, P: P("p", "/v1/p", [S("a", "/v1/a"),
                                            S("b", "/v1/b", after=("a",),
                                              quorum=2)]),
    "fraction": lambda S, P: P("p", "/v1/p", [S("a", "/v1/a",
                                                deadline_fraction=1.5)]),
    "input": lambda S, P: P("p", "/v1/p", [S("a", "/v1/a", input="raw")]),
    "cycle": lambda S, P: P("p", "/v1/p", [S("a", "/v1/a", after=("c",)),
                                           S("b", "/v1/b", after=("a",)),
                                           S("c", "/v1/c", after=("b",))]),
    "path-budget": lambda S, P: P("p", "/v1/p", [
        S("a", "/v1/a", deadline_fraction=0.6),
        S("b", "/v1/b", after=("a",), deadline_fraction=0.3),
        S("c", "/v1/c", after=("b",), deadline_fraction=0.2)]),
    "valid": lambda S, P: P("p", "/v1/p", [
        S("a", "/v1/a", deadline_fraction=0.5),
        S("b", "http://h:1/v1/b?x=1", after=("a",), deadline_fraction=0.5),
        S("c", "/v1/c", after=("a",)), S("d", "/v1/d", after=["b", "c"],
                                         quorum=1)]),
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_spec_validation_word_for_word(case):
    def build(ns):
        try:
            spec = BAD_SPECS[case](ns.pipe.StageSpec, ns.pipe.PipelineSpec)
        except ns.pipe.PipelineSpecError as exc:
            return f"error: {exc}"
        return (spec.order, spec.sinks(), spec.entry_path,
                [spec.downstream_of(s.name) for s in spec.stages],
                [(s.endpoint_path, s.required_successes())
                 for s in spec.stages])

    got = both(build)
    assert got["port"] == got["jax"]
    assert isinstance(got["port"], str) == (case != "valid")


def test_sub_task_ids_and_carved_deadlines_equal_jax():
    roots = ["abc", "0f3c-11", "x~y", "", "a:b"]
    stages = ["s", "stage_2", "a-b"]
    fractions = [0.0, 0.1, 0.5, 1.0]
    deadlines = [0.0, 999.0, 1000.0, 1000.5, 1060.0]

    def view(ns):
        ids = [(ns.pipe.sub_task_id(r, s),
                ns.pipe.split_sub_task_id(ns.pipe.sub_task_id(r, s)))
               for r in roots for s in stages]
        plain = [ns.pipe.split_sub_task_id(t) for t in ("abc", "a~", "~b")]
        carved = [ns.pipe.stage_deadline(
            ns.pipe.StageSpec("s", "/v1/s", deadline_fraction=f), d,
            now=1000.0) for f in fractions for d in deadlines]
        return ids, plain, carved

    got = both(view)
    assert got["port"] == got["jax"]


# -- runs through both platforms ---------------------------------------------


def fan_spec(h, P, S):
    return P("fan", "/v1/pipe/fan", [
        S("split", h.endpoint("split")),
        S("left", h.endpoint("left"), after=("split",)),
        S("right", h.endpoint("right"), after=("split",)),
        S("join", h.endpoint("join"), after=("left", "right"), quorum=1),
    ])


def sinks_spec(h, P, S):
    return P("sinks", "/v1/pipe/sinks", [
        S("one", h.endpoint("one"), input="original"),
        S("two", h.endpoint("two"), input="original"),
        S("three", h.endpoint("three"), after=("one",)),
    ])


async def dag_runs(ns, make_spec, stages, fail=()) -> dict:
    """One body, then the same again under another request key (``?uniq``
    defeats the whole-request cache, so the stage cache answers), then
    again with ``X-Cache-Bypass``: each root's status, its result and each
    stage's, and the stage host's executions."""
    H = ns.harness
    platform, host, spec, gw = await H.build(
        ns.pa.PlatformConfig(retry_delay=0.05, pipeline=True,
                             result_cache=True),
        stages, lambda h: make_spec(h, ns.pipe.PipelineSpec,
                                    ns.pipe.StageSpec))
    host.fail.update(fail)
    out = {"runs": []}
    try:
        for query, headers in (("", {}), ("?uniq=1", {}),
                               ("", {"X-Cache-Bypass": "1"})):
            async with gw.post(spec.prefix + query, data=b'{"scene": 7}',
                               headers=headers) as r:
                root = (await r.json())["TaskId"]
            record = await H.wait_terminal(gw, root)
            found = platform.store.get_result(root)
            parts = {name: platform.store.get_result(root, stage=name)
                     for name in spec.order}
            out["runs"].append((record["Status"], found, parts,
                                dict(host.hits)))
    finally:
        await gw.close()
        await host.close()
        await platform.stop()
    return out


@pytest.mark.parametrize("case", ["fan-in", "fan-in-quorum", "multi-sink"])
def test_join_and_multi_sink_documents_byte_equal(case):
    make_spec, stages, fail = {
        "fan-in": (fan_spec, ["split", "left", "right", "join"], ()),
        "fan-in-quorum": (fan_spec, ["split", "left", "right", "join"],
                          ("right",)),
        "multi-sink": (sinks_spec, ["one", "two", "three"], ()),
    }[case]
    got = both(lambda ns: run(dag_runs(ns, make_spec, stages, fail)))
    assert got["port"]["runs"] == got["jax"]["runs"]
    first, repeat, bypass = got["port"]["runs"]
    assert first[0].startswith("completed - pipeline")
    # The repeat is answered from the stage cache (no stage runs again);
    # the bypass runs every stage again.
    assert all(repeat[3][s] == first[3][s] for s in first[3]
               if s not in fail)
    assert "(0 executed" in repeat[0]
    assert repeat[1] == first[1]
    assert all(bypass[3][s] == 2 * first[3][s] for s in first[3]
               if s not in fail)
    assert first[1] is not None and first[1][1] == "application/json"
    if case == "multi-sink":
        doc = json.loads(first[1][0])
        assert sorted(doc["stages"]) == ["three", "two"]


@pytest.mark.parametrize("fields", [
    {"pipeline": True, "transport": "push"},
    {"pipeline": True, "native_store": True},
    {"pipeline": True, "native_broker": True},
], ids=["push", "native-store", "native-broker"])
def test_assembly_refusals_word_for_word(fields):
    def build(ns):
        try:
            ns.pa.LocalPlatform(ns.pa.PlatformConfig(**fields),
                                metrics=ns.Registry())
        except ValueError as exc:
            return str(exc)
        return None

    got = both(build)
    assert got["port"] == got["jax"] and got["port"]


def test_register_pipeline_without_the_coordinator_refuses_alike():
    def build(ns):
        platform = ns.pa.LocalPlatform(ns.pa.PlatformConfig(),
                                       metrics=ns.Registry())
        spec = ns.pipe.PipelineSpec("p", "/v1/p",
                                    [ns.pipe.StageSpec("a", "/v1/a")])
        with pytest.raises(ValueError) as exc:
            platform.register_pipeline(spec)
        return str(exc.value), platform.pipeline, platform.task_events

    got = both(build)
    assert got["port"] == got["jax"]


def test_forged_sub_task_creates_refused_alike():
    """The store's HTTP surface refuses to create a record whose TaskId
    carries the sub-task separator, and transitions an existing one."""
    async def scenario(ns):
        platform = ns.pa.LocalPlatform(ns.pa.PlatformConfig(pipeline=True),
                                       metrics=ns.Registry())
        app = ns.http.make_app(platform.store)
        client = TestClient(TestServer(app))
        await client.start_server()
        out = []
        try:
            for task_id in ("root~stage", "plain"):
                async with client.post("/v1/taskstore/upsert", json={
                        "TaskId": task_id, "Endpoint": "/v1/x"}) as r:
                    out.append((r.status, (await r.json()).get("error")))
            platform.store.upsert(ns.APITask(task_id="root~a",
                                             endpoint="/v1/x"))
            async with client.post("/v1/taskstore/upsert", json={
                    "TaskId": "root~a", "Endpoint": "/v1/x",
                    "Status": "completed - x"}) as r:
                out.append((r.status, (await r.json())["Status"]))
        finally:
            await client.close()
        return out

    got = both(lambda ns: run(scenario(ns)))
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == 400 and got["port"][2][0] == 200
