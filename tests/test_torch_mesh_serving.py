"""The port's mesh serving plane (``ai4e_tpu_torch.runtime.mesh``, the
worker's ``AI4E_RUNTIME_MESH_SPEC``) against the JAX package's, mirroring
``tests/test_mesh_serving.py``'s classes:

- the grammar (the same parses, descriptions, tiers and refusals);
- a dp = 2 mesh endpoint built by ``cli.build_worker`` in two gloo ranks
  (rank 0 serves, rank 1 mirrors): its answers equal the unmeshed
  oracle's byte for byte, ``GET {prefix}/models`` carries the layout;
- the spec and the axis knobs excluding each other, a layout larger than
  the ranks present refused with ``MeshSpecError``;
- partition rules naming every gap; mesh shapes as orchestration tiers;
- a poisoned row redelivering only its task, and
  ``mesh_unhealthy_after`` flipping the endpoint to 500 and back, on the
  one-rank layout (injected poison is charged to a virtual follower, as
  in JAX);
- the SeqFormer at sp = 2 (ring and Ulysses), the MoE at ep = 2 and the
  ViT at tp = 2 in two gloo ranks against JAX's runtime on a mesh of the
  same shape, on the same converted weights.

Tolerances of the meshed models (logits): the MoE's expert combine adds
one nonzero term a token, so ep = 2 equals one device's model up to
float32 reassociation in the mean pool (5e-5 against the port's own
single-device run); JAX's ring runs its block products in bfloat16 where
the port's flash version runs them in float32 from bfloat16 inputs, and
the ViT's row-split products are added in float32 (XLA adds bfloat16
partials): against JAX's meshed models ``JAX_LOGIT_ATOL``; against the
port's own single-device model ``SELF_LOGIT_ATOL``."""

import asyncio
import io
import time

import jax
import numpy as np
import pytest
import torch
from test_torch_parallel import run_ranks

from ai4e_tpu.parallel import MeshSpec as JaxMeshSpec
from ai4e_tpu.parallel import make_mesh as jax_make_mesh
from ai4e_tpu.runtime.families import build_servable as jax_build_servable
from ai4e_tpu.runtime.mesh import MeshLayout as JaxMeshLayout
from ai4e_tpu.runtime.mesh import MeshSpecError as JaxMeshSpecError
from ai4e_tpu.runtime.registry import ModelRuntime as JaxRuntime
from ai4e_tpu_torch.config import FrameworkConfig
from ai4e_tpu_torch.convert import flatten_tree
from ai4e_tpu_torch.runtime.families import build_servable
from ai4e_tpu_torch.runtime.mesh import (MeshLayout, MeshSpecError,
                                         parse_mesh_spec)
from ai4e_tpu_torch.runtime.registry import ModelRuntime

JAX_LOGIT_ATOL = 3e-2
SELF_LOGIT_ATOL = 2e-2
MOE_SELF_ATOL = 5e-5

SEQFORMER = dict(name="seq", seq_len=32, vocab_size=64, dim=32, depth=1,
                 heads=2, num_classes=4, buckets=(4,))
MOE = dict(name="moe", seq_len=32, vocab_size=64, dim=32, depth=1, heads=1,
           num_experts=4, num_classes=4, attention="full", buckets=(4,))
VIT = dict(name="vit", image_size=32, patch=8, dim=32, depth=2, heads=2,
           num_classes=10, buckets=(4,))
ENDPOINT = {"service_name": "w", "prefix": "v1/echo",
            "models": [{"family": "echo", "name": "echo", "size": 4,
                        "buckets": [4], "async_path": "/echo-async"}]}


def _build(mesh_spec="", hop_ledger=False, unhealthy_after=None):
    from ai4e_tpu_torch.cli import build_worker
    config = FrameworkConfig()
    config.runtime.mesh_spec = mesh_spec
    config.observability.hop_ledger = hop_ledger
    if unhealthy_after is not None:
        config.runtime.mesh_unhealthy_after = unhealthy_after
    return build_worker({
        "service_name": "w", "prefix": "v1/echo",
        "models": [{"family": "echo", "name": "echo", "size": 4,
                    "buckets": [1], "async_path": "/echo-async"}]},
        device="cpu", config=config)


# ---------------------------------------------------------------------------
# Spec grammar
# ---------------------------------------------------------------------------

class TestMeshSpecGrammar:
    @pytest.mark.parametrize("text", ["dp=2,tp=2,sp=2", "dp=8", "tp=4",
                                      "sp=2", " dp=2 , tp=2 "])
    def test_parse_and_describe_are_jax_s(self, text):
        got, want = MeshLayout.parse(text), JaxMeshLayout.parse(text)
        assert got.describe() == want.describe()
        assert got.tier_label == want.tier_label
        assert MeshLayout.parse(got.describe()["spec"]) == got

    def test_off_spellings_mean_mesh_off(self):
        assert parse_mesh_spec(None) is None
        assert parse_mesh_spec("") is None
        assert parse_mesh_spec("  off ") is None
        assert parse_mesh_spec("dp=4") == MeshLayout(dp=4)

    @pytest.mark.parametrize("bad", ["dp", "dp=0", "dp=x", "ep=2",
                                     "dp=2,dp=4", ","])
    def test_bad_specs_are_jax_s_named_errors(self, bad):
        with pytest.raises(JaxMeshSpecError) as want:
            JaxMeshLayout.parse(bad)
        with pytest.raises(MeshSpecError) as got:
            MeshLayout.parse(bad)
        assert str(got.value) == str(want.value)

    def test_validate_names_the_rank_gap(self):
        with pytest.raises(MeshSpecError, match="needs 3 ranks, got 1"):
            MeshLayout.parse("dp=3").validate(1)
        with pytest.raises(MeshSpecError, match="split evenly"):
            MeshLayout.parse("dp=8").validate(8, process_count=3)


# ---------------------------------------------------------------------------
# The mesh endpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_group(tmp_path_factory):
    """Two gloo ranks: the meshed models, then a dp=2 endpoint."""
    g = np.random.default_rng(11)
    jax_side = {}
    inputs = {
        "seq_batch": g.integers(0, 64, (4, 32)).astype(np.int32),
        "moe_batch": g.integers(0, 64, (4, 32)).astype(np.int32),
        "vit_batch": g.random((4, 32, 32, 3), dtype=np.float32),
        "endpoint_batch": g.standard_normal((4, 4)).astype(np.float32)}
    for family, kw, key in (("seqformer", SEQFORMER, "seq_batch"),
                            ("moe", MOE, "moe_batch"),
                            ("vit", VIT, "vit_batch")):
        servable = jax_build_servable(family, **kw)
        inputs.update({f"{family}/{k}": v for k, v in flatten_tree(
            jax.tree.map(np.asarray, servable.params)).items()})
        jax_side[family] = servable.params
    # Other weights for the MoE's reload over the mesh.
    reload = jax.tree.map(lambda a: np.asarray(a) * np.float32(1.5),
                          jax_side["moe"])
    inputs.update({f"moe_reload/{k}": v
                   for k, v in flatten_tree(reload).items()})
    jax_side["moe_reload"] = reload
    case = {"seqformer": SEQFORMER, "moe": MOE, "vit": VIT,
            "endpoint": ENDPOINT}
    ranks = run_ranks("models", 2, tmp_path_factory.mktemp("mesh"), inputs,
                      case)
    return inputs, jax_side, ranks


def jax_meshed(family: str, kw: dict, params, batch, mesh_spec, rules=None):
    """JAX's runtime on a mesh of ``mesh_spec``'s shape, on ``params``."""
    mesh = jax_make_mesh(mesh_spec, devices=jax.devices()[:mesh_spec.size])
    servable = jax_build_servable(family, mesh=mesh, **kw)
    servable.params = params
    runtime = JaxRuntime(mesh=mesh)
    runtime.register(servable, param_sharding_rules=rules)
    return np.asarray(runtime.run_batch(kw["name"], batch))


def port_single(family: str, kw: dict, params, batch) -> np.ndarray:
    servable = build_servable(family, **kw)
    servable.module.load_state_dict(servable.state_dict_from_flax(params))
    runtime = ModelRuntime("cpu")
    runtime.register(servable)
    return runtime.run_batch(kw["name"], batch)


class TestMeshEndpointE2E:
    def test_meshed_results_byte_identical_to_unmeshed_oracle(
            self, mesh_group):
        _, _, ranks = mesh_group
        arrays, info = ranks[0]
        assert info["poisoned"] == []
        assert info["tier"] == "mesh-dp2"
        assert (arrays["endpoint_meshed"].tobytes()
                == arrays["endpoint_oracle"].tobytes())
        # Sharded ingestion: the follower got its two rows, not four.
        assert info["egress"] == 2 * 4 * 4

    def test_describe_carries_layout_and_health(self, mesh_group):
        info = mesh_group[2][0][1]
        desc = info["describe"]
        assert desc["tier"] == "mesh-dp2"
        assert desc["devices"] == 2 and desc["process_count"] == 2
        assert desc["data_axis_multiple"] == 2
        assert desc["healthy"] is True

    def test_models_endpoint_exposes_the_layout(self, mesh_group):
        entry = mesh_group[2][0][1]["models"]["models"][0]
        assert entry["mesh"]["spec"] == "dp=2"
        assert entry["mesh"]["tier"] == "mesh-dp2"
        assert entry["mesh"]["healthy"] is True
        assert entry["batch_buckets"] == [4]

    def test_mesh_spec_and_axis_knobs_are_mutually_exclusive(self):
        config = FrameworkConfig()
        config.runtime.mesh_spec = "dp=8"
        config.runtime.tp = 2
        from ai4e_tpu_torch.cli import build_worker
        with pytest.raises(ValueError, match="mutually exclusive"):
            build_worker({"service_name": "w", "prefix": "v1/e",
                          "models": []}, device="cpu", config=config)

    def test_layout_larger_than_the_ranks_present_raises(self):
        with pytest.raises(MeshSpecError, match="needs 2 ranks, got 1"):
            _build("dp=2")

    def test_one_rank_layout_wraps_the_runtime(self):
        meshed, _b1, _t1 = _build("dp=1")
        plain, _b2, _t2 = _build("")
        assert hasattr(meshed.runtime, "layout")
        assert not hasattr(plain.runtime, "layout")
        assert meshed.runtime.layout.tier_label == "mesh-dp1"
        assert (meshed.runtime.supports_split_phases()
                == plain.runtime.supports_split_phases())
        batch = np.random.default_rng(3).standard_normal((1, 4)).astype(
            np.float32)
        out, poisoned = meshed.runtime.run_batch_report("echo", batch)
        assert poisoned == frozenset()
        assert out.tobytes() == plain.runtime.run_batch("echo",
                                                        batch).tobytes()


class TestMeshedModelsAgainstJax:
    @pytest.mark.parametrize("attention", ["ring", "ulysses"])
    def test_seqformer_at_sp2(self, mesh_group, attention):
        inputs, params, ranks = mesh_group
        kw = dict(SEQFORMER, attention=attention)
        want = jax_meshed("seqformer", kw, params["seqformer"],
                          inputs["seq_batch"], JaxMeshSpec(sp=2))
        single = port_single("seqformer", dict(SEQFORMER, attention="full"),
                             params["seqformer"], inputs["seq_batch"])
        for arrays, _ in ranks:
            got = arrays[f"seqformer_{attention}"]
            np.testing.assert_allclose(got, want, rtol=0, atol=JAX_LOGIT_ATOL)
            np.testing.assert_allclose(got, single, rtol=0,
                                       atol=SELF_LOGIT_ATOL)

    def test_moe_at_ep2(self, mesh_group):
        from ai4e_tpu.models.moe import MOE_EP_RULES
        inputs, params, ranks = mesh_group
        want = jax_meshed("moe", MOE, params["moe"], inputs["moe_batch"],
                          JaxMeshSpec(ep=2), MOE_EP_RULES)
        single = port_single("moe", MOE, params["moe"], inputs["moe_batch"])
        for arrays, info in ranks:
            assert info["local_shapes"]["moe"]["blocks.0.moe.up"][0] == 2
            np.testing.assert_allclose(arrays["moe"], want, rtol=0,
                                       atol=JAX_LOGIT_ATOL)
            np.testing.assert_allclose(arrays["moe"], single, rtol=0,
                                       atol=MOE_SELF_ATOL)

    def test_moe_reload_at_ep2_shards_the_new_weights(self, mesh_group):
        """``reload_params`` over the mesh keeps each rank's shard of the
        new tree: the reloaded MoE answers as one device on those weights."""
        inputs, params, ranks = mesh_group
        single = port_single("moe", MOE, params["moe_reload"],
                             inputs["moe_batch"])
        assert np.abs(single - port_single(
            "moe", MOE, params["moe"], inputs["moe_batch"])).max() > 1e-3
        for arrays, _ in ranks:
            np.testing.assert_allclose(arrays["moe_reloaded"], single,
                                       rtol=0, atol=MOE_SELF_ATOL)

    def test_vit_at_tp2(self, mesh_group):
        from ai4e_tpu.models.vit import TP_RULES
        inputs, params, ranks = mesh_group
        want = jax_meshed("vit", VIT, params["vit"], inputs["vit_batch"],
                          JaxMeshSpec(tp=2), TP_RULES)
        single = port_single("vit", VIT, params["vit"], inputs["vit_batch"])
        for arrays, info in ranks:
            shapes = info["local_shapes"]["vit"]
            assert shapes["blocks.0.attn.qkv.weight"] == [48, 32]
            assert shapes["blocks.0.mlp.down.weight"] == [32, 64]
            np.testing.assert_allclose(arrays["vit"], want, rtol=0,
                                       atol=JAX_LOGIT_ATOL)
            np.testing.assert_allclose(arrays["vit"], single, rtol=0,
                                       atol=SELF_LOGIT_ATOL)
            assert (arrays["vit"].argmax(-1) == single.argmax(-1)).all()


class TestPartitionRules:
    def test_unmatched_params_fail_with_every_path_named(self):
        from ai4e_tpu_torch.runtime.mesh.placement import \
            match_partition_rules
        params = {"dense": {"kernel": np.zeros((4, 4)),
                            "bias": np.zeros((4,))},
                  "gamma": np.zeros((4,))}
        with pytest.raises(ValueError) as err:
            match_partition_rules([(r".*kernel", (None, "tp"))], params)
        assert "dense/bias" in str(err.value)
        assert "gamma" in str(err.value)

    def test_catch_all_completes_the_mapping(self):
        from ai4e_tpu_torch.runtime.mesh.placement import \
            match_partition_rules
        params = {"dense": {"kernel": np.zeros((4, 4)),
                            "bias": np.zeros((4,))}}
        specs = match_partition_rules(
            [(r".*kernel", (None, "tp")), (r".*", ())], params)
        assert specs["dense/kernel"] == (None, "tp")
        assert specs["dense/bias"] == ()

    def test_register_meshed_names_the_gaps_of_a_servable(self):
        from ai4e_tpu_torch.runtime.mesh import MeshEndpoint
        servable = build_servable("vit", **dict(VIT, name="v"))
        endpoint = MeshEndpoint(ModelRuntime("cpu"), MeshLayout())
        with pytest.raises(ValueError, match="unmapped") as err:
            endpoint.register_meshed(
                servable, [(r"attn/qkv/kernel$", (None, "tp"))])
        assert "params/head/kernel" in str(err.value)
        endpoint.register_meshed(servable, [(r".*", ())])
        assert "v" in endpoint.models


# ---------------------------------------------------------------------------
# Mesh shapes as orchestration cost tiers
# ---------------------------------------------------------------------------

MESH_DP8 = "http://pool-a:9/v1/echo-mesh-dp8/run-async"
MESH_DP4TP2 = "http://pool-b:9/v1/echo-mesh-dp4tp2/run-async"
TIERS = [(MESH_DP8, 1.0), (MESH_DP4TP2, 1.0)]


class TestMeshCostTiers:
    @staticmethod
    def _orch():
        from ai4e_tpu_torch.metrics import MetricsRegistry
        from ai4e_tpu_torch.orchestration.core import (OrchestrationPolicy,
                                                       Orchestrator)
        from ai4e_tpu_torch.resilience.health import (BackendHealth,
                                                      ResiliencePolicy)
        health = BackendHealth(ResiliencePolicy(failure_threshold=2),
                               metrics=MetricsRegistry())
        policy = OrchestrationPolicy(
            costs={MeshLayout.parse("dp=8").tier_label: 1.0,
                   MeshLayout.parse("dp=4,tp=2").tier_label: 4.0})
        orch = Orchestrator(health, policy=policy,
                            metrics=MetricsRegistry())
        for _ in range(8):
            orch.observe(MESH_DP8, 0.8)       # cheap but slow
            orch.observe(MESH_DP4TP2, 0.01)   # expensive but fast
        return orch

    def test_tier_labels_price_the_walk(self):
        orch = self._orch()
        assert orch.cost_of(MESH_DP8) == 1.0
        assert orch.cost_of(MESH_DP4TP2) == 4.0

    def test_no_deadline_takes_the_cheapest_mesh_tier(self):
        assert self._orch().place(TIERS) == MESH_DP8

    def test_tight_deadline_routes_to_the_tier_that_clears(self):
        orch = self._orch()
        assert orch.place(TIERS, deadline_at=time.time() + 5.0) == MESH_DP8
        assert orch.place(TIERS, deadline_at=time.time() + 0.1) == \
            MESH_DP4TP2


# ---------------------------------------------------------------------------
# Poisoned rows and the endpoint's health
# ---------------------------------------------------------------------------

class TestPoisonedRowRedeliveryE2E:
    def test_poisoned_row_redelivers_only_its_task(self, monkeypatch):
        """Batch 1 gets one injected poisoned row: every task still
        completes exactly once, the poisoned one through a broker
        redelivery stamped RETRY/poisoned-row in its ledger."""
        monkeypatch.setenv("AI4E_FAULT_MESH_POISON_NTHS", "1")
        from aiohttp.test_utils import TestClient, TestServer

        from ai4e_tpu_torch.observability.ledger import RETRY
        from ai4e_tpu_torch.platform_assembly import (LocalPlatform,
                                                      PlatformConfig)
        from ai4e_tpu_torch.taskstore import TaskStatus

        async def serve_app(app):
            client = TestClient(TestServer(app))
            await client.start_server()
            return client

        async def main():
            platform = LocalPlatform(PlatformConfig(retry_delay=0.05))
            worker, batcher, _tm = _build("dp=1", hop_ledger=True)
            worker.service.task_manager = platform.task_manager
            worker.store = platform.store
            prev: dict[str, str] = {}
            completions: dict[str, int] = {}

            def _count(task):
                cur = task.canonical_status
                if (cur == TaskStatus.COMPLETED
                        and prev.get(task.task_id) != TaskStatus.COMPLETED):
                    completions[task.task_id] = (
                        completions.get(task.task_id, 0) + 1)
                prev[task.task_id] = cur

            platform.store.add_listener(_count)
            await batcher.start()
            svc = await serve_app(worker.service.app)
            base = str(svc.make_url("")).rstrip("/")
            platform.publish_async_api("/v1/pub/echo",
                                       base + "/v1/echo/echo-async")
            gw = await serve_app(platform.gateway.app)
            await platform.start()
            try:
                tids = []
                for i in range(3):
                    buf = io.BytesIO()
                    np.save(buf, np.full(4, float(i + 1), np.float32))
                    resp = await gw.post("/v1/pub/echo", data=buf.getvalue())
                    assert resp.status == 200, resp.status
                    tids.append((await resp.json())["TaskId"])
                deadline = asyncio.get_running_loop().time() + 30.0
                while asyncio.get_running_loop().time() < deadline:
                    stats = {t: platform.store.get(t).canonical_status
                             for t in tids}
                    if all(s == TaskStatus.COMPLETED for s in stats.values()):
                        break
                    assert TaskStatus.FAILED not in stats.values(), stats
                    await asyncio.sleep(0.02)
                else:
                    raise AssertionError(f"tasks never drained: {stats}")
                assert all(completions.get(t) == 1 for t in tids), completions
                retried = [t for t in tids
                           if any(e.get("e") == RETRY
                                  and e.get("r") == "poisoned-row"
                                  for e in platform.store.get_ledger(t))]
                assert len(retried) == 1, retried
                assert worker.runtime.health.healthy
            finally:
                await platform.stop()
                await batcher.stop()
                await gw.close()
                await svc.close()

        asyncio.run(main())

    def test_mesh_unhealthy_after_flips_admission_to_500_and_back(
            self, monkeypatch):
        """Two consecutive poisoned batches at ``mesh_unhealthy_after=2``
        flip the endpoint unhealthy: the worker answers 500 before
        adopting work and ``/models`` says why; one clean batch heals it."""
        monkeypatch.setenv("AI4E_FAULT_MESH_POISON_NTHS", "1,2")
        from aiohttp.test_utils import TestClient, TestServer

        async def main():
            worker, batcher, _ = _build("dp=1", unhealthy_after=2)
            one = np.ones((1, 4), np.float32)
            for _ in range(2):
                _, poisoned = worker.runtime.run_batch_report("echo", one)
                assert poisoned == frozenset({0})
            assert not worker.runtime.health.healthy
            await batcher.start()
            client = TestClient(TestServer(worker.service.app))
            await client.start_server()
            try:
                buf = io.BytesIO()
                np.save(buf, np.ones(4, np.float32))
                resp = await client.post("/v1/echo/echo", data=buf.getvalue())
                assert resp.status == 500
                assert "unhealthy" in await resp.text()
                entry = (await (await client.get("/v1/echo/models")).json())[
                    "models"][0]
                assert entry["mesh"]["healthy"] is False
                assert "2 consecutive" in entry["mesh"]["unhealthy_reason"]
                _, poisoned = worker.runtime.run_batch_report("echo", one)
                assert poisoned == frozenset()
                assert worker.runtime.health.healthy
                resp = await client.post("/v1/echo/echo", data=buf.getvalue())
                assert resp.status == 200
                assert (await resp.json())["echo"] == [1.0] * 4
            finally:
                await client.close()
                await batcher.stop()

        asyncio.run(main())


def test_torch_is_the_only_framework_in_the_ranks():
    """The rank script imports neither JAX nor the JAX package."""
    import ast
    from pathlib import Path
    src = (Path(__file__).parent / "helpers" / "torch_ranks.py").read_text()
    names = {a.name.split(".")[0] for node in ast.walk(ast.parse(src))
             if isinstance(node, (ast.Import, ast.ImportFrom))
             for a in getattr(node, "names", [])}
    mods = {node.module.split(".")[0] for node in ast.walk(ast.parse(src))
            if isinstance(node, ast.ImportFrom) and node.module}
    assert not ({"jax", "flax", "ai4e_tpu"} & (names | mods))
    assert torch.__name__ == "torch"
