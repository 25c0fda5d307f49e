"""The port's public surface against the JAX package's.

- An AST guard: every public function, class, method and property of every
  file both packages have exists in the port, and every name a JAX
  package's ``__all__`` exports imports from the port's package; every
  file of ``ai4e_tpu/`` outside ``analysis/`` and ``ops/pallas/`` has its
  counterpart path, and ``ops/pallas/validate.py`` maps to
  ``ops/validate.py``. ``EXCEPTIONS`` names the two names that stay out,
  each with its reason.
- The names the earlier copies cut, each held against JAX's behaviour on
  the same inputs: ``APIService.begin_draining`` and ``run``,
  ``Gateway.run``, ``next_endpoint_from``, ``Histogram.quantile`` and
  ``Timer``, ``EndpointQueue.in_flight`` and ``InMemoryBroker.depths``,
  ``NativeBroker.queue_names``, ``NativeTaskStore.get_original_body`` and
  ``snapshot``, ``create_resnet50`` (logits on weights carried across by
  the converter: bfloat16, within ``RESNET_ATOL``), ``train_full`` (steps
  cut) and ``MultihostRuntime``'s ``models``, ``mesh`` and
  ``data_axis_size``.
- The port's command for each of the Makefile's recipes (``MAKE_RECIPES``,
  also in README.md): its parser accepts every flag, and each test file
  it names exists.
"""

import argparse
import ast
import asyncio
import importlib
import json
import shlex
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
JAX_ROOT, PORT_ROOT = ROOT / "ai4e_tpu", ROOT / "ai4e_tpu_torch"
#: JAX files without a counterpart path: the lint tool (which the port's
#: tests run on the port) and the Pallas kernels (``ops/*.py`` and
#: ``csrc/*.cu`` in the port).
UNPAIRED = ("analysis/", "ops/pallas/")
#: JAX files whose counterpart lives at another path.
MOVED = {"ops/pallas/validate.py": "ops/validate.py"}
#: (file, name) of JAX's that the port holds under another name: JAX's
#: VMEM budget is a Hopper shared-memory budget in the port.
RENAMED = {("ops/pallas/validate.py", f"{kernel}_vmem_bytes"):
           f"{kernel}_smem_bytes"
           for kernel in ("flash_attention", "segmentation_argmax",
                          "normalize_image")}
#: (file, name) of JAX's that the port leaves out, and why.
EXCEPTIONS = {
    ("models/seqformer.py", "SeqFormerLM.setup"):
        "flax's module setup hook; a torch module builds its layers in "
        "__init__",
    ("runtime/registry.py", "enable_compilation_cache"):
        "XLA's persistent compilation cache; the port compiles no XLA "
        "programs (its kernels build once with nvcc into build/, its graphs "
        "are captured at warmup)",
    ("runtime/__init__.py", "enable_compilation_cache"):
        "the package's lazy export of the name above",
}
RESNET_ATOL = 5e-2  # bfloat16 logits, as tests/test_torch_resnet.py's


# -- the AST guard ------------------------------------------------------------

def public_names(path: Path) -> set[str]:
    """Top-level names of a file: its public functions and classes with
    their public methods and properties (``Class.name``), and, for the
    port, every name it binds at module level (imports too)."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{sub.name}" for sub in node.body
                          if isinstance(sub, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.split(".")[-1].startswith("_")}


def defined_names(path: Path) -> set[str]:
    """The JAX side: what a file defines (not what it imports)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{sub.name}" for sub in node.body
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                        and not sub.name.startswith("_")}
    return out


def jax_files() -> list[str]:
    return sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py")
                  if "__pycache__" not in p.parts)


def counterpart(rel: str) -> str | None:
    if rel in MOVED:
        return MOVED[rel]
    if rel.startswith(UNPAIRED):
        return None
    return rel


def test_every_jax_file_has_its_counterpart_path():
    missing = [rel for rel in jax_files() if counterpart(rel) is not None
               and not (PORT_ROOT / counterpart(rel)).exists()]
    assert missing == []
    assert (PORT_ROOT / "ops" / "validate.py").exists()


SHARED = [rel for rel in jax_files() if counterpart(rel) is not None]


@pytest.mark.parametrize("rel", SHARED)
def test_every_public_name_of_a_shared_file_is_in_the_port(rel):
    want = {RENAMED.get((rel, n), n) for n in defined_names(JAX_ROOT / rel)}
    have = public_names(PORT_ROOT / counterpart(rel))
    missing = sorted(n for n in want - have if (rel, n) not in EXCEPTIONS)
    assert missing == []


PACKAGES = sorted({str(Path(rel).parent) for rel in SHARED
                   if rel.endswith("__init__.py")})


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_export_imports_from_the_port(pkg):
    dotted = "" if pkg == "." else "." + pkg.replace("/", ".")
    jax_pkg = importlib.import_module(f"ai4e_tpu{dotted}")
    port_pkg = importlib.import_module(f"ai4e_tpu_torch{dotted}")
    rel = f"{pkg}/__init__.py" if pkg != "." else "__init__.py"
    missing = [n for n in getattr(jax_pkg, "__all__", [])
               if not hasattr(port_pkg, n) and (rel, n) not in EXCEPTIONS]
    assert missing == []


def test_the_exceptions_are_still_jax_s_and_still_absent():
    for (rel, name), reason in EXCEPTIONS.items():
        assert reason
        if rel.endswith("__init__.py"):
            pkg = rel[:-len("/__init__.py")].replace("/", ".")
            assert name in importlib.import_module(f"ai4e_tpu.{pkg}").__all__
            assert not hasattr(
                importlib.import_module(f"ai4e_tpu_torch.{pkg}"), name)
        else:
            assert name in defined_names(JAX_ROOT / rel)
            assert name not in public_names(PORT_ROOT / rel)


# -- the names the copies cut, against JAX's behaviour ------------------------

def both(module: str):
    return (importlib.import_module(f"ai4e_tpu.{module}"),
            importlib.import_module(f"ai4e_tpu_torch.{module}"))


@pytest.mark.parametrize("pkg", ["ai4e_tpu", "ai4e_tpu_torch"])
def test_begin_draining_refuses_with_503(pkg):
    """``tests/test_service.py::test_draining_returns_503`` on each
    package."""
    from aiohttp.test_utils import TestClient, TestServer

    app_mod = importlib.import_module(f"{pkg}.service.app")
    svc = app_mod.APIService("test", prefix="v1/test")

    @svc.api_sync_func("/ep")
    def ep(body, content_type):
        return "ok"

    async def main():
        client = TestClient(TestServer(svc.app))
        await client.start_server()
        try:
            before = (await client.post("/v1/test/ep", data=b"x")).status
            svc.begin_draining()
            resp = await client.post("/v1/test/ep", data=b"x")
            health = await client.get("/v1/test/")
            return before, resp.status, health.status, \
                resp.headers.get("X-Draining")
        finally:
            await client.close()

    assert asyncio.run(main()) == (200, 503, 503, "1")


@pytest.mark.parametrize("pkg", ["ai4e_tpu", "ai4e_tpu_torch"])
def test_run_serves_with_a_drain_on_shutdown(pkg, monkeypatch):
    """``APIService.run`` hands its app to aiohttp's ``run_app`` with the
    drain timeout as the shutdown timeout, and the app's shutdown hook
    drains: new requests refused, the tasks in flight awaited."""
    from aiohttp import web

    app_mod = importlib.import_module(f"{pkg}.service.app")
    calls = {}
    monkeypatch.setattr(web, "run_app",
                        lambda app, **kw: calls.update(app=app, **kw))
    svc = app_mod.APIService("test", prefix="v1/test")
    svc.run(host="127.0.0.1", port=18555, drain_timeout=7.0)
    assert calls["app"] is svc.app
    assert (calls["host"], calls["port"], calls["shutdown_timeout"]) == (
        "127.0.0.1", 18555, 7.0)
    hook, = svc.app.on_shutdown
    asyncio.run(hook(svc.app))
    assert svc.is_terminating is True


@pytest.mark.parametrize("pkg", ["ai4e_tpu", "ai4e_tpu_torch"])
def test_gateway_run_hands_its_app_to_aiohttp(pkg, monkeypatch):
    from aiohttp import web

    router = importlib.import_module(f"{pkg}.gateway.router")
    store = importlib.import_module(f"{pkg}.taskstore").InMemoryTaskStore()
    calls = {}
    monkeypatch.setattr(web, "run_app",
                        lambda app, **kw: calls.update(app=app, **kw))
    gw = router.Gateway(store)
    gw.run(port=18556)
    assert calls == {"app": gw.app, "host": "0.0.0.0", "port": 18556}


@pytest.mark.parametrize("current,args", [
    ("http://host:8080/v1/camera-trap/detect", ("v2", "org", "species")),
    ("https://a.b/v1/x", ("v1", "ai4e", "next")),
    ("/v1/local/path", ("v1", "o", "api")),
    ("", ("v3", "x", "y"))])
def test_next_endpoint_from_is_jax_s(current, args):
    jax_tm, port_tm = both("service.task_manager")
    assert port_tm.next_endpoint_from(current, *args) == \
        jax_tm.next_endpoint_from(current, *args)
    assert importlib.import_module("ai4e_tpu_torch.service") \
        .next_endpoint_from is port_tm.next_endpoint_from


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantile_is_jax_s(q):
    jax_reg, port_reg = both("metrics.registry")
    values = np.random.default_rng(3).exponential(0.2, 400)
    got = []
    for mod in (jax_reg, port_reg):
        hist = mod.Histogram("h")
        assert hist.quantile(q, route="r") == 0.0  # nothing observed
        for v in values:
            hist.observe(float(v), route="r")
        got.append(hist.quantile(q, route="r"))
    assert got[0] == got[1]


def test_timer_observes_its_block_as_jax_s():
    jax_reg, port_reg = both("metrics.registry")
    counts = []
    for mod in (jax_reg, port_reg):
        hist = mod.Histogram("t", buckets=(0.5, float("inf")))
        with mod.Timer(hist, op="x") as timer:
            assert isinstance(timer, mod.Timer)
        (_, _, labels, data), = hist.collect()
        counts.append((labels, data["count"], data["buckets"][0][1]))
    assert counts[0] == counts[1] == ({"op": "x"}, 1, 1)
    assert importlib.import_module("ai4e_tpu_torch.metrics").Timer is \
        port_reg.Timer


@pytest.mark.parametrize("pkg", ["ai4e_tpu", "ai4e_tpu_torch"])
def test_depths_and_in_flight(pkg):
    """``tests/test_broker.py``'s isolated queues and
    ``tests/test_admission.py``'s leak check, on each package."""
    queue = importlib.import_module(f"{pkg}.broker.queue")
    task = importlib.import_module(f"{pkg}.taskstore").APITask

    async def main():
        broker = queue.InMemoryBroker()
        broker.publish(task(task_id="a", endpoint="http://h/v1/alpha"))
        broker.publish(task(task_id="b", endpoint="http://h/v1/beta"))
        msg = await broker.receive("/v1/beta", timeout=1)
        q = broker.queue("/v1/beta")
        leased = q.in_flight
        broker.complete(msg)
        return (msg.task_id, broker.depths(), leased, q.in_flight)

    assert asyncio.run(main()) == (
        "b", {"/v1/alpha": 1, "/v1/beta": 0}, 1, 0)


def test_native_broker_queue_names_are_jax_s():
    jax_nb, port_nb = both("broker.native")
    names = []
    for mod in (jax_nb, port_nb):
        broker = mod.NativeBroker()
        try:
            for name in ("/v1/zeta", "/v1/alpha", "/v1/zeta"):
                broker.register_queue(name)
            names.append(broker.queue_names())
        finally:
            broker.close()
    assert names[0] == names[1] == ["/v1/alpha", "/v1/zeta"]


def test_native_store_original_body_and_snapshot_are_jax_s():
    out = []
    for pkg in ("ai4e_tpu", "ai4e_tpu_torch"):
        native = importlib.import_module(f"{pkg}.taskstore.native")
        task = importlib.import_module(f"{pkg}.taskstore").APITask
        store = native.NativeTaskStore()
        for i, body in enumerate((b"first body", b"", b"\x00\x01binary")):
            store.upsert(task(task_id=f"t{i}", endpoint="/v1/x", body=body))
        store.update_status("t0", "running")
        out.append((
            [store.get_original_body(f"t{i}") for i in range(3)],
            store.get_original_body("unknown"),
            sorted((t.task_id, t.status) for t in store.snapshot())))
    assert out[0] == out[1]
    assert out[1][0] == [b"first body", b"", b"\x00\x01binary"]


def test_create_resnet50_matches_jax_s_logits():
    from ai4e_tpu.models.resnet import create_resnet50 as jax_create
    from ai4e_tpu_torch import convert
    from ai4e_tpu_torch.models import create_resnet50

    model, variables = jax_create(jax.random.PRNGKey(0), num_classes=10,
                                  image_size=64)
    x = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x)), np.float32)
    port = create_resnet50(num_classes=10, device="cpu")
    port.load_state_dict(convert.resnet_state_dict_from_flax(
        jax.tree.map(np.asarray, variables)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESNET_ATOL)
    assert sum(p.numel() for p in port.parameters()) == sum(
        np.size(v) for v in jax.tree.leaves(variables["params"]))


def test_train_full_writes_the_deployed_size_into_the_manifest(tmp_path):
    """JAX's ``train_full``: the recipe at its ``FULL_OVERRIDES`` size,
    recorded in ``MANIFEST.json``; here with the steps and batch cut and
    the eval gate off, as the port's ``make_checkpoint`` tests cut them."""
    from ai4e_tpu.train import make_checkpoints as jax_mc
    from ai4e_tpu_torch.train import make_checkpoints as mc

    entry = mc.train_full("species", str(tmp_path), steps=1, batch=2,
                          min_eval=0.0, device="cpu")
    manifest = json.loads((tmp_path / "MANIFEST.json").read_text())
    assert manifest == {"species": entry}
    assert entry["kwargs"]["image_size"] == \
        jax_mc.FULL_OVERRIDES["species"]["image_size"] == 224
    assert Path(entry["path"]) == tmp_path / "species.npz"
    assert (tmp_path / "species.npz").stat().st_size > 0


def test_multihost_runtime_passes_its_runtime_s_properties_through():
    from ai4e_tpu_torch.parallel.multihost import MultihostRuntime
    from ai4e_tpu_torch.runtime.registry import ModelRuntime

    runtime = ModelRuntime("cpu")
    wrapped = MultihostRuntime(runtime)
    assert wrapped.models is runtime.models
    assert wrapped.mesh is runtime.mesh
    assert wrapped.data_axis_size == runtime.data_axis_size == 1
    for name in ("models", "mesh", "data_axis_size"):
        assert isinstance(vars(MultihostRuntime)[name], property)


# -- the Makefile's recipes on the port ---------------------------------------

#: make target -> the port's command lines (README.md's port section).
MAKE_RECIPES = {
    "chaos": [
        "AI4E_CHAOS_SEED=20260803 JAX_PLATFORMS=cpu python -m pytest "
        "tests/test_torch_chaos.py tests/test_torch_disk_chaos.py -q "
        "-p no:cacheprovider"],
    "mesh": [
        "JAX_PLATFORMS=cpu python -m pytest tests/test_torch_mesh_serving.py "
        "tests/test_torch_parallel.py -q -p no:cacheprovider"],
    "rig": [
        "python -m ai4e_tpu_torch.rig up --gateways 3 --shards 2 "
        "--replicas 1 --dispatchers 1 --workers 1 --loadgens 2 --rate 1500 "
        "--duration 15 --ramp 3 --task-timeout 45 --seed 20260803 "
        "--workdir /tmp/ai4e-torch-rig --out /tmp/ai4e-torch-rig/artifact"],
    "upgrade": [
        "python -m ai4e_tpu_torch.rig up --gateways 2 --shards 1 "
        "--replicas 1 --dispatchers 1 --workers 2 --loadgens 2 --rate 300 "
        "--duration 22 --ramp 2 --task-timeout 45 --seed 20260803 "
        "--no-chaos --rollout clean --rollout-steps 50,100 "
        "--rollout-hold-s 2 --rollout-drain-timeout-ms 4000 "
        "--workdir /tmp/ai4e-torch-upgrade "
        "--out /tmp/ai4e-torch-upgrade/clean",
        "python -m ai4e_tpu_torch.rig up --gateways 2 --shards 1 "
        "--replicas 1 --dispatchers 1 --workers 2 --loadgens 2 --rate 300 "
        "--duration 25 --ramp 2 --task-timeout 45 --seed 20260803 "
        "--no-chaos --rollout bad-canary --rollout-steps 25,50,100 "
        "--rollout-hold-s 3 --rollout-drain-timeout-ms 4000 "
        "--workdir /tmp/ai4e-torch-upgrade "
        "--out /tmp/ai4e-torch-upgrade/bad-canary"],
    "durability": [
        "AI4E_CHAOS_SEED=20260803 JAX_PLATFORMS=cpu python -m pytest "
        "tests/test_torch_journal.py tests/test_torch_disk_chaos.py "
        "tests/test_torch_restart.py -q -p no:cacheprovider"],
    "top": [
        "python -m ai4e_tpu_torch top --spec "
        "/tmp/ai4e-torch-rig/topology.json --interval 2.0"],
    "timeline": [
        "python -m ai4e_tpu_torch timeline "
        "--rig-dir /tmp/ai4e-torch-rig/artifact"],
}


class Parsed(Exception):
    """Raised in place of running a command once its flags parsed."""


def parse_only(monkeypatch, module: str, argv: list[str]) -> argparse.Namespace:
    """``module``'s ``main(argv)`` up to its parse: the namespace, or
    SystemExit for a flag the parser refuses."""
    original = argparse.ArgumentParser.parse_args

    def parse_args(self, args=None, namespace=None):
        raise Parsed(original(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(Parsed) as parsed:
        importlib.import_module(module).main(argv)
    return parsed.value.args[0]


def test_every_make_target_has_a_port_recipe():
    make = (ROOT / "Makefile").read_text()
    for target in MAKE_RECIPES:
        assert f"\n{target}:" in make


@pytest.mark.parametrize("target", sorted(MAKE_RECIPES))
def test_each_recipe_line_is_in_the_readme(target):
    readme = (ROOT / "README.md").read_text()
    for line in MAKE_RECIPES[target]:
        assert line in readme, line


@pytest.mark.parametrize("target,index", [
    (t, i) for t, lines in sorted(MAKE_RECIPES.items())
    for i in range(len(lines))])
def test_the_port_accepts_every_flag_of_the_recipe(target, index,
                                                   monkeypatch):
    argv = shlex.split(MAKE_RECIPES[target][index])
    while "=" in argv[0]:  # environment assignments
        argv.pop(0)
    assert argv[:2] == ["python", "-m"]
    module, args = argv[2], argv[3:]
    if module == "pytest":
        files = [a for a in args if a.startswith("tests/")]
        assert files and all((ROOT / f).exists() for f in files), files
        assert all(f.startswith("tests/test_torch_") for f in files)
        return
    entry = {"ai4e_tpu_torch.rig": "ai4e_tpu_torch.rig.__main__",
             "ai4e_tpu_torch": "ai4e_tpu_torch.cli"}[module]
    ns = parse_only(monkeypatch, entry, args)
    given = {a.lstrip("-").replace("-", "_").split("=")[0]
             for a in args if a.startswith("--")}
    assert given <= set(vars(ns)), given - set(vars(ns))
