"""One gloo rank of the port's parallel-plane tests (no JAX here):
``torch_ranks.py <scenario> <rank> <world> <port> <dir>``.

The test process writes ``<dir>/inputs.npz`` (and ``<dir>/case.json``);
each rank joins the process group through ``init_distributed`` (the
standard ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``), runs the
scenario and writes ``<dir>/rank<r>.npz`` (and ``rank<r>.json``), which
the test holds against the JAX package's results.
"""

import asyncio
import json
import os
import sys

scenario, rank, world, port, out_dir = (sys.argv[1], int(sys.argv[2]),
                                        int(sys.argv[3]), sys.argv[4],
                                        sys.argv[5])
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                  WORLD_SIZE=str(world), RANK=str(rank))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ai4e_tpu_torch.parallel.sharding import (  # noqa: E402
    MeshSpec, init_distributed, make_mesh, mesh_shape, rank_coords,
    shard_params)

torch.set_num_threads(1)
inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
with open(os.path.join(out_dir, "case.json")) as fh:
    case = json.load(fh)
out: dict = {}
info: dict = {}


def chunk(x: np.ndarray, n: int, i: int) -> torch.Tensor:
    """Chunk ``i`` of ``n`` of a (B, H, S, D) array's sequence."""
    c = x.shape[2] // n
    return torch.from_numpy(np.ascontiguousarray(x[:, :, i * c:(i + 1) * c]))


def unflatten(prefix: str) -> dict:
    from ai4e_tpu_torch.convert import unflatten_tree
    return unflatten_tree({k[len(prefix):]: v for k, v in inputs.items()
                           if k.startswith(prefix)})


def parallel() -> None:
    """Meshes, shards, ring and Ulysses at sp = world."""
    from ai4e_tpu_torch.parallel.ring_attention import (ring_attention,
                                                        ulysses_attention)
    mesh = make_mesh(MeshSpec(sp=world), device_type="cpu")
    info["names"] = list(mesh.mesh_dim_names)
    info["shape"] = mesh_shape(mesh)
    mixed = make_mesh(MeshSpec(dp=2, sp=world // 2), device_type="cpu")
    info["mixed_coords"] = [rank_coords(mixed, r) for r in range(world)]
    for causal in (False, True):
        args = [chunk(inputs[k], world, rank) for k in "qkv"]
        out[f"ring_{int(causal)}"] = ring_attention(
            *args, mesh, causal=causal).numpy()
        out[f"ulysses_{int(causal)}"] = ulysses_attention(
            *args, mesh, causal=causal).numpy()
    p = chunk(inputs["prefix"], world, rank)
    out["prefix"] = ring_attention(p, p, p, mesh, causal=True).numpy()
    three = chunk(inputs["heads3"], world, rank)
    try:
        ulysses_attention(three, three, three, mesh)
    except ValueError as exc:
        info["heads3"] = str(exc)
    tp_mesh = make_mesh(MeshSpec(tp=world), device_type="cpu")
    tree = unflatten("tree/")
    for form in ("dict", "regex"):
        rules = case["rules"][form]
        if form == "regex":
            rules = [(pat, tuple(spec)) for pat, spec in rules]
        else:
            rules = {k: tuple(v) for k, v in rules.items()}
        from ai4e_tpu_torch.convert import flatten_tree
        for key, leaf in flatten_tree(shard_params(tree, tp_mesh,
                                                   rules)).items():
            out[f"shard_{form}/{key}"] = leaf


def run_model(family: str, mesh, params: dict, batch: np.ndarray,
              kwargs: dict, reload: dict | None = None) -> np.ndarray:
    """``family`` on ``mesh`` with ``params``; with ``reload``, the
    outputs after ``reload_params`` swapped those weights in."""
    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.runtime.registry import ModelRuntime
    servable = build_servable(family, mesh=mesh, **kwargs)
    servable.module.load_state_dict(servable.state_dict_from_flax(params))
    runtime = ModelRuntime("cpu", mesh=mesh)
    runtime.register(servable)
    info.setdefault("buckets", {})[family] = list(servable.batch_buckets)
    info.setdefault("local_shapes", {})[family] = {
        k: list(v.shape) for k, v in servable.module.state_dict().items()
        if k.endswith(("moe.up", "attn.qkv.weight", "mlp.down.weight"))}
    if reload is not None:
        runtime.reload_params(servable.name, reload)
    return runtime.run_batch(servable.name, batch)


def models() -> None:
    """The SeqFormer at sp = 2 (ring and Ulysses), the MoE at ep = 2 and
    the ViT at tp = 2 on the test's converted weights, then a dp = 2 mesh
    endpoint through ``build_worker`` (rank 0 serves, rank 1 mirrors)."""
    sp = make_mesh(MeshSpec(sp=2), device_type="cpu")
    for attention in ("ring", "ulysses"):
        out[f"seqformer_{attention}"] = run_model(
            "seqformer", sp, unflatten("seqformer/"), inputs["seq_batch"],
            dict(case["seqformer"], attention=attention))
    ep = make_mesh(MeshSpec(ep=2), device_type="cpu")
    out["moe"] = run_model("moe", ep, unflatten("moe/"), inputs["moe_batch"],
                           case["moe"])
    out["moe_reloaded"] = run_model(
        "moe", ep, unflatten("moe/"), inputs["moe_batch"], case["moe"],
        reload=unflatten("moe_reload/"))
    out["vit"] = run_model(
        "vit", make_mesh(MeshSpec(tp=2), device_type="cpu"),
        unflatten("vit/"), inputs["vit_batch"], case["vit"])
    endpoint()


def endpoint() -> None:
    from ai4e_tpu_torch.cli import build_worker
    from ai4e_tpu_torch.config import FrameworkConfig
    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.runtime.registry import ModelRuntime

    config = FrameworkConfig()
    config.runtime.mesh_spec = "dp=2"
    spec = case["endpoint"]
    worker, batcher, _ = build_worker(spec, device="cpu", config=config)
    if rank:
        worker.runtime.follower_loop()
        return
    name = spec["models"][0]["name"]
    batch = inputs["endpoint_batch"]
    meshed, poisoned = worker.runtime.run_batch_report(name, batch)
    info["poisoned"] = sorted(poisoned)
    out["endpoint_meshed"] = meshed
    oracle = ModelRuntime("cpu")
    kwargs = dict(spec["models"][0])
    kwargs.pop("async_path", None)
    servable = build_servable(kwargs.pop("family"), **kwargs)
    oracle.register(servable)
    out["endpoint_oracle"] = oracle.run_batch(name, batch)
    info["describe"] = worker.runtime.describe()
    info["tier"] = worker.runtime.layout.tier_label
    info["egress"] = worker.runtime.last_egress_bytes

    async def models_entry():
        from aiohttp.test_utils import TestClient, TestServer
        client = TestClient(TestServer(worker.service.app))
        await client.start_server()
        try:
            resp = await client.get(f"/{spec['prefix']}/models")
            return await resp.json()
        finally:
            await client.close()

    info["models"] = asyncio.run(models_entry())
    worker.runtime.shutdown_followers()


def digest(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


def train_model(run: dict, mesh):
    """The run's model (float32) on the test's converted flax weights, and
    the rules its trainer shards it by. A SeqFormer or MoE run's
    ``attention`` (default ``flash``) may be ``ring`` or ``ulysses`` over
    the mesh's sp; a MoE run shards its experts over the mesh's ep. With
    ``drop_partial`` the model names no partial gradients, so the trainer
    sums nothing over sp or ep (the tests' mutation)."""
    from ai4e_tpu_torch import convert
    from ai4e_tpu_torch.models.moe import MOE_EP_RULES, MoEClassifier
    from ai4e_tpu_torch.models.seqformer import (SeqFormer, attention_for,
                                                 sequence_mesh)
    from ai4e_tpu_torch.models.vit import TP_RULES, ViT
    shape = mesh_shape(mesh)
    params = unflatten(run["params"] + "/")
    if run["model"] == "vit":
        model = ViT(**run["kwargs"], dtype=torch.float32,
                    tp_mesh=mesh if shape["tp"] > 1 else None)
        model.load_state_dict(convert.vit_state_dict_from_flax(params))
        return model, TP_RULES if shape["tp"] > 1 else None
    attention = run.get("attention", "flash")
    common = dict(dtype=torch.float32, attn_fn=attention_for(mesh, attention),
                  seq_mesh=sequence_mesh(mesh, attention))
    if run["model"] == "moe":
        model = MoEClassifier(**run["kwargs"], **common,
                              ep_mesh=mesh if shape["ep"] > 1 else None)
        model.load_state_dict(convert.moe_state_dict_from_flax(params))
        rules = MOE_EP_RULES if shape["ep"] > 1 else None
    else:
        model = SeqFormer(**run["kwargs"], **common)
        model.load_state_dict(convert.seqformer_state_dict_from_flax(params))
        rules = None
    if run.get("drop_partial"):
        model.partial_grad_axes = dict
    return model, rules


def resume_check(run: dict, mesh, mgr, trainer, rec: dict) -> None:
    """A fresh trainer of the run resumed from ``mgr``: its step, whether
    its parameters and moments equal ``trainer``'s bit for bit, and the
    next step's loss of each."""
    from ai4e_tpu_torch.checkpoint import resume_trainer
    from ai4e_tpu_torch.train import Trainer
    from ai4e_tpu_torch.train.step import adamw

    model, rules = train_model(run, mesh)
    fresh = Trainer(model, device="cpu", mesh=mesh, tp_rules=rules,
                    optimizer=lambda p: adamw(p, lr=run["lr"]))
    rec["resumed_step"] = resume_trainer(mgr, fresh)
    rec["resumed_equal"] = (
        {k: digest(t) for k, t in fresh.params.items()}
        == {k: digest(t) for k, t in trainer.params.items()}
        and all({k: digest(t) for k, t in fresh.opt_state[sk].items()}
                == {k: digest(t) for k, t in trainer.opt_state[sk].items()}
                for sk in ("exp_avg", "exp_avg_sq")))
    images, labels = inputs[run["batch"]], inputs[run["labels"]]
    rec["next_losses"] = [trainer.train_step(images, labels),
                          fresh.train_step(images, labels)]


def train() -> None:
    """Each of ``case["train"]``'s runs: a ``Trainer`` over its mesh for
    its steps on one batch, recording losses, local shapes, each step's
    parameter and gradient digests and, where the run saves, the gathered
    state (rank 0) and a ``save_trainer`` checkpoint after that step; then
    the refusal of each mesh in ``case["refused"]``."""
    from ai4e_tpu_torch.checkpoint import CheckpointManager, save_trainer
    from ai4e_tpu_torch.train import Trainer
    from ai4e_tpu_torch.train.step import adamw

    for run in case["train"]:
        name = run["name"]
        mesh = make_mesh(MeshSpec(**run["mesh"]), device_type="cpu")
        model, rules = train_model(run, mesh)
        optimizer = (None if "lr" not in run
                     else lambda p, lr=run["lr"]: adamw(p, lr=lr))
        trainer = Trainer(model, device="cpu", mesh=mesh, tp_rules=rules,
                          remat=run.get("remat", False), optimizer=optimizer)
        images, labels = inputs[run["batch"]], inputs[run["labels"]]
        rec = info.setdefault(name, {"losses": [], "params": [], "grads": [],
                                     "reports": []})
        rec["coords"] = rank_coords(mesh)
        rec["split"] = sorted(trainer.split)
        for step in range(1, run["steps"] + 1):
            loss, report = trainer.train_step_phases(images, labels)
            rec["losses"].append(loss)
            rec["reports"].append(report)
            rec["params"].append({k: digest(p) for k, p in
                                  trainer.params.items()})
            rec["grads"].append({k: digest(p.grad) for k, p in
                                 trainer.model.named_parameters()})
            if step == run.get("save_after"):
                params, state = trainer.gather_state()
                mgr = CheckpointManager(os.path.join(out_dir, name))
                rec["saved"] = save_trainer(mgr, trainer, step)
                if rank == 0:
                    for key, t in params.items():
                        out[f"{name}/params/{key}"] = t.numpy().copy()
                    for sk, by_name in state.items():
                        for key, t in by_name.items():
                            out[f"{name}/opt/{sk}/{key}"] = t.numpy().copy()
                if run.get("resume"):
                    resume_check(run, mesh, mgr, trainer, rec)
        if run.get("odd_batch"):
            try:
                trainer.train_step(images[:3], labels[:3])
            except ValueError as exc:
                rec["odd_batch"] = str(exc)
        rec["shapes"] = {k: list(p.shape) for k, p in trainer.params.items()}
        rec["moment_shapes"] = {
            k: list(t.shape) for k, t in trainer.opt_state["exp_avg"].items()}
    for spec in case.get("refused", []):
        mesh = make_mesh(MeshSpec(**spec), device_type="cpu")
        try:
            Trainer(torch.nn.Linear(2, 2), device="cpu", mesh=mesh)
        except NotImplementedError as exc:
            info.setdefault("refused", []).append(str(exc))


init_distributed("cpu")
assert dist.get_world_size() == world
{"parallel": parallel, "models": models, "train": train}[scenario]()
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
    json.dump(info, fh)
dist.destroy_process_group()
print(f"RANK_OK {rank}", flush=True)
