"""The port's parallel plane (``ai4e_tpu_torch.parallel``) against the JAX
package's: ``MeshSpec`` and ``make_mesh``, ``spec_for_param`` and
``shard_params`` in both rule forms, ring attention and Ulysses at sp = 2
and 4, causal and not, with the refusal of indivisible heads (mirroring
``tests/test_ring_attention.py``).

JAX's side runs on the 8 virtual CPU devices ``conftest.py`` gives it; the
port's in gloo ranks, one process each (``tests/helpers/torch_ranks.py``),
one process group a world size, each bounded by ``RANK_TIMEOUT_S`` and
killed past it. Tolerance: the port's ring runs the flash forward's plain
version in float32 a block and merges the blocks by their logsumexp, JAX's
an online softmax over float32 ``einsum``: the same sums in another order,
within JAX's own test's rtol 2e-4, atol 2e-5."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from ai4e_tpu.parallel import MeshSpec as JaxMeshSpec
from ai4e_tpu.parallel import make_mesh as jax_make_mesh
from ai4e_tpu.parallel import shard_params as jax_shard_params
from ai4e_tpu.parallel import spec_for_param as jax_spec_for_param
from ai4e_tpu.parallel.ring_attention import ring_attention as jax_ring
from ai4e_tpu.parallel.ring_attention import ulysses_attention as jax_ulysses
from ai4e_tpu_torch.parallel import sharding
from ai4e_tpu_torch.parallel.sharding import (MESH_AXES, MeshSpec,
                                              shard_params, spec_for_param)

ROOT = Path(__file__).resolve().parent.parent
RANKS = ROOT / "tests" / "helpers" / "torch_ranks.py"
RANK_TIMEOUT_S = 240
B, H, S, D = 2, 4, 64, 16
RTOL, ATOL = 2e-4, 2e-5

#: The rules both packages shard ``TREE`` by, in both forms (the port's
#: specs are tuples; JAX's the same tuples as PartitionSpecs).
DICT_RULES = {"attn/qkv/kernel": (None, "tp"), "mlp/down/kernel": ("tp", None),
              "experts": ("tp", None, None)}
REGEX_RULES = [(r"qkv/kernel$", (None, "tp")), (r"experts$", ("tp",)),
               (r".*", ())]


def tree() -> dict:
    g = np.random.default_rng(3)
    mk = lambda *s: g.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"params": {
        "attn": {"qkv": {"kernel": mk(8, 24)}, "out": {"kernel": mk(8, 8)}},
        "mlp": {"down": {"kernel": mk(32, 8), "bias": mk(8)}},
        "experts": mk(8, 4, 4), "scale": np.float32(2.0)}}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(scenario: str, world: int, io_dir: Path, inputs: dict,
              case: dict, env: dict | None = None,
              timeout: float = RANK_TIMEOUT_S) -> list[tuple[dict, dict]]:
    """Run ``world`` gloo ranks of ``scenario`` and return each rank's
    ``(arrays, info)``. The group gets ``timeout`` seconds; a rank still
    running then is killed and the test fails with every rank's output."""
    io_dir.mkdir(parents=True, exist_ok=True)
    np.savez(io_dir / "inputs.npz", **inputs)
    (io_dir / "case.json").write_text(json.dumps(case))
    port = str(free_port())
    run_env = dict(os.environ, **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, str(RANKS), scenario, str(r), str(world), port,
         str(io_dir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=run_env, cwd=ROOT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                out = b"(killed: past the group's timeout)"
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    report = "\n".join(f"--- rank {r} rc={p.returncode}\n{log[-4000:]}"
                       for r, (p, log) in enumerate(zip(procs, logs)))
    assert all(p.returncode == 0 for p in procs), report
    return [(dict(np.load(io_dir / f"rank{r}.npz")),
             json.loads((io_dir / f"rank{r}.json").read_text()))
            for r in range(world)]


def qkv_inputs() -> dict:
    g = np.random.default_rng(0)
    mk = lambda *s: g.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"q": mk(B, H, S, D), "k": mk(B, H, S, D), "v": mk(B, H, S, D),
            "prefix": np.random.default_rng(1).standard_normal(
                (1, 1, S, D)).astype(np.float32),
            "heads3": np.zeros((1, 3, S, D), np.float32)}


@pytest.fixture(scope="module", params=[2, 4], ids=["sp2", "sp4"])
def group(request, tmp_path_factory):
    world = request.param
    inputs = qkv_inputs()
    from ai4e_tpu_torch.convert import flatten_tree
    inputs.update({f"tree/{k}": v for k, v in flatten_tree(tree()).items()})
    ranks = run_ranks("parallel", world,
                      tmp_path_factory.mktemp(f"parallel{world}"), inputs,
                      {"rules": {"dict": DICT_RULES, "regex": REGEX_RULES}})
    return world, inputs, ranks


def gathered(ranks, key: str) -> np.ndarray:
    """The ranks' sequence chunks of one output, in rank order."""
    return np.concatenate([arrays[key] for arrays, _ in ranks], axis=2)


def jax_sp_mesh(world: int):
    return jax_make_mesh(JaxMeshSpec(sp=world), devices=jax.devices()[:world])


class TestMeshSpecAndMesh:
    def test_mesh_spec_is_jax_s(self):
        assert ([f.name for f in __import__("dataclasses").fields(MeshSpec)]
                == [f.name for f in __import__("dataclasses").fields(
                    JaxMeshSpec)])
        for spec in (MeshSpec(dp=2, tp=2), MeshSpec.auto(8, 2, 2),
                     MeshSpec.data_parallel(4)):
            want = JaxMeshSpec(**spec.__dict__)
            assert spec.size == want.size
        assert MeshSpec.auto(8, 2, 2) == MeshSpec(dp=2, tp=2, sp=2)
        with pytest.raises(ValueError, match="not divisible"):
            MeshSpec.auto(6, 4)
        assert sharding.AXES == ("dp", "fsdp", "tp", "sp", "ep")

    def test_make_mesh_axis_order_and_coordinates_are_jax_s(self, group):
        world, _, ranks = group
        jax_mesh = jax_sp_mesh(world)
        assert tuple(jax_mesh.axis_names) == MESH_AXES
        for _, info in ranks:
            assert tuple(info["names"]) == MESH_AXES
            assert info["shape"] == dict(jax_mesh.shape)
        # dp=2 x sp=world/2: rank r sits where JAX puts device r.
        mixed = jax_make_mesh(JaxMeshSpec(dp=2, sp=world // 2),
                              devices=jax.devices()[:world])
        ids = np.vectorize(lambda d: d.id)(mixed.devices)
        for r, coords in enumerate(ranks[0][1]["mixed_coords"]):
            where = dict(zip(mixed.axis_names,
                             (int(i[0]) for i in np.nonzero(ids == r))))
            assert coords == where

    def test_make_mesh_needs_the_ranks_it_names(self):
        with pytest.raises(ValueError, match="needs 2 ranks, got 1"):
            sharding.make_mesh(MeshSpec(dp=2))


class ShapeMesh:
    """A stand-in for a ``DeviceMesh`` of the given axis sizes (for the
    functions that read only its shape)."""

    def __init__(self, **axes):
        self.axes = axes

    def size(self, dim=None):
        return self.axes.get(MESH_AXES[dim], 1)


class TestSpecsAndShards:
    @pytest.mark.parametrize("form", ["dict", "regex"])
    def test_spec_for_param_matches_jax(self, form):
        port_rules = DICT_RULES if form == "dict" else REGEX_RULES
        jax_rules = ({k: P(*v) for k, v in DICT_RULES.items()}
                     if form == "dict"
                     else [(pat, P(*spec)) for pat, spec in REGEX_RULES])
        from ai4e_tpu_torch.convert import flatten_tree
        for key, leaf in flatten_tree(tree()).items():
            path = tuple(key.split("/"))
            assert spec_for_param(path, leaf, port_rules) == tuple(
                jax_spec_for_param(path, leaf, jax_rules)), key

    def test_incomplete_regex_rules_raise_as_jax_s(self):
        leaf = np.zeros((4, 4))
        with pytest.raises(ValueError, match="no partition rule") as want:
            jax_spec_for_param(("a", "b"), leaf, [(r"x$", P())])
        with pytest.raises(ValueError, match="no partition rule") as got:
            spec_for_param(("a", "b"), leaf, [(r"x$", ())])
        assert str(got.value).split(" — ")[0] == str(want.value).split(
            " — ")[0]
        assert spec_for_param(("s",), np.float32(1), [(r"x$", ())]) == ()

    @pytest.mark.parametrize("form", ["dict", "regex"])
    @pytest.mark.parametrize("world", [2, 4])
    def test_shard_params_are_jax_s_device_shards(self, form, world):
        """Rank r's shard is the data of JAX's shard on device r of a
        tp=world mesh."""
        jax_rules = ({k: P(*v) for k, v in DICT_RULES.items()}
                     if form == "dict"
                     else [(pat, P(*spec)) for pat, spec in REGEX_RULES])
        mesh = jax_make_mesh(JaxMeshSpec(tp=world),
                             devices=jax.devices()[:world])
        placed = jax_shard_params(tree(), mesh, jax_rules)
        port_rules = DICT_RULES if form == "dict" else REGEX_RULES
        from ai4e_tpu_torch.convert import flatten_tree
        want = flatten_tree(jax.tree.map(
            lambda a: {str(s.device.id): np.asarray(s.data)
                       for s in a.addressable_shards}, placed,
            is_leaf=lambda a: hasattr(a, "addressable_shards")))
        for r in range(world):
            got = flatten_tree(shard_params(tree(), ShapeMesh(tp=world),
                                            port_rules, rank=r))
            for key, leaf in got.items():
                np.testing.assert_array_equal(leaf, want[f"{key}/{r}"])

    def test_shard_params_in_ranks_equal_the_rank_arguments(self, group):
        world, _, ranks = group
        from ai4e_tpu_torch.convert import flatten_tree
        for form, rules in (("dict", DICT_RULES), ("regex", REGEX_RULES)):
            for r, (arrays, _) in enumerate(ranks):
                want = flatten_tree(shard_params(
                    tree(), ShapeMesh(tp=world), rules, rank=r))
                for key, leaf in want.items():
                    np.testing.assert_array_equal(
                        arrays[f"shard_{form}/{key}"], leaf)

    def test_batch_and_replicated_specs(self):
        assert sharding.batch_sharding(None, 3) == (("dp", "fsdp"), None,
                                                    None)
        assert sharding.replicated(None) == ()
        assert sharding.pad_to_multiple(5, 4) == 8


class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True],
                             ids=["full", "causal"])
    def test_matches_jax_ring(self, group, causal):
        world, inputs, ranks = group
        q, k, v = (jnp.asarray(inputs[n]) for n in "qkv")
        want = np.asarray(jax_ring(q, k, v, jax_sp_mesh(world),
                                   causal=causal))
        np.testing.assert_allclose(gathered(ranks, f"ring_{int(causal)}"),
                                   want, rtol=RTOL, atol=ATOL)

    def test_no_nans_with_long_prefix_masked(self, group):
        world, inputs, ranks = group
        got = gathered(ranks, "prefix")
        assert np.isfinite(got).all()
        p = jnp.asarray(inputs["prefix"])
        want = np.asarray(jax_ring(p, p, p, jax_sp_mesh(world), causal=True))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


class TestUlysses:
    @pytest.mark.parametrize("causal", [False, True],
                             ids=["full", "causal"])
    def test_matches_jax_ulysses(self, group, causal):
        world, inputs, ranks = group
        q, k, v = (jnp.asarray(inputs[n]) for n in "qkv")
        want = np.asarray(jax_ulysses(q, k, v, jax_sp_mesh(world),
                                      causal=causal))
        np.testing.assert_allclose(
            gathered(ranks, f"ulysses_{int(causal)}"), want, rtol=RTOL,
            atol=ATOL)

    def test_rejects_indivisible_heads_as_jax_does(self, group):
        world, _, ranks = group
        q = jnp.zeros((1, 3, S, D))
        with pytest.raises(ValueError) as want:
            jax_ulysses(q, q, q, jax_sp_mesh(world))
        for _, info in ranks:
            assert info["heads3"] == str(want.value)
