"""The port's ``Trainer`` over a device mesh (``mesh=``, ``tp_rules=``)
against the JAX package's, mirroring ``tests/test_trainer_tp.py``.

JAX's side runs on the 8 virtual CPU devices ``conftest.py`` gives it; the
port's in gloo ranks, one process each (``tests/helpers/torch_ranks.py
train``), each group bounded by ``RANK_TIMEOUT_S`` and killed past it. Both
start from the same flax init, converted, and take the same numpy batches:

- a float32 ViT (image 16, patch 8, dim 32, depth 1, heads 2, 4 classes)
  at dp = 2 x tp = 2 (4 ranks), dp x fsdp x tp = 8 (8 ranks) and tp = 2
  (2 ranks, and again with ``remat``);
- a float32 SeqFormer through flash attention at dp = 2 (seq 256, input
  16, dim 32, depth 1, heads 2, as ``tests/test_pallas_ops.py``'s
  training case): JAX's kernel in interpret mode, the port's plain
  version on the CPU.

Tolerances: a tp layer adds its float32 partial products over the ranks,
one device adds them in one product, so the sums differ in order only:
2e-5 relative (JAX's own tp test's bound) at 4 ranks and for tp against
one device, 1e-4 at 8 ranks and for the SeqFormer, whose flash versions
(JAX's online softmax, the port's plain one) differ in order too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_parallel import RANK_TIMEOUT_S, run_ranks

from ai4e_tpu.models import VIT_TP_RULES
from ai4e_tpu.models.seqformer import SeqFormer as FlaxSeqFormer
from ai4e_tpu.models.seqformer import attention_for as jax_attention_for
from ai4e_tpu.models.seqformer import create_seqformer as jax_create_seqformer
from ai4e_tpu.models.vit import ViT as FlaxViT
from ai4e_tpu.parallel import MeshSpec as JaxMeshSpec
from ai4e_tpu.parallel import make_mesh as jax_make_mesh
from ai4e_tpu.train import Trainer as JaxTrainer
from ai4e_tpu.train import cross_entropy_loss as jax_cross_entropy
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.models.seqformer import SeqFormer, attention_for
from ai4e_tpu_torch.models.vit import ViT
from ai4e_tpu_torch.train import Trainer

VIT = dict(num_classes=4, patch=8, dim=32, depth=1, heads=2)
SEQ = dict(seq_len=256, input_dim=16, dim=32, depth=1, heads=2,
           num_classes=4)
TP_RTOL, MESH8_RTOL, SEQ_RTOL = 2e-5, 1e-4, 1e-4
STEPS = 2
SEQ_STEPS = 3


def vit_params() -> dict:
    model = FlaxViT(**VIT, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    return jax.tree.map(np.asarray, params)


def seq_params() -> dict:
    _, params = jax_create_seqformer(**SEQ, attention="flash")
    return jax.tree.map(np.asarray, params)


def images(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    x = np.random.default_rng(seed).uniform(size=(n, 16, 16, 3)).astype(
        np.float32)
    return x, (np.arange(n) % 4).astype(np.int32)


def sequences() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 256, 16)).astype(np.float32)
    return x, rng.integers(0, 4, 8).astype(np.int32)


def jax_run(model, params: dict, spec: JaxMeshSpec, rules, x, y,
            steps: int) -> tuple[list[float], object]:
    mesh = jax_make_mesh(spec, devices=jax.devices()[:spec.size])
    with mesh:
        trainer = JaxTrainer(model.apply, jax.tree.map(jnp.array, params),
                             mesh, loss_fn=jax_cross_entropy, tp_rules=rules)
        losses = [trainer.train_step(x, y) for _ in range(steps)]
    return losses, trainer


def port_single(params: dict, x, y, steps: int) -> list[float]:
    model = ViT(**VIT, image_size=16, dtype=torch.float32)
    model.load_state_dict(convert.vit_state_dict_from_flax(params))
    trainer = Trainer(model, device="cpu")
    return [trainer.train_step(x, y) for _ in range(steps)]


def flat_inputs(**trees) -> dict:
    out = {}
    for prefix, tree in trees.items():
        out.update({f"{prefix}/{k}": v
                    for k, v in convert.flatten_tree(tree).items()})
    return out


def vit_run(name: str, mesh: dict, batch: str, steps: int = STEPS,
            **extra) -> dict:
    return dict(name=name, model="vit", kwargs=dict(VIT, image_size=16),
                mesh=mesh, params="vit", batch=f"{batch}_x",
                labels=f"{batch}_y", steps=steps, **extra)


@pytest.fixture(scope="module")
def data() -> dict:
    return {"vit": vit_params(), "seq": seq_params(),
            "b4": images(4, 0), "b8": images(8, 0), "tp": images(4, 1),
            "seqs": sequences()}


def batches(data: dict, *names: str) -> dict:
    out = {}
    for name in names:
        out[f"{name}_x"], out[f"{name}_y"] = data[name]
    return out


@pytest.fixture(scope="module")
def world4(data, tmp_path_factory):
    case = {"train": [vit_run("dp2tp2", {"dp": 2, "tp": 2}, "b4")]}
    return run_ranks("train", 4, tmp_path_factory.mktemp("train4"),
                     dict(flat_inputs(vit=data["vit"]), **batches(data, "b4")),
                     case, timeout=RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def world8(data, tmp_path_factory):
    case = {"train": [vit_run("mesh8", {"dp": 2, "fsdp": 2, "tp": 2},
                              "b8")]}
    return run_ranks("train", 8, tmp_path_factory.mktemp("train8"),
                     dict(flat_inputs(vit=data["vit"]), **batches(data, "b8")),
                     case, timeout=RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def world2(data, tmp_path_factory):
    case = {"train": [
        vit_run("tp2", {"tp": 2}, "tp"),
        vit_run("tp2_remat", {"tp": 2}, "tp", remat=True),
        dict(name="seq_dp2", model="seqformer", kwargs=SEQ,
             mesh={"dp": 2}, params="seq", batch="seqs_x", labels="seqs_y",
             steps=SEQ_STEPS, odd_batch=True)],
        "refused": [{"sp": 2}, {"ep": 2}]}
    return run_ranks("train", 2, tmp_path_factory.mktemp("train2"),
                     dict(flat_inputs(vit=data["vit"], seq=data["seq"]),
                          **batches(data, "tp", "seqs")),
                     case, timeout=RANK_TIMEOUT_S)


def infos(ranks, name: str) -> list[dict]:
    return [info[name] for _, info in ranks]


class TestDataAndTensorParallel:
    """dp = 2 x tp = 2 (``test_dp_tp_step_shards_params``)."""

    def test_shards_and_moments_are_split_like_jax(self, world4, data):
        _, jax_trainer = jax_run(FlaxViT(**VIT, dtype=jnp.float32),
                                 data["vit"], JaxMeshSpec(dp=2, tp=2),
                                 VIT_TP_RULES, *data["b4"], 1)
        p = jax_trainer.params["params"]["block0"]["attn"]
        qkv, out = p["qkv"]["kernel"], p["out"]["kernel"]
        assert qkv.sharding.spec == P(None, "tp")
        jax_qkv = qkv.sharding.shard_shape(qkv.shape)      # (in, out / 2)
        jax_out = out.sharding.shard_shape(out.shape)      # (in / 2, out)
        mu = jax_trainer.opt_state[0].mu["params"]["block0"]["attn"]["qkv"][
            "kernel"]
        assert mu.sharding.spec == P(None, "tp")
        for info in infos(world4, "dp2tp2"):
            # torch's (out, in) weights: the transposed flax kernels.
            assert info["shapes"]["blocks.0.attn.qkv.weight"] == [
                jax_qkv[1], jax_qkv[0]] == [48, 32]
            assert info["shapes"]["blocks.0.attn.out.weight"] == [
                jax_out[1], jax_out[0]] == [32, 16]
            for key in ("blocks.0.attn.qkv.weight", "blocks.0.attn.out.weight",
                        "blocks.0.mlp.up.weight", "blocks.0.mlp.down.weight"):
                assert info["moment_shapes"][key] == info["shapes"][key]
            assert info["split"] == sorted(
                f"blocks.0.{k}.weight"
                for k in ("attn.qkv", "attn.out", "mlp.up", "mlp.down"))

    def test_replicated_gradients_are_equal_on_every_rank(self, world4):
        """After the data average every rank holds one gradient of each
        replicated parameter (the LayerNorms, the patch embedding,
        ``pos_embed``, the ``out``/``down`` biases, ``mlp/up``'s bias,
        summed over tp before it is sliced, and the head), bit for bit;
        a split one is equal across the ranks of its tp coordinate."""
        ranks = infos(world4, "dp2tp2")
        split = set(ranks[0]["split"])
        for step in range(STEPS):
            grads = [r["grads"][step] for r in ranks]
            for key in grads[0]:
                if key in split:
                    for tp in (0, 1):
                        same = {g[key] for g, r in zip(grads, ranks)
                                if r["coords"]["tp"] == tp}
                        assert len(same) == 1, (step, key, tp)
                else:
                    assert len({g[key] for g in grads}) == 1, (step, key)

    def test_losses_match_jax(self, world4, data):
        want, _ = jax_run(FlaxViT(**VIT, dtype=jnp.float32), data["vit"],
                          JaxMeshSpec(dp=2, tp=2), VIT_TP_RULES, *data["b4"],
                          STEPS)
        for info in infos(world4, "dp2tp2"):
            np.testing.assert_allclose(info["losses"], want, rtol=TP_RTOL)

    def test_step_reports_count_the_collectives(self, world4):
        """Each step: 2 forward and 3 backward tp all-reduces (the block's
        two inputs and ``mlp/up``'s bias) and one data average."""
        for info in infos(world4, "dp2tp2"):
            for report in info["reports"]:
                assert report["comm_calls"] == 6, report
                assert {"forward", "backward", "optimizer"} <= set(report)


class TestThreeAxisMesh:
    """dp x fsdp x tp = 8 (``test_dp_fsdp_tp_step_runs``)."""

    def test_second_step_lowers_the_loss(self, world8):
        for info in infos(world8, "mesh8"):
            first, second = info["losses"]
            assert np.isfinite(first) and second < first

    def test_losses_match_jax(self, world8, data):
        want, _ = jax_run(FlaxViT(**VIT, dtype=jnp.float32), data["vit"],
                          JaxMeshSpec(dp=2, fsdp=2, tp=2), VIT_TP_RULES,
                          *data["b8"], STEPS)
        for info in infos(world8, "mesh8"):
            np.testing.assert_allclose(info["losses"], want, rtol=MESH8_RTOL)

    def test_params_agree_across_the_data_axes(self, world8):
        ranks = infos(world8, "mesh8")
        for tp in (0, 1):
            same = [r["params"][-1] for r in ranks if r["coords"]["tp"] == tp]
            assert all(p == same[0] for p in same)


class TestTensorParallelMatchesOneDevice:
    """tp = 2 (``test_tp_matches_single_device``)."""

    def test_port_tp_equals_port_single_device(self, world2, data):
        want = port_single(data["vit"], *data["tp"], STEPS)
        for info in infos(world2, "tp2"):
            np.testing.assert_allclose(info["losses"], want, rtol=TP_RTOL)

    def test_jax_tp_equals_jax_single_device(self, data):
        model = FlaxViT(**VIT, dtype=jnp.float32)
        single, _ = jax_run(model, data["vit"], JaxMeshSpec(dp=1), None,
                            *data["tp"], STEPS)
        tp, _ = jax_run(model, data["vit"], JaxMeshSpec(tp=2), VIT_TP_RULES,
                        *data["tp"], STEPS)
        np.testing.assert_allclose(single, tp, rtol=TP_RTOL)

    def test_port_tp_equals_jax_tp(self, world2, data):
        want, _ = jax_run(FlaxViT(**VIT, dtype=jnp.float32), data["vit"],
                          JaxMeshSpec(tp=2), VIT_TP_RULES, *data["tp"], STEPS)
        for info in infos(world2, "tp2"):
            np.testing.assert_allclose(info["losses"], want, rtol=TP_RTOL)

    def test_remat_gives_the_same_steps(self, world2):
        """The recomputed forward runs its collectives again in the
        backward, on every rank alike: the same losses and parameters."""
        for plain, remat in zip(infos(world2, "tp2"),
                                infos(world2, "tp2_remat")):
            assert plain["losses"] == remat["losses"]
            assert plain["params"] == remat["params"]


class TestSeqFormerDataParallel:
    """The flash-attention SeqFormer at dp = 2 (the path ``chip_smoke.py``
    phase 22d runs on the card at longcontext's width)."""

    def test_losses_match_jax(self, world2, data):
        model = FlaxSeqFormer(**SEQ, dtype=jnp.float32,
                              attn_fn=jax_attention_for(None, "flash"))
        want, _ = jax_run(model, data["seq"], JaxMeshSpec(dp=2), None,
                          *data["seqs"], SEQ_STEPS)
        for info in infos(world2, "seq_dp2"):
            np.testing.assert_allclose(info["losses"], want, rtol=SEQ_RTOL)

    def test_params_are_bit_equal_on_both_ranks(self, world2):
        a, b = infos(world2, "seq_dp2")
        assert len(a["params"]) == SEQ_STEPS
        assert a["params"] == b["params"]
        assert a["losses"] == b["losses"]

    def test_a_batch_that_does_not_divide_raises(self, world2):
        for info in infos(world2, "seq_dp2"):
            assert "does not split over 2" in info["odd_batch"]

    def test_one_step_equals_one_device_on_the_whole_batch(self, data):
        """The port's dp = 2 first loss is one device's mean over all 8."""
        model = SeqFormer(**SEQ, dtype=torch.float32,
                          attn_fn=attention_for(None, "flash"))
        model.load_state_dict(convert.seqformer_state_dict_from_flax(
            data["seq"]))
        loss = Trainer(model, device="cpu").train_step(*data["seqs"])
        jax_model = FlaxSeqFormer(**SEQ, dtype=jnp.float32,
                                  attn_fn=jax_attention_for(None, "flash"))
        want, _ = jax_run(jax_model, data["seq"], JaxMeshSpec(), None,
                          *data["seqs"], 1)
        assert loss == pytest.approx(want[0], rel=SEQ_RTOL)


class TestRefusedMeshes:
    @pytest.mark.parametrize("index,axis", [(0, "sp=2"), (1, "ep=2")])
    def test_sp_and_ep_name_a15_2(self, world2, index, axis):
        for _, info in world2:
            assert "A15.2" in info["refused"][index]
            assert axis in info["refused"][index]

    def test_tp_rules_without_a_mesh_raise(self):
        with pytest.raises(ValueError, match="mesh"):
            Trainer(torch.nn.Linear(2, 2), device="cpu", tp_rules={})
