"""The port's ``Trainer`` over sp and ep meshes against the JAX package's.

JAX's ``Trainer`` differentiates ring and Ulysses attention (plain ``jnp``
inside ``shard_map``) and the MoE's psum over ep itself, on the 8 virtual
CPU devices ``conftest.py`` gives it. The port writes those backwards out
(``parallel/ring_attention._RingAttention``, ``comm.all_to_all``'s
inverse exchange, ``comm.reduce_from`` at the pool and the MoE combine,
``comm.copy_to`` at the MoE input) and its trainer sums the gradients a
rank holds only part of over sp or ep (``partial_grad_axes``). It runs in
gloo ranks, one process each (``tests/helpers/torch_ranks.py train``).
Both start from the same flax init, converted, take the same numpy batch
and step AdamW at lr 1e-2 (large enough that a wrong gradient shows in
three steps):

- a float32 SeqFormer (seq 64, input 16, dim 32, depth 1, heads 2) at
  sp = 2 with ring and with Ulysses attention, and at dp = 2 x sp = 2 with
  ring (4 ranks); the port's blocks through its flash attention's plain
  version on the CPU;
- a float32 MoE classifier (4 experts) at ep = 2 in both dispatches, JAX
  on full attention, the port on its flash attention's plain version.

Tolerances: losses within ``LOSS_RTOL`` (1e-4) relative and every
parameter after three steps within ``PARAM_ATOL`` (1e-4) of JAX's: float32
sums in another order (the ring merges blocks by their logsumexp, JAX
rescales online; the port's attention materialises its scores) grow
through three AdamW steps. Replicated parameters are bit-equal on every
rank after every step. The mutation check drops the sums over sp and ep
(``drop_partial``): every replicated gradient is then rank 0's part, the
ranks still agree bit for bit, and the losses leave JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from test_torch_parallel import RANK_TIMEOUT_S, run_ranks
from test_torch_trainer_tp import flat_inputs

from ai4e_tpu.models.moe import MOE_EP_RULES as JAX_MOE_EP_RULES
from ai4e_tpu.models.moe import MoEClassifier as FlaxMoE
from ai4e_tpu.models.seqformer import SeqFormer as FlaxSeqFormer
from ai4e_tpu.models.seqformer import attention_for as jax_attention_for
from ai4e_tpu.parallel import MeshSpec as JaxMeshSpec
from ai4e_tpu.parallel import make_mesh as jax_make_mesh
from ai4e_tpu.train import Trainer as JaxTrainer
from ai4e_tpu.train import cross_entropy_loss as jax_cross_entropy
from ai4e_tpu_torch import convert

SEQ = dict(seq_len=64, input_dim=16, dim=32, depth=1, heads=2,
           num_classes=4)
MOE = dict(SEQ, num_experts=4)
LR = 1e-2
STEPS = 3
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4


def batch() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 64, 16)).astype(np.float32)
    return x, rng.integers(0, 4, 4).astype(np.int32)


def jax_model(kind: str, mesh, attention: str, dispatch: str = "dense"):
    if kind == "moe":
        return FlaxMoE(**MOE, dtype=jnp.float32, dispatch=dispatch,
                       attn_fn=jax_attention_for(mesh, attention))
    return FlaxSeqFormer(**SEQ, dtype=jnp.float32,
                         attn_fn=jax_attention_for(mesh, attention))


def init_params(kind: str) -> dict:
    model = jax_model(kind, None, "full")
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((4, 64, 16)))
    return jax.tree.map(np.asarray, params)


def jax_train(kind: str, params: dict, spec: JaxMeshSpec, attention: str,
              dispatch: str = "dense") -> tuple[list[float], dict]:
    """JAX's losses over ``STEPS`` and its parameters after them."""
    mesh = jax_make_mesh(spec, devices=jax.devices()[:spec.size])
    model = jax_model(kind, mesh, attention, dispatch)
    with mesh:
        trainer = JaxTrainer(model.apply, jax.tree.map(jnp.array, params),
                             mesh, loss_fn=jax_cross_entropy,
                             optimizer=optax.adamw(LR, weight_decay=1e-4),
                             tp_rules=JAX_MOE_EP_RULES if kind == "moe"
                             else None)
        losses = [trainer.train_step(*batch()) for _ in range(STEPS)]
    return losses, jax.tree.map(np.asarray, trainer.params)


def run(name: str, kind: str, mesh: dict, attention: str = "flash",
        dispatch: str | None = None, **extra) -> dict:
    kwargs = dict(MOE if kind == "moe" else SEQ)
    if dispatch:
        kwargs["dispatch"] = dispatch
    return dict(name=name, model=kind, kwargs=kwargs, mesh=mesh,
                attention=attention, params=kind, batch="x", labels="y",
                steps=STEPS, save_after=STEPS, lr=LR, **extra)


@pytest.fixture(scope="module")
def params() -> dict:
    return {"seq": init_params("seq"), "moe": init_params("moe")}


def inputs(params: dict) -> dict:
    x, y = batch()
    return dict(flat_inputs(seq=params["seq"], moe=params["moe"]), x=x, y=y)


@pytest.fixture(scope="module")
def world2(params, tmp_path_factory):
    case = {"train": [
        run("sp_ring", "seq", {"sp": 2}, "ring"),
        run("sp_ulysses", "seq", {"sp": 2}, "ulysses"),
        run("ep_dense", "moe", {"ep": 2}, dispatch="dense", resume=True),
        run("ep_capacity", "moe", {"ep": 2}, dispatch="capacity"),
        run("sp_ring_unsummed", "seq", {"sp": 2}, "ring", drop_partial=True),
        run("ep_dense_unsummed", "moe", {"ep": 2}, dispatch="dense",
            drop_partial=True)]}
    return run_ranks("train", 2, tmp_path_factory.mktemp("train_sp_ep2"),
                     inputs(params), case, timeout=RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def world4(params, tmp_path_factory):
    case = {"train": [run("dp2_sp2", "seq", {"dp": 2, "sp": 2}, "ring")]}
    return run_ranks("train", 4, tmp_path_factory.mktemp("train_sp_ep4"),
                     inputs(params), case, timeout=RANK_TIMEOUT_S)


#: (run name, world fixture, model, JAX mesh, JAX attention, dispatch)
CASES = {
    "sp_ring": ("world2", "seq", JaxMeshSpec(sp=2), "ring", "dense"),
    "sp_ulysses": ("world2", "seq", JaxMeshSpec(sp=2), "ulysses", "dense"),
    "ep_dense": ("world2", "moe", JaxMeshSpec(ep=2), "full", "dense"),
    "ep_capacity": ("world2", "moe", JaxMeshSpec(ep=2), "full", "capacity"),
    "dp2_sp2": ("world4", "seq", JaxMeshSpec(dp=2, sp=2), "ring", "dense"),
}


@pytest.fixture(scope="module")
def jax_results(params) -> dict:
    return {name: jax_train(kind, params[kind], spec, attention, dispatch)
            for name, (_, kind, spec, attention, dispatch) in CASES.items()}


def ranks_of(request, name: str) -> list[tuple[dict, dict]]:
    return request.getfixturevalue(CASES[name][0])


def state_dict_of(kind: str, params: dict) -> dict:
    if kind == "moe":
        return convert.moe_state_dict_from_flax(params)
    return convert.seqformer_state_dict_from_flax(params)


@pytest.mark.parametrize("name", sorted(CASES))
class TestAgainstJax:
    def test_losses_match_jax(self, request, jax_results, name):
        want, _ = jax_results[name]
        for _, info in ranks_of(request, name):
            np.testing.assert_allclose(info[name]["losses"], want,
                                       rtol=LOSS_RTOL)

    def test_parameters_match_jax_after_three_steps(self, request,
                                                    jax_results, name):
        """Rank 0's gathered parameters (the experts whole) against JAX's,
        converted to the port's keys."""
        _, params = jax_results[name]
        want = state_dict_of(CASES[name][1], params)
        arrays, _ = ranks_of(request, name)[0]
        for key, value in want.items():
            got = arrays[f"{name}/params/{key}"]
            np.testing.assert_allclose(got, value.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)

    def test_replicated_parameters_are_bit_equal_on_every_rank(
            self, request, name):
        infos = [info[name] for _, info in ranks_of(request, name)]
        split = set(infos[0]["split"])
        for step in range(STEPS):
            for key in infos[0]["params"][step]:
                if key in split:
                    continue
                assert len({r["params"][step][key] for r in infos}) == 1, (
                    step, key)


class TestExpertParallel:
    def test_experts_are_split_and_the_router_is_not(self, world2):
        for _, info in world2:
            rec = info["ep_dense"]
            assert rec["split"] == ["blocks.0.moe.down", "blocks.0.moe.up"]
            assert rec["shapes"]["blocks.0.moe.up"] == [2, 32, 128]
            assert rec["moment_shapes"]["blocks.0.moe.up"] == [2, 32, 128]

    def test_expert_shards_differ_between_ranks(self, world2):
        a, b = (info["ep_dense"]["params"][-1] for _, info in world2)
        assert a["blocks.0.moe.up"] != b["blocks.0.moe.up"]

    def test_checkpoint_gathers_whole_experts_and_resumes(self, world2):
        arrays, _ = world2[0]
        assert arrays["ep_dense/params/blocks.0.moe.up"].shape == (4, 32, 128)
        assert arrays["ep_dense/opt/exp_avg/blocks.0.moe.up"].shape == (
            4, 32, 128)
        for _, info in world2:
            rec = info["ep_dense"]
            assert rec["saved"] is True
            assert rec["resumed_step"] == STEPS
            assert rec["resumed_equal"] is True
            assert rec["next_losses"][0] == rec["next_losses"][1]


class TestCollectives:
    def test_each_step_counts_its_model_axis_sum(self, world2):
        """sp = 2 ring, depth 1: the forward's one K/V hop and the pool's
        sum; the backward's two hops and the gradient sum over sp. ep = 2:
        the combine, the input's backward sum, the gradient sum over ep."""
        for _, info in world2:
            for report in info["sp_ring"]["reports"]:
                assert report["comm_calls"] == 5, report
            for report in info["ep_dense"]["reports"]:
                assert report["comm_calls"] == 3, report

    def test_dp_by_sp_adds_one_data_average(self, world4):
        for _, info in world4:
            for report in info["dp2_sp2"]["reports"]:
                assert report["comm_calls"] == 6, report


class TestMutation:
    """The sums over sp and ep dropped: each case fails a check above."""

    def test_the_ranks_still_agree(self, world2):
        """Without the sums each replicated gradient is rank 0's part, on
        every rank: the bit-equality check cannot see the fault, the
        losses below do."""
        for name in ("sp_ring_unsummed", "ep_dense_unsummed"):
            a, b = (info[name] for _, info in world2)
            assert {k: v for k, v in a["params"][-1].items()
                    if k not in a["split"]} == {
                k: v for k, v in b["params"][-1].items()
                if k not in b["split"]}

    @pytest.mark.parametrize("name,correct", [
        ("sp_ring_unsummed", "sp_ring"), ("ep_dense_unsummed", "ep_dense")])
    def test_losses_leave_jax_s(self, world2, jax_results, name, correct):
        want, _ = jax_results[correct]
        got = world2[0][1][name]["losses"]
        assert got[0] == pytest.approx(want[0], rel=LOSS_RTOL)
        assert not np.allclose(got[1:], want[1:], rtol=LOSS_RTOL, atol=0)
