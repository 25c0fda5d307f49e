"""The port's MoE family (``ai4e_tpu_torch.models.moe``), its weight
conversion (``convert.moe_state_dict_from_flax``), its servable
(``runtime.families.build_moe``) and its training recipe
(``train.make_checkpoints.train_moe``) against the JAX package's, on the
same weights (flax's init, converted) and inputs made with numpy from a
seed. JAX's flash attention runs in interpret mode; the port's takes its
plain version on the CPU.

The MoE layer is compared alone (both dispatches, float32 and bfloat16,
the capacity dispatch's slots and drops), then the whole classifier at a
small size and at the deployed width of ``deploy/specs/models.json``'s
``moe`` entry, then served answers and the trained checkpoint."""

import asyncio
import copy
import functools
import inspect
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_reload import answer, jax_stack, npy, port_stack, serving

from ai4e_tpu.checkpoint import save_params
from ai4e_tpu.models.moe import MoEClassifier as FlaxMoE
from ai4e_tpu.models.moe import MoEFFN as FlaxMoEFFN
from ai4e_tpu.models.moe import create_moe as jax_create
from ai4e_tpu.models.seqformer import attention_for as jax_attention_for
from ai4e_tpu.runtime.families import build_moe as jax_build_moe
from ai4e_tpu.train import make_checkpoints as jax_mc
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.cli import build_worker
from ai4e_tpu_torch.models import MoEClassifier, MoEFFN, create_moe
from ai4e_tpu_torch.models.moe import capacity_slots
from ai4e_tpu_torch.models.seqformer import attention_for
from ai4e_tpu_torch.runtime.families import UNPORTED_FAMILIES, build_moe
from ai4e_tpu_torch.train import make_checkpoints as mc

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(seq_len=128, input_dim=16, dim=32, depth=2, heads=2,
             num_experts=4, num_classes=4)
VOCAB = 64
DEPLOYED = dict(seq_len=1024, input_dim=64, dim=128, depth=2, heads=1,
                num_experts=8, num_classes=16, vocab_size=8192)


@functools.lru_cache(maxsize=None)
def _flax_params(vocab_size, items):
    _, params = jax_create(vocab_size=vocab_size, attention="full",
                           **dict(items))
    return jax.tree.map(np.asarray, params)


def flax_params(vocab_size=VOCAB, config=SMALL):
    """A fresh copy of a flax MoEClassifier tree as numpy arrays."""
    return jax.tree.map(np.array,
                        _flax_params(vocab_size, tuple(config.items())))


def inputs(vocab_size, n, seed, config=SMALL):
    rng = np.random.default_rng(seed)
    if vocab_size:
        return rng.integers(0, vocab_size, (n, config["seq_len"]),
                            dtype=np.int32)
    return rng.standard_normal((n, config["seq_len"], config["input_dim"])
                               ).astype(np.float32)


def classifiers_both(params, x, dtype, vocab_size, attention="full",
                     config=SMALL, **kw):
    """JAX and port logits of one batch on the same weights."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(FlaxMoE(
        **config, vocab_size=vocab_size, dtype=jdt,
        attn_fn=jax_attention_for(None, attention), **kw).apply(
            params, jnp.asarray(x)))
    model = MoEClassifier(**config, vocab_size=vocab_size, dtype=dtype,
                          attn_fn=attention_for(None, attention), **kw)
    model.load_state_dict(convert.moe_state_dict_from_flax(params))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    return got, want


# -- the MoE layer -------------------------------------------------------

DIM, EXPERTS, SEQ = 32, 4, 128


@functools.lru_cache(maxsize=None)
def _ffn_params():
    x = np.zeros((1, SEQ, DIM), np.float32)
    params = FlaxMoEFFN(DIM, EXPERTS).init(jax.random.PRNGKey(3), x)
    return jax.tree.map(np.asarray, params)


def ffn_params(router_bias=None):
    params = jax.tree.map(np.array, _ffn_params())
    if router_bias is not None:
        params["params"]["router"]["bias"] = np.asarray(router_bias,
                                                        np.float32)
    return params


def ffn_state_dict(params) -> dict:
    p = params["params"]
    return {"router.weight": torch.from_numpy(p["router"]["kernel"].T.copy()),
            "router.bias": torch.from_numpy(p["router"]["bias"].copy()),
            "up": torch.from_numpy(p["up"].copy()),
            "down": torch.from_numpy(p["down"].copy())}


def layer_input(n=3, seed=0, seq=SEQ):
    """What the layer sees served: a float32 LayerNorm-like output."""
    return np.random.default_rng(seed).standard_normal(
        (n, seq, DIM)).astype(np.float32)


def ffn_both(x, dispatch, capacity_factor=1.25, dtype=torch.float32,
             params=None):
    params = params or ffn_params()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want_y, want_top = FlaxMoEFFN(
        DIM, EXPERTS, dispatch=dispatch, capacity_factor=capacity_factor,
        dtype=jdt).apply(params, jnp.asarray(x))
    layer = MoEFFN(DIM, EXPERTS, dispatch=dispatch,
                   capacity_factor=capacity_factor, dtype=dtype)
    layer.load_state_dict(ffn_state_dict(params))
    with torch.inference_mode():
        got_y, got_top = layer(torch.from_numpy(x))
    assert got_y.dtype == torch.float32  # the input's type
    return (got_y.numpy(), got_top.numpy(), np.asarray(want_y),
            np.asarray(want_top))


def jax_slots(top: np.ndarray, experts: int, cap: int) -> np.ndarray:
    """The slot assignment of ``ai4e_tpu/models/moe.py``'s
    ``_capacity_dispatch``, op for op."""
    oh = jax.nn.one_hot(jnp.asarray(top), experts, dtype=jnp.float32)
    pos = (jnp.cumsum(oh, axis=1) * oh).sum(-1) - 1.0
    return np.asarray(jnp.where(pos < cap, pos, cap).astype(jnp.int32))


class TestMoEFFN:
    @pytest.mark.parametrize("dispatch", ["dense", "capacity"])
    def test_float32(self, dispatch):
        """Both dispatches in float32: the same routing and outputs within
        1e-5 (measured 1.2e-7 with either)."""
        got, top, want, want_top = ffn_both(layer_input(), dispatch)
        np.testing.assert_array_equal(top, want_top)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("dispatch", ["dense", "capacity"])
    def test_bfloat16(self, dispatch):
        """The served precision: the float32 router routes alike, and the
        bfloat16 experts' outputs agree within 4e-3, two bfloat16 ulps at
        their largest magnitude, 0.46 (measured 7.5e-8 with either: the
        same bfloat16 expert outputs, times gates that differ in the last
        float32 bit)."""
        got, top, want, want_top = ffn_both(layer_input(seed=1), dispatch,
                                            dtype=torch.bfloat16)
        np.testing.assert_array_equal(top, want_top)
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-3)

    def test_capacity_equals_dense_when_nothing_drops(self):
        """``tests/test_moe.py``'s case on the port alone: at capacity
        factor 4 every token finds its slot, and the capacity path gives
        the dense path's outputs (float32: to 1e-6; bfloat16: bit for bit,
        each expert product the same dot products)."""
        x = torch.from_numpy(layer_input(seed=2))
        for dtype, atol in ((torch.float32, 1e-6), (torch.bfloat16, 0.0)):
            outs = []
            for dispatch in ("dense", "capacity"):
                layer = MoEFFN(DIM, EXPERTS, dispatch=dispatch,
                               capacity_factor=4.0, dtype=dtype)
                layer.load_state_dict(ffn_state_dict(ffn_params()))
                with torch.inference_mode():
                    outs.append(layer(x)[0].numpy())
            np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=atol)

    def test_overflow_drops_to_exact_zero_with_jax_s_slots(self):
        """At capacity factor 0.125 (cap 4 of a group's 128 tokens over 4
        experts) most tokens drop. The slots equal JAX's on the same
        routing, a dropped token's output is exactly 0 in both, and the
        kept ones agree within 1e-5."""
        x = layer_input(seed=3)
        got, top, want, want_top = ffn_both(x, "capacity", 0.125)
        np.testing.assert_array_equal(top, want_top)
        layer = MoEFFN(DIM, EXPERTS, dispatch="capacity",
                       capacity_factor=0.125)
        sg, cap = layer.capacity(SEQ)
        assert (sg, cap) == (128, 4)
        groups = top.reshape(-1, sg)
        slots = capacity_slots(torch.from_numpy(groups), EXPERTS, cap).numpy()
        np.testing.assert_array_equal(slots, jax_slots(groups, EXPERTS, cap))
        dropped = (slots == cap).reshape(top.shape)
        assert dropped.mean() > 0.8
        assert (got[dropped] == 0).all() and (want[dropped] == 0).all()
        assert np.abs(got[~dropped]).min() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def test_router_bias_sends_every_token_to_one_expert(self):
        """A router bias of 30 on expert 3: every token routes there, so
        the capacity dispatch keeps each group's first cap = 40 tokens in
        arrival order and drops the rest, as JAX's does."""
        params = ffn_params(router_bias=[0, 0, 0, 30])
        x = layer_input(seed=4)
        got, top, want, want_top = ffn_both(x, "capacity", params=params)
        assert (top == 3).all() and (want_top == 3).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        kept = np.abs(got).sum(-1) > 0
        np.testing.assert_array_equal(
            kept, np.broadcast_to(np.arange(SEQ) < 40, kept.shape))

    def test_group_divisor_error_is_jax_s(self):
        """S = 131 (prime) has no group divisor >= 8: both refuse, with the
        same message."""
        x = layer_input(n=1, seq=131)
        with pytest.raises(ValueError) as want:
            FlaxMoEFFN(DIM, EXPERTS, dispatch="capacity").apply(
                ffn_params(), jnp.asarray(x))
        layer = MoEFFN(DIM, EXPERTS, dispatch="capacity")
        with pytest.raises(ValueError) as got:
            layer(torch.from_numpy(x))
        assert str(got.value) == str(want.value)
        assert "no group divisor >= 8" in str(got.value)

    def test_unknown_dispatch_raises_as_jax(self):
        layer = MoEFFN(DIM, EXPERTS, dispatch="sorted")
        with pytest.raises(ValueError, match="unknown MoE dispatch 'sorted'"):
            layer(torch.zeros(1, 8, DIM))
        with pytest.raises(ValueError, match="unknown dispatch 'sorted'"):
            jax_create(seq_len=8, dim=16, depth=1, heads=1, dispatch="sorted")
        with pytest.raises(ValueError, match="unknown dispatch 'sorted'"):
            create_moe(seq_len=8, dim=16, depth=1, heads=1,
                       dispatch="sorted", device="cpu")


# -- the classifier ------------------------------------------------------

class TestTraps:
    def test_residual_stream_turns_float32_after_the_first_block(self):
        """``MoEFFN`` returns float32 (its input is the LayerNorm's
        float32), so ``x + h`` promotes: the first block's output, and so
        every later block's input, is float32, as in flax."""
        model = MoEClassifier(**SMALL, vocab_size=VOCAB).eval()
        seen = []
        for block in model.blocks:
            block.register_forward_hook(
                lambda m, i, out: seen.append((i[0].dtype, out[0].dtype)))
        with torch.inference_mode():
            model(torch.from_numpy(inputs(VOCAB, 1, 0)))
        assert seen == [(torch.bfloat16, torch.float32),
                        (torch.float32, torch.float32)]
        x = jnp.asarray(inputs(VOCAB, 1, 0))
        _, state = FlaxMoE(**SMALL, vocab_size=VOCAB,
                           attn_fn=jax_attention_for(None, "full")).apply(
            flax_params(), x, capture_intermediates=True)
        inter = state["intermediates"]
        assert inter["block0"]["__call__"][0][0].dtype == jnp.float32

    def test_router_float32_with_bias_experts_raw(self):
        model = MoEClassifier(**SMALL, vocab_size=VOCAB)
        moe = model.blocks[0].moe
        assert moe.router.weight.dtype == moe.router.bias.dtype == torch.float32
        assert moe.router.dtype == torch.float32
        assert moe.up.shape == (4, 32, 128) and moe.down.shape == (4, 128, 32)
        assert moe.up.dtype == torch.bfloat16
        assert model.head.weight.dtype == torch.float32

    def test_init_scales_as_flax(self):
        """The port's random init draws flax's distributions: lecun-normal
        experts with fan-in counted over the expert axis (std of up about
        sqrt(1 / (dim * E)))."""
        model = create_moe(**DEPLOYED, device="cpu")
        p = flax_params(DEPLOYED["vocab_size"],
                        {k: v for k, v in DEPLOYED.items()
                         if k != "vocab_size"})["params"]
        for name, ours in (("up", model.blocks[0].moe.up),
                           ("down", model.blocks[1].moe.down)):
            want = float(np.std(p[f"block{0 if name == 'up' else 1}"]["moe"]
                                [name]))
            assert float(ours.detach().float().std()) == pytest.approx(
                want, rel=0.02)
        assert float(model.pos_emb.detach().float().std()) == pytest.approx(
            float(np.std(p["pos_emb"])), rel=0.05)


class TestParity:
    @pytest.mark.parametrize("dispatch", ["dense", "capacity"])
    @pytest.mark.parametrize("vocab_size", [VOCAB, None],
                             ids=["tokens", "features"])
    def test_float32_through_flash(self, vocab_size, dispatch):
        """JAX's flash kernel (interpret mode) against the port's plain
        flash, both in float32: logits within 1e-5 (measured 3.6e-7 to
        6.0e-7)."""
        x = inputs(vocab_size, 3, 5)
        got, want = classifiers_both(flax_params(vocab_size), x,
                                     torch.float32, vocab_size, "flash",
                                     dispatch=dispatch)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("vocab_size", [VOCAB, None],
                             ids=["tokens", "features"])
    def test_bfloat16_as_served(self, vocab_size):
        """The served precision (capacity dispatch, flash) on 8 seeded
        sequences: logits of scale 2 within 1e-2 (measured 6.7e-5 tokens,
        9.0e-4 features) and the same class on at least 7 of 8 (measured
        8)."""
        x = inputs(vocab_size, 8, 6)
        got, want = classifiers_both(flax_params(vocab_size), x,
                                     torch.bfloat16, vocab_size, "flash",
                                     dispatch="capacity")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
        assert (got.argmax(-1) == want.argmax(-1)).sum() >= 7

    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                            (torch.bfloat16, 2e-2)],
                             ids=["float32", "bfloat16"])
    def test_deployed_width(self, dtype, atol):
        """The deployed ``moe`` entry (S 1024, dim 128, one head of 128, E
        8, depth 2, vocab 8192, capacity 1.25) on a batch of 2, JAX's
        attention ``full`` (the port's rounds its softmax once). Measured:
        float32 5.4e-7, bfloat16 4.7e-3 against logits of scale 2.5."""
        config = {k: v for k, v in DEPLOYED.items() if k != "vocab_size"}
        x = inputs(DEPLOYED["vocab_size"], 2, 7, config)
        got, want = classifiers_both(
            flax_params(DEPLOYED["vocab_size"], config), x, dtype,
            DEPLOYED["vocab_size"], "full", config, dispatch="capacity")
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        assert (got.argmax(-1) == want.argmax(-1)).all()


class TestConvert:
    @pytest.mark.parametrize("vocab_size", [VOCAB, None],
                             ids=["tokens", "features"])
    def test_round_trip_through_npz(self, tmp_path, vocab_size):
        """flax tree -> state_dict -> flax tree through a ``.npz`` is exact,
        and a bfloat16 state_dict widens to the same float32 tree."""
        params = flax_params(vocab_size)
        sd = convert.moe_state_dict_from_flax(params)
        assert set(sd) == set(MoEClassifier(**SMALL,
                                            vocab_size=vocab_size).state_dict())
        np.testing.assert_array_equal(
            sd["blocks.1.moe.up"].numpy(),
            params["params"]["block1"]["moe"]["up"])
        np.testing.assert_array_equal(
            sd["blocks.0.moe.router.weight"].numpy(),
            params["params"]["block0"]["moe"]["router"]["kernel"].T)
        path = str(tmp_path / "moe.npz")
        convert.save_npz(convert.moe_flax_from_state_dict(sd), path)
        back = convert.load_npz(path)
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
        model = create_moe(**SMALL, vocab_size=vocab_size, device="cpu")
        tree = convert.moe_flax_from_state_dict(model.state_dict())
        for name, t in convert.moe_state_dict_from_flax(tree).items():
            assert torch.equal(t, model.state_dict()[name].float()), name

    @pytest.mark.parametrize("edit,match", [
        (lambda p: p["block1"]["moe"].pop("down"), "missing"),
        (lambda p: p["block0"]["moe"]["router"].pop("bias"), "missing"),
        (lambda p: p["block0"]["moe"].__setitem__(
            "gate", np.zeros((2,), np.float32)), "keys"),
        (lambda p: p["block0"]["moe"].__setitem__(
            "up", np.zeros((4, 32, 64), np.float32)), "shape"),
    ], ids=["missing-expert", "missing-router-bias", "extra", "wrong-shape"])
    def test_raises(self, edit, match):
        params = flax_params()
        edit(params["params"])
        with pytest.raises(ValueError, match=match):
            convert.moe_state_dict_from_flax(params)


# -- serving -------------------------------------------------------------

MOE_KW = dict(name="moe", **SMALL, vocab_size=VOCAB, attention="flash",
              dispatch="capacity", buckets=(1, 4))


def moe_payloads(n=3, seed=4):
    return list(np.random.default_rng(seed).integers(
        0, VOCAB, (n, SMALL["seq_len"])).astype(np.uint16))


class TestServable:
    def test_defaults_and_contract_are_jax_s(self):
        want = inspect.signature(jax_build_moe).parameters
        got = inspect.signature(build_moe).parameters
        for name, param in want.items():
            assert got[name].default == param.default, name
        port = build_moe(**MOE_KW)
        jax_sv = jax_build_moe(**MOE_KW)
        assert port.input_shape == jax_sv.input_shape == (128,)
        assert np.dtype(port.input_dtype) == np.dtype(jax_sv.input_dtype)
        for bad in (np.full(128, VOCAB, np.int64), np.zeros(128, np.float32)):
            with pytest.raises(ValueError) as w:
                jax_sv.preprocess(npy(bad), "")
            with pytest.raises(ValueError) as g:
                port.preprocess(npy(bad), "")
            assert str(g.value) == str(w.value)

    def test_mesh_raises_naming_a15(self):
        """Expert sharding is ported (ROADMAP A15, held against JAX's in
        tests/test_torch_mesh_serving.py); a mesh whose ep axis does not
        divide the experts is refused, as JAX's ``create_moe`` refuses it."""
        class EpMesh:  # a stand-in DeviceMesh: ep=3, every other axis 1
            def size(self, dim=None):
                return 3 if dim == 2 else 1

        with pytest.raises(ValueError, match="not divisible by ep=3"):
            build_moe(**MOE_KW, mesh=EpMesh())

    def test_answers_over_http_equal_jax_s_worker(self):
        """One sync request each through JAX's worker and the port's on
        the same weights: the same class, confidence within 1e-2 (bfloat16
        in both)."""
        async def main():
            stacks = (jax_stack("moe", MOE_KW), port_stack("moe", MOE_KW))
            jax_params = jax.tree.map(np.asarray, stacks[0][2].params)
            port = stacks[1][2]
            port.module.load_state_dict(port.state_dict_from_flax(jax_params))
            async with serving(*stacks) as clients:
                return [[await answer(await c.post(
                    "/v1/echo/run", data=npy(p),
                    headers={"Content-Type": "application/octet-stream"}))
                    for p in moe_payloads()] for c in clients]

        want, got = asyncio.run(main())
        for (gs, g), (ws, w) in zip(got, want):
            assert gs == ws == 200
            assert set(g) == set(w) == {"class_id", "confidence"}
            assert g["class_id"] == w["class_id"]
            assert abs(g["confidence"] - w["confidence"]) <= 1e-2

    def test_reload_of_a_wrong_tree_is_409_as_jax(self, tmp_path):
        """A moe checkpoint of another geometry (2 experts for the served
        4): JAX's worker refuses its orbax form with 409, the port's its
        ``.npz`` with 409, and both keep serving; the right tree reloads
        with 200 on both."""
        other = dict(SMALL, num_experts=2)
        wrong = flax_params(VOCAB, other)
        right = flax_params(VOCAB)
        paths = {}
        for name, tree in (("wrong", wrong), ("right", right)):
            save_params(str(tmp_path / name), tree)
            convert.save_npz(tree, str(tmp_path / f"{name}.npz"))
            paths[name] = (str(tmp_path / name), str(tmp_path / f"{name}.npz"))

        async def main():
            stacks = (jax_stack("moe", MOE_KW, str(tmp_path)),
                      port_stack("moe", MOE_KW, str(tmp_path)))
            out = []
            async with serving(*stacks) as clients:
                for i, client in enumerate(clients):
                    codes = []
                    for name in ("wrong", "right"):
                        resp = await client.post(
                            "/v1/echo/models/moe/reload",
                            json={"checkpoint": paths[name][i]})
                        codes.append(await answer(resp))
                    out.append(codes)
            return out

        (jax_wrong, jax_right), (port_wrong, port_right) = asyncio.run(main())
        assert jax_wrong[0] == port_wrong[0] == 409
        assert "checkpoint tree does not match" in port_wrong[1]["error"]
        assert jax_right[0] == port_right[0] == 200
        assert port_right[1]["params_version"] == 2


class TestDeploySpec:
    def test_every_family_is_ported_but_the_streaming_lm(self):
        """Since the streaming slice, the streaming LM is ported too."""
        assert UNPORTED_FAMILIES == {}

    def test_a_worker_builds_every_entry_of_the_deploy_spec(self):
        """deploy/specs/models.json whole, widths and depths cut, without
        ``checkpoint`` and ``taskstore``: every entry builds (the moe entry
        with its ``dispatch`` and ``capacity_factor``)."""
        spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
        spec.pop("taskstore")
        cuts = {"landcover": dict(tile=32, widths=[8, 16]),
                "megadetector": dict(image_size=64, widths=[8, 16, 32]),
                "species": dict(image_size=32, width=8),
                "longcontext": dict(seq_len=128, dim=32, vocab_size=256),
                "moe": dict(seq_len=128, dim=32, vocab_size=256)}
        for model in spec["models"]:
            model.pop("checkpoint")
            model.update(cuts[model["name"]])
            model["buckets"] = model["buckets"][:1]
        worker, _, _ = build_worker(copy.deepcopy(spec), device="cpu")
        assert list(worker.runtime.models) == [
            m["name"] for m in spec["models"]]
        moe = worker.runtime.models["moe"].module
        assert {b.moe.dispatch for b in moe.blocks} == {"capacity"}
        assert {b.moe.capacity_factor for b in moe.blocks} == {1.25}


# -- training ------------------------------------------------------------

class TestRecipe:
    def test_defaults_are_jax_s(self):
        want = inspect.signature(jax_mc.train_moe).parameters
        got = inspect.signature(mc.train_moe).parameters
        for name, param in want.items():
            assert got[name].default == param.default, name
        assert mc.RECIPES["moe"] is mc.train_moe

    def test_fast_geometry_clears_the_gate_and_loads_into_jax(self,
                                                              tmp_path):
        """``train_moe`` at JAX's --fast geometry on the CPU (dense
        training, full attention; eval with capacity dispatch) clears
        ``MIN_EVAL`` (measured 1.0); ``make_checkpoint`` saves a MoE tree
        through the moe converter, which has the shape of JAX's
        ``create_moe`` tree and serves JAX's MoEClassifier to the trainer's
        eval on the same held-out sequences; ``build_worker`` restores it
        from a spec's ``checkpoint`` and serves the same eval."""
        entry = mc.make_checkpoint("moe", str(tmp_path), device="cpu",
                                   **mc.FAST["moe"])
        assert entry["eval"]["accuracy"] >= mc.MIN_EVAL == jax_mc.MIN_EVAL
        assert entry["family"] == "moe"
        assert entry["kwargs"]["dispatch"] == "capacity"
        kw = entry["kwargs"]
        model, like = jax_create(
            **{k: kw[k] for k in ("seq_len", "input_dim", "dim", "depth",
                                  "heads", "num_experts", "num_classes",
                                  "vocab_size", "dispatch",
                                  "capacity_factor")}, attention="full")
        tree = convert.load_npz(entry["path"])
        assert (jax.tree.map(np.shape, tree)
                == jax.tree.map(np.shape, jax.tree.map(np.asarray, like)))
        worker, _, _ = build_worker({"models": [{
            "family": "moe", "name": "moe", **kw, "buckets": [16],
            "checkpoint": entry["path"]}]}, device="cpu")
        rng = np.random.default_rng(1)  # the trainer's eval: seed + 1
        hits = {"jax": 0, "port": 0}
        for _ in range(4):
            toks, labels = mc.longcontext_batch(rng, 16, kw["seq_len"],
                                                kw["vocab_size"])
            for name, logits in (
                    ("jax", model.apply(tree, toks)),
                    ("port", worker.runtime.run_batch("moe", toks))):
                hits[name] += int((np.asarray(logits).argmax(-1)
                                   == labels).sum())
        assert hits["port"] == round(entry["eval"]["accuracy"] * 64)
        assert abs(hits["jax"] - hits["port"]) <= 2
