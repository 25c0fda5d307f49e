"""The port's SeqFormer (``ai4e_tpu_torch.models.seqformer``), its weight
conversion (``convert.seqformer_state_dict_from_flax``) and its servable
(``runtime.families.build_seqformer``) against the JAX package's, on the
same weights (flax's init, converted) and inputs made with numpy from a
seed. JAX's flash attention runs in interpret mode; the port's takes its
plain version on the CPU.

Each dtype trap of the translation has its own assertion, then the whole
model is compared at a small size and at the deployed width of the
``longcontext`` entry of ``deploy/specs/models.json`` for one sequence."""

import asyncio
import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_worker import npy, poll, serving

from ai4e_tpu.models.seqformer import SeqFormer as FlaxSeqFormer
from ai4e_tpu.models.seqformer import attention_for as jax_attention_for
from ai4e_tpu.models.seqformer import create_seqformer as jax_create
from ai4e_tpu.parallel import MeshSpec, make_mesh
from ai4e_tpu.runtime.families import build_seqformer as jax_build_seqformer
from ai4e_tpu.train import step as jax_step
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.cli import build_worker
from ai4e_tpu_torch.models import SeqFormer, attention_for, create_seqformer
from ai4e_tpu_torch.models import layers
from ai4e_tpu_torch.models.unet import gelu as unet_gelu
from ai4e_tpu_torch.runtime.families import build_seqformer
from ai4e_tpu_torch.train import Trainer

torch.set_num_threads(2)

SMALL = dict(seq_len=256, input_dim=24, dim=64, depth=2, heads=2)
VOCAB = 512
DEPLOYED = dict(seq_len=4096, input_dim=64, dim=256, depth=4, heads=2,
                vocab_size=32768)  # deploy/specs/models.json longcontext
PREFIX = "/v1/models"


@functools.lru_cache(maxsize=None)
def _flax_params(vocab_size, **config):
    _, params = jax_create(vocab_size=vocab_size, attention="flash",
                           **config)
    return jax.tree.map(np.asarray, params)


def flax_params(vocab_size=VOCAB, config=SMALL):
    """A fresh copy of the flax params tree as numpy arrays (tests edit
    it)."""
    return jax.tree.map(np.array, _flax_params(vocab_size, **config))


def tokens(n, seq_len, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (n, seq_len),
                                                dtype=np.int32)


def forward_both(params, x, dtype, vocab_size, config=SMALL):
    """JAX and port logits for one batch, both with flash attention."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(FlaxSeqFormer(
        **config, vocab_size=vocab_size, dtype=jdt,
        attn_fn=jax_attention_for(None, "flash")).apply(params, jnp.asarray(x)))
    model = SeqFormer(**config, vocab_size=vocab_size, dtype=dtype,
                      attn_fn=attention_for(None, "flash"))
    model.load_state_dict(convert.seqformer_state_dict_from_flax(params))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    return got, want


class TestConvert:
    def test_layouts(self):
        """Dense (in, out) -> Linear (out, in); the embedding table and
        (1, S, dim) pos_emb as they are; flax's LayerNorm auto names."""
        params = flax_params()
        p = params["params"]
        sd = convert.seqformer_state_dict_from_flax(params)
        np.testing.assert_array_equal(sd["blocks.1.attn.qkv.weight"].numpy(),
                                      p["block1"]["attn"]["qkv"]["kernel"].T)
        np.testing.assert_array_equal(sd["blocks.0.mlp_up.bias"].numpy(),
                                      p["block0"]["mlp_up"]["bias"])
        np.testing.assert_array_equal(sd["embed.weight"].numpy(),
                                      p["embed"]["embedding"])
        assert sd["pos_emb"].shape == (1, 256, 64)
        np.testing.assert_array_equal(sd["blocks.0.ln2.weight"].numpy(),
                                      p["block0"]["LayerNorm_1"]["scale"])
        np.testing.assert_array_equal(sd["norm.bias"].numpy(),
                                      p["LayerNorm_0"]["bias"])
        assert set(sd) == set(SeqFormer(**SMALL, vocab_size=VOCAB).state_dict())

    def test_feature_mode_round_trip_through_npz(self, tmp_path):
        params = flax_params(vocab_size=None)
        path = tmp_path / "seqformer.npz"
        convert.save_npz(params, str(path))
        sd = convert.seqformer_state_dict_from_flax(convert.load_npz(str(path)))
        np.testing.assert_array_equal(
            sd["embed.weight"].numpy(),
            params["params"]["embed"]["kernel"].T)
        assert set(sd) == set(SeqFormer(**SMALL).state_dict())

    @pytest.mark.parametrize("edit,match", [
        (lambda p: p["block1"].pop("LayerNorm_1"), "missing"),
        (lambda p: p["block0"]["mlp_up"].pop("bias"), "missing"),
        (lambda p: p.__setitem__(
            "Dense_0", {"kernel": np.zeros((2, 2), np.float32)}), "keys"),
        (lambda p: p["block0"]["attn"]["qkv"].__setitem__(
            "bias", np.zeros((192,), np.float32)), "keys"),
        (lambda p: p["block1"]["attn"]["out"].__setitem__(
            "kernel", np.zeros((64, 65), np.float32)), "shape"),
        (lambda p: p["block0"]["attn"]["qkv"].__setitem__(
            "kernel", np.zeros((64, 3, 64), np.float32)), "2-D"),
        (lambda p: p.__setitem__("pos_emb", np.zeros((256, 64), np.float32)),
         "pos_emb"),
    ], ids=["missing-norm", "missing-bias", "extra-module", "extra-bias",
            "wrong-shape", "wrong-rank", "pos-emb-rank"])
    def test_raises(self, edit, match):
        params = flax_params()
        edit(params["params"])
        with pytest.raises(ValueError, match=match):
            convert.seqformer_state_dict_from_flax(params)


class TestTraps:
    def test_layernorm_returns_float32_with_flax_eps_and_fast_variance(self):
        """On bfloat16 input flax's LayerNorm returns float32. Epsilon is
        1e-6 (it shows at small scales), and the variance is E[x^2]-E[x]^2
        (it shows at a large mean, where torch's two-pass variance differs
        by 0.03 at 1000 +- 1)."""
        rng = np.random.default_rng(0)
        norm = fnn.LayerNorm()
        ours = layers.LayerNorm(256)
        assert ours.eps == 1e-6
        for x in ((1000 + rng.standard_normal((8, 256))).astype(np.float32),
                  rng.standard_normal((8, 256)).astype(np.float32) * 1e-3):
            xb = jnp.asarray(x, jnp.bfloat16)
            want = np.asarray(norm.apply(norm.init(jax.random.PRNGKey(0), xb),
                                         xb))
            assert want.dtype == np.float32
            with torch.inference_mode():
                got = ours(torch.from_numpy(np.asarray(xb, np.float32))
                           .to(torch.bfloat16))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
            torch_default = F.layer_norm(got.new_tensor(np.asarray(
                xb, np.float32)), (256,))
            assert np.abs(torch_default.numpy() - want).max() > 1e-2

    def test_dense_rounds_the_product_then_adds_the_bias(self):
        """flax rounds x.W to bfloat16, then rounds again after the bias:
        the port's Dense repeats that (all but a few of 65536 outputs
        bit-equal: the products sum in other orders), F.linear with the
        bias in its epilogue does not (about 30% differ)."""
        rng = np.random.default_rng(1)
        x = rng.standard_normal((64, 256)).astype(np.float32)
        kernel = rng.standard_normal((256, 1024)).astype(np.float32) / 16
        bias = rng.standard_normal(1024).astype(np.float32)
        want = np.asarray(fnn.Dense(1024, dtype=jnp.bfloat16).apply(
            {"params": {"kernel": kernel, "bias": bias}}, x), np.float32)
        dense = layers.Dense(256, 1024, dtype=torch.bfloat16)
        dense.load_state_dict({"weight": torch.from_numpy(kernel.T.copy()),
                               "bias": torch.from_numpy(bias)})
        with torch.inference_mode():
            got = dense(torch.from_numpy(x))
            fused = F.linear(torch.from_numpy(x).to(torch.bfloat16),
                             dense.weight, dense.bias)
        assert got.dtype == torch.bfloat16
        assert (got.float().numpy() == want).mean() >= 0.999
        assert (fused.float().numpy() == want).mean() < 0.9

    def test_embed_and_pos_emb_add_in_bfloat16(self):
        """nn.Embed(dtype=bf16) casts the table before the gather, and the
        (1, S, dim) pos_emb is cast before the add: bit for bit."""
        p = flax_params()["params"]
        x = tokens(2, 256, VOCAB, seed=2)
        want = np.asarray(
            jnp.take(jnp.asarray(p["embed"]["embedding"], jnp.bfloat16),
                     jnp.asarray(x), axis=0)
            + jnp.asarray(p["pos_emb"], jnp.bfloat16), np.float32)
        model = SeqFormer(**SMALL, vocab_size=VOCAB)
        model.load_state_dict(convert.seqformer_state_dict_from_flax(
            {"params": p}))
        assert model.embed.weight.dtype == model.pos_emb.dtype == torch.bfloat16
        with torch.inference_mode():
            got = model.embed(torch.from_numpy(x)) + model.pos_emb
        np.testing.assert_array_equal(got.float().numpy(), want)

    def test_pooling_sums_in_float32_and_returns_bfloat16(self):
        """The norm after pooling sees jnp.mean of the last block's
        bfloat16 output (a float32 sum, one rounding): bit for bit."""
        model = SeqFormer(**SMALL, vocab_size=VOCAB).eval()
        seen = {}
        model.blocks[-1].register_forward_hook(
            lambda m, i, out: seen.__setitem__("h", out))
        model.norm.register_forward_pre_hook(
            lambda m, i: seen.__setitem__("pooled", i[0]))
        with torch.inference_mode():
            model(torch.from_numpy(tokens(2, 256, VOCAB, 3)))
        want = jnp.asarray(seen["h"].float().numpy(), jnp.bfloat16).mean(axis=1)
        assert want.dtype == jnp.bfloat16
        assert seen["pooled"].dtype == torch.bfloat16
        np.testing.assert_array_equal(seen["pooled"].float().numpy(),
                                      np.asarray(want, np.float32))

    def test_precision_body_bf16_head_f32_with_bias(self):
        model = SeqFormer(**SMALL, vocab_size=VOCAB)
        assert model.head.weight.dtype == torch.float32
        assert model.head.bias is not None
        assert model.blocks[0].attn.qkv.bias is None
        assert model.blocks[0].mlp_up.weight.dtype == torch.bfloat16
        assert model.norm.weight.dtype == torch.float32
        with torch.inference_mode():
            out = model.eval()(torch.from_numpy(tokens(3, 256, VOCAB, 4)))
        assert out.dtype == torch.float32 and out.shape == (3, 16)

    def test_gelu_is_shared_with_the_unet(self):
        assert unet_gelu is layers.gelu


class OneRankMesh:
    """A stand-in for a one-rank ``DeviceMesh``: every axis of size 1."""

    def size(self, dim=None):
        return 1


class TestAttentionFor:
    @pytest.mark.parametrize("strategy,fn", [
        ("auto", "flash_attention"), ("flash", "flash_attention"),
        ("full", "reference_attention")])
    def test_strategies(self, strategy, fn):
        attn = attention_for(None, strategy, causal=True)
        assert attn.func.__name__ == fn and attn.keywords == {"causal": True}

    @pytest.mark.parametrize("mesh,strategy", [
        (None, "ring"), (None, "ulysses"), (OneRankMesh(), "ring")],
        ids=["ring", "ulysses", "mesh"])
    def test_sequence_parallel_raises_naming_a15(self, mesh, strategy):
        """The parallel plane (ROADMAP A15) is ported: ring and Ulysses
        serve over a mesh whose sp axis is larger than one
        (tests/test_torch_mesh_serving.py), and refuse anything else, as
        JAX's ``attention_for`` does."""
        with pytest.raises(ValueError, match="needs a mesh with sp > 1"):
            jax_attention_for(None, strategy)
        with pytest.raises(ValueError, match="needs a mesh with sp > 1"):
            attention_for(mesh, strategy)
        with pytest.raises(ValueError, match="needs a mesh with sp > 1"):
            create_seqformer(mesh=mesh, attention=strategy, device="cpu",
                             seq_len=8, dim=16, heads=1, depth=1)

    def test_unknown_strategy(self):
        with pytest.raises(ValueError, match="unknown attention strategy"):
            attention_for(None, "sparse")


class TestParity:
    @pytest.mark.parametrize("vocab_size", [VOCAB, None],
                             ids=["tokens", "features"])
    def test_float32(self, vocab_size):
        """Both in float32, flash attention on both sides: logits agree to
        1e-4 (measured 1.3e-6 tokens, 7e-7 features)."""
        rng = np.random.default_rng(5)
        x = (tokens(4, 256, VOCAB, 5) if vocab_size
             else rng.standard_normal((4, 256, 24)).astype(np.float32))
        got, want = forward_both(flax_params(vocab_size), x, torch.float32,
                                 vocab_size)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    @pytest.mark.parametrize("vocab_size", [VOCAB, None],
                             ids=["tokens", "features"])
    def test_bfloat16_as_served(self, vocab_size):
        """The served precision on 16 seeded sequences: logits within
        5e-2 (measured 3.6e-3 tokens, 6.9e-3 features) and the same
        class on at least 15 of 16 (measured 16/16)."""
        rng = np.random.default_rng(6)
        x = (tokens(16, 256, VOCAB, 6) if vocab_size
             else rng.standard_normal((16, 256, 24)).astype(np.float32))
        got, want = forward_both(flax_params(vocab_size), x, torch.bfloat16,
                                 vocab_size)
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
        assert (got.argmax(-1) == want.argmax(-1)).sum() >= 15

    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                            (torch.bfloat16, 5e-2)],
                             ids=["float32", "bfloat16"])
    def test_deployed_width_one_sequence(self, dtype, atol):
        """The longcontext width (S 4096, dim 256, depth 4, heads 2 of
        128, vocab 32768) on one sequence. Measured: float32 8.3e-7,
        bfloat16 1.5e-3 against logits of scale 2; same class."""
        config = {k: v for k, v in DEPLOYED.items() if k != "vocab_size"}
        x = tokens(1, 4096, DEPLOYED["vocab_size"], seed=3)
        got, want = forward_both(flax_params(DEPLOYED["vocab_size"], config),
                                 x, dtype, DEPLOYED["vocab_size"], config)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        assert got.argmax() == want.argmax()


# Head dims off the old instantiations: JAX's own SeqFormer test geometry
# (tests/test_seqformer.py: dim 32 over 4 heads, D = 8, on 16 features)
# and the longcontext width at one head of 256 (D = 256), depth 1, S 64, on
# tokens.
HEAD_DIM_GEOMETRIES = {
    "jax-test-d8": (dict(seq_len=256, input_dim=16, dim=32, depth=2, heads=4,
                         num_classes=8), None),
    "one-head-d256": (dict(seq_len=64, input_dim=64, dim=256, depth=1,
                           heads=1), VOCAB),
}


def head_dim_batch(geometry: str, n: int, seed: int):
    """Inputs (token ids or features) and labels for a geometry."""
    config, vocab = HEAD_DIM_GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    x = (tokens(n, config["seq_len"], vocab, seed) if vocab else
         rng.standard_normal((n, config["seq_len"], config["input_dim"]))
         .astype(np.float32))
    y = rng.integers(0, config.get("num_classes", 16), n).astype(np.int32)
    return x, y


class TestHeadDims:
    """The SeqFormer at head dims the port's flash kernels did not take
    before, against JAX's on converted weights (its flash in interpret
    mode, the port's plain version on the CPU)."""

    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                            (torch.bfloat16, 5e-2)],
                             ids=["float32", "bfloat16"])
    @pytest.mark.parametrize("geometry", list(HEAD_DIM_GEOMETRIES))
    def test_logits_match_jax(self, geometry, dtype, atol):
        """Logits within the tolerances of TestParity (float32 1e-4,
        bfloat16 5e-2). Measured against logits of scale 2: D = 8 3.9e-7
        and 2.4e-7, D = 256 6.6e-7 and 3.0e-3."""
        config, vocab = HEAD_DIM_GEOMETRIES[geometry]
        x, _ = head_dim_batch(geometry, 4, 11)
        got, want = forward_both(flax_params(vocab, config), x, dtype, vocab,
                                 config)
        assert got.shape == want.shape == (4, config.get("num_classes", 16))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)

    @pytest.mark.parametrize("geometry", list(HEAD_DIM_GEOMETRIES))
    def test_one_trainer_step_matches_jax(self, geometry):
        """``ai4e_tpu.train.step.Trainer`` on a one-device CPU mesh and the
        port's ``Trainer``, float32, one step of the default adamw from the
        same converted weights on the same batch: the loss within 1e-4 and
        every parameter within 1e-5, as tests/test_torch_train.py holds
        three steps at D = 32 (measured: losses equal; parameters 3.7e-8
        at D = 8, 7.2e-6 at D = 256)."""
        config, vocab = HEAD_DIM_GEOMETRIES[geometry]
        params = flax_params(vocab, config)
        x, y = head_dim_batch(geometry, 4, 12)
        model = FlaxSeqFormer(**config, vocab_size=vocab, dtype=jnp.float32,
                              attn_fn=jax_attention_for(None, "flash"))
        mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
        jax_tr = jax_step.Trainer(model.apply,
                                  jax.tree.map(jnp.asarray, params), mesh)
        want_loss = jax_tr.train_step(x, y)
        want = convert.seqformer_state_dict_from_flax(
            jax.tree.map(np.asarray, jax_tr.params))
        port = SeqFormer(**config, vocab_size=vocab, dtype=torch.float32,
                         param_dtype=torch.float32,
                         attn_fn=attention_for(None, "flash"))
        port.load_state_dict(convert.seqformer_state_dict_from_flax(params))
        got_loss = Trainer(port, device="cpu").train_step(x, y)
        np.testing.assert_allclose(got_loss, want_loss, rtol=0, atol=1e-4)
        got = port.state_dict()
        for name, w in want.items():
            np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)


def seqformer_spec(**overrides) -> dict:
    """deploy/specs/models.json's longcontext entry at a small width."""
    model = {"family": "seqformer", "name": "longcontext", **SMALL,
             "num_classes": 16, "vocab_size": VOCAB, "attention": "flash",
             "buckets": [1, 4], "sync_path": "/score",
             "async_path": "/score-async"}
    model.update(overrides)
    return {"service_name": "gpu-worker", "prefix": "v1/models",
            "models": [model]}


class TestServable:
    @pytest.fixture(scope="class")
    def jax_servable(self):
        return jax_build_seqformer(**SMALL, vocab_size=VOCAB,
                                   attention="flash", buckets=(1, 4))

    @pytest.fixture(scope="class")
    def checkpoint(self, jax_servable, tmp_path_factory):
        path = tmp_path_factory.mktemp("ckpt") / "longcontext.npz"
        convert.save_npz(jax.tree.map(np.asarray, jax_servable.params),
                         str(path))
        return str(path)

    def test_sync_and_async_json_match_jax(self, jax_servable, checkpoint):
        """The port's worker on the JAX servable's weights: uint16 token
        payloads over HTTP, the JSON schema is JAX's, the class agrees and
        the confidence is within 1e-2 (bfloat16 in both)."""
        worker, batcher, _ = build_worker(
            seqformer_spec(checkpoint=checkpoint), device="cpu")
        seqs = tokens(3, 256, VOCAB, seed=8).astype(np.uint16)

        async def main():
            async with serving(worker, batcher) as client:
                sync = []
                for seq in seqs[:2]:
                    resp = await client.post(f"{PREFIX}/score", data=npy(seq))
                    assert resp.status == 200, await resp.text()
                    sync.append(await resp.json())
                resp = await client.post(f"{PREFIX}/score-async",
                                         data=npy(seqs[2]))
                task_id = (await resp.json())["TaskId"]
                final = await poll(client, task_id)
                listing = await (await client.get(f"{PREFIX}/models")).json()
                return sync, task_id, final, listing

        sync, task_id, final, listing = asyncio.run(main())
        assert final["Status"] == "completed - class_id, confidence"
        stored = json.loads(worker.store.get_result(task_id)[0])
        (model,) = listing["models"]
        assert model["input_dtype"] == "int32"
        assert model["input_shape"] == [256]
        for seq, got in zip(seqs, sync + [stored]):
            logits = jax_servable.apply_fn(
                jax_servable.params, jnp.asarray(seq[None].astype(np.int32)))
            want = json.loads(json.dumps(
                jax_servable.postprocess(np.asarray(logits)[0])))
            assert set(got) == set(want) == {"class_id", "confidence"}
            assert got["class_id"] == want["class_id"]
            assert abs(got["confidence"] - want["confidence"]) <= 1e-2

    @pytest.mark.parametrize("payload", [
        np.zeros(256, np.float32),
        np.full(256, VOCAB, np.int64),
        np.full(256, -1, np.int16),
        np.full(256, 2 ** 32 + 1, np.int64),
        np.zeros(255, np.int32),
        np.zeros((2, 256), np.uint16),
    ], ids=["float", "too-high", "negative", "wraps-under-int32", "short",
            "2-D"])
    def test_token_validation_messages_are_jax_s(self, jax_servable, payload):
        port = build_seqformer(**SMALL, vocab_size=VOCAB, buckets=(1, 4))
        body = npy(payload)
        with pytest.raises(ValueError) as want:
            jax_servable.preprocess(body, "application/octet-stream")
        with pytest.raises(ValueError) as got:
            port.preprocess(body, "application/octet-stream")
        assert str(got.value) == str(want.value)

    def test_feature_wire_float16(self):
        """Feature mode on the float16 wire: the batch arrives as float16,
        the JAX servable's dtype, and out-of-range payloads fail."""
        port = build_seqformer(**SMALL, buckets=(1,))
        want = jax_build_seqformer(**SMALL, buckets=(1,))
        assert port.input_dtype == want.input_dtype == np.float16
        assert port.input_shape == want.input_shape == (256, 24)
        big = npy(np.full((256, 24), 1e6, np.float32))
        for servable in (port, want):
            with pytest.raises(ValueError, match="float16 range"):
                servable.preprocess(big, "")
        with pytest.raises(ValueError, match="wire_dtype"):
            build_seqformer(**SMALL, wire_dtype="bfloat16")

    def test_worker_defaults_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_worker(seqformer_spec())

