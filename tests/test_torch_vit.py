"""The port's ViT (``ai4e_tpu_torch.models.vit``), its weight conversion
(``convert.vit_state_dict_from_flax``) and its servable
(``runtime.families.build_vit``) against the JAX package's, on the same
weights (flax's init, converted) and float32 images made with numpy from a
seed: each dtype trap of the translation alone, then the whole model small
and at ViT-S/16 widths (``build_vit``'s defaults) with the depth cut to 2,
then served answers over HTTP."""

import asyncio
import functools
import inspect

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_reload import answer, jax_stack, npy, port_stack, serving

from ai4e_tpu.models.vit import ViT as FlaxViT
from ai4e_tpu.models.vit import create_vit as jax_create
from ai4e_tpu.runtime.families import build_vit as jax_build_vit
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.cli import build_worker
from ai4e_tpu_torch.models import ViT, create_vit
from ai4e_tpu_torch.models import layers
from ai4e_tpu_torch.models.vit import softmax_bf16
from ai4e_tpu_torch.runtime.families import build_vit

torch.set_num_threads(2)

SMALL = dict(num_classes=10, patch=16, dim=64, depth=2, heads=4)
VIT_S = dict(num_classes=1000, patch=16, dim=384, depth=2, heads=6)
VIT_S_DEPLOYED = dict(VIT_S, depth=12)


@functools.lru_cache(maxsize=None)
def _flax_params(image_size, items):
    _, params = jax_create(image_size=image_size, **dict(items))
    return jax.tree.map(np.asarray, params)


def flax_params(image_size=48, config=SMALL):
    return jax.tree.map(np.array,
                        _flax_params(image_size, tuple(config.items())))


def images(n, size, seed):
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(
        np.float32)


def vit_both(params, x, dtype, config=SMALL):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(FlaxViT(**config, dtype=jdt).apply(params,
                                                          jnp.asarray(x)))
    model = ViT(**config, image_size=x.shape[1], dtype=dtype)
    model.load_state_dict(convert.vit_state_dict_from_flax(params))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    return got, want


class TestTraps:
    @pytest.mark.parametrize("scale", [1.0, 1e-3, 30.0])
    def test_layernorm_bf16_rounds_once_as_flax(self, scale):
        """``nn.LayerNorm(dtype=bf16)``: float32 statistics (epsilon 1e-6,
        E[x^2] - E[x]^2), the affine in float32, the result cast once to
        bfloat16. Against flax on bfloat16 input of three scales: equal on
        at least 99.9% (measured 99.996-99.998%) and within one bfloat16
        ulp elsewhere, where the two float32 sums' orders land a value on
        the other side of a rounding boundary."""
        rng = np.random.default_rng(0)
        norm = fnn.LayerNorm(dtype=jnp.bfloat16)
        ours = layers.LayerNorm(384, dtype=torch.bfloat16)
        weight = rng.standard_normal(384).astype(np.float32)
        bias = rng.standard_normal(384).astype(np.float32)
        ours.load_state_dict({"weight": torch.from_numpy(weight),
                              "bias": torch.from_numpy(bias)})
        x = (rng.standard_normal((256, 384)) * scale).astype(np.float32)
        xb = jnp.asarray(x, jnp.bfloat16)
        want = norm.apply({"params": {"scale": weight, "bias": bias}}, xb)
        assert want.dtype == jnp.bfloat16
        want = np.asarray(want, np.float32)
        with torch.inference_mode():
            got = ours(torch.from_numpy(np.asarray(xb, np.float32))
                       .to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        assert (got == want).mean() >= 0.999
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()

    @pytest.mark.parametrize("size,pads", [(224, (0, 0)), (33, (7, 8)),
                                           (40, (4, 4))])
    def test_patch_conv_pads_as_flax_same(self, size, pads):
        """The patch embedding is flax's ``SAME`` conv, asymmetric where
        the pad is odd (33 -> 7 before, 8 after): float32 within 1e-5 of
        ``nn.Conv`` (measured 8.3e-7 to 1.4e-6), bfloat16 outputs equal
        on at least 99% (measured 100% at all three sizes) and within one
        bfloat16 ulp elsewhere."""
        from ai4e_tpu_torch.models.unet import same_pads

        assert same_pads(size, 16, 16) == pads
        rng = np.random.default_rng(1)
        kernel = (rng.standard_normal((16, 16, 3, 64)) / 28).astype(np.float32)
        bias = rng.standard_normal(64).astype(np.float32)
        x = images(2, size, 2)
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            conv = fnn.Conv(64, (16, 16), strides=(16, 16), dtype=jdt)
            want = np.asarray(conv.apply(
                {"params": {"kernel": kernel, "bias": bias}},
                jnp.asarray(x, jdt)), np.float32)
            model = ViT(**SMALL, image_size=size, dtype=tdt)
            model.embed.weight.data = torch.from_numpy(
                kernel.transpose(3, 2, 0, 1).copy()).to(tdt)
            model.embed.bias.data = torch.from_numpy(bias).to(tdt)
            with torch.inference_mode():
                got = model.patch_embed(torch.from_numpy(x).to(tdt))
            got = got.float().numpy().reshape(want.shape)
            if tdt == torch.float32:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
            else:
                assert (got == want).mean() >= 0.99
                np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)

    def test_softmax_repeats_jax_s_bf16_chain(self):
        """``jax.nn.softmax`` on bfloat16 rounds op by op (its sum in
        float32): ``softmax_bf16`` equals it on all but a few of 1.2 M
        probabilities (measured 100%), where ``torch.softmax``, rounding
        once, equals it on 25%."""
        x = jnp.asarray(np.random.default_rng(3).standard_normal(
            (8, 6, 197, 128)) * 3, jnp.bfloat16)
        want = np.asarray(jax.nn.softmax(x, axis=-1), np.float32)
        t = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
        got = softmax_bf16(t).float().numpy()
        once = torch.softmax(t, dim=-1).float().numpy()
        assert (got == want).mean() >= 0.999
        assert (once == want).mean() < 0.95

    def test_precision_body_bf16_pos_and_head_f32(self):
        model = ViT(**SMALL, image_size=48)
        assert model.pos_embed.dtype == torch.float32
        assert model.embed.weight.dtype == torch.bfloat16
        assert model.blocks[0].attn.qkv.bias is None
        assert model.blocks[0].attn.out.bias is not None
        assert model.head.weight.dtype == torch.float32
        assert model.norm.dtype == torch.bfloat16
        with torch.inference_mode():
            out = model.eval()(torch.from_numpy(images(2, 48, 4)))
        assert out.dtype == torch.float32 and out.shape == (2, 10)


class TestParity:
    @pytest.mark.parametrize("size", [48, 40], ids=["divides", "pads"])
    def test_float32(self, size):
        """Logits within 1e-5 (measured 5.4e-7 at 48, 9.5e-7 at 40,
        padded)."""
        got, want = vit_both(flax_params(size), images(3, size, 5),
                             torch.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("size", [48, 40], ids=["divides", "pads"])
    def test_bfloat16_as_served(self, size):
        """bfloat16 on 8 seeded images: logits of scale 1.6-2.5 within
        2e-2 (measured 7.2e-3 at 48, 1.3e-3 at 40) and the same class on
        at least 7 of 8 (measured 8)."""
        got, want = vit_both(flax_params(size), images(8, size, 6),
                             torch.bfloat16)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
        assert (got.argmax(-1) == want.argmax(-1)).sum() >= 7

    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                            (torch.bfloat16, 2e-2)],
                             ids=["float32", "bfloat16"])
    def test_vit_s16_widths(self, dtype, atol):
        """ViT-S/16 at 224 (dim 384, 6 heads of 64, 1000 classes) with the
        depth cut to 2, on 2 images: logits of scale 3.2; measured
        float32 8.3e-7, bfloat16 5.9e-3."""
        got, want = vit_both(flax_params(224, VIT_S), images(2, 224, 7),
                             dtype, VIT_S)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        assert (got.argmax(-1) == want.argmax(-1)).all()

    def test_deployed_vit_s16_classes_despite_layernorm_ulps(self):
        """ViT-S/16 as deployed (224 px, dim 384, depth 12, 6 heads) in
        bfloat16, as served, on 16 seeded images: the class equals flax's
        wherever flax's top-two logit gap exceeds 1e-2 (measured: 13 of 16
        decided, all 16 equal, logits of scale 3.0 within 8.6e-3). The bf16
        ``LayerNorm`` puts 0.002-0.004% of its outputs one bf16 ulp from
        flax's (``test_layernorm_bf16_rounds_once_as_flax``): XLA:CPU's
        float32 sums and its rsqrt both round elsewhere than PyTorch's, and
        neither a float64 accumulation nor an 8-lane pairwise order gives
        flax's values; those ulps do not move a decided class."""
        got, want = vit_both(flax_params(224, VIT_S_DEPLOYED),
                             images(16, 224, 8), torch.bfloat16,
                             VIT_S_DEPLOYED)
        top2 = np.sort(want, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 1e-2
        assert decided.sum() >= 8, top2
        np.testing.assert_array_equal(got.argmax(-1)[decided],
                                      want.argmax(-1)[decided])


class TestConvert:
    def test_round_trip_through_npz(self, tmp_path):
        params = flax_params()
        sd = convert.vit_state_dict_from_flax(params)
        assert set(sd) == set(ViT(**SMALL, image_size=48).state_dict())
        np.testing.assert_array_equal(
            sd["embed.weight"].numpy(),
            params["params"]["embed"]["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(
            sd["blocks.1.mlp.down.weight"].numpy(),
            params["params"]["block1"]["mlp"]["down"]["kernel"].T)
        path = str(tmp_path / "vit.npz")
        convert.save_npz(convert.vit_flax_from_state_dict(sd), path)
        back = convert.load_npz(path)
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
        model = create_vit(**SMALL, image_size=48, device="cpu")
        tree = convert.vit_flax_from_state_dict(model.state_dict())
        for name, t in convert.vit_state_dict_from_flax(tree).items():
            assert torch.equal(t, model.state_dict()[name].float()), name

    @pytest.mark.parametrize("edit,match", [
        (lambda p: p["block0"]["attn"]["out"].pop("bias"), "missing"),
        (lambda p: p["block1"]["attn"]["qkv"].__setitem__(
            "bias", np.zeros(192, np.float32)), "keys"),
        (lambda p: p.__setitem__("pos_embed", np.zeros((1, 10, 64),
                                                       np.float32)), "shape"),
        (lambda p: p["embed"].__setitem__(
            "kernel", np.zeros((16, 8, 3, 64), np.float32)), "square"),
    ], ids=["missing-bias", "extra-bias", "pos-embed", "kernel"])
    def test_raises(self, edit, match):
        params = flax_params()
        edit(params["params"])
        with pytest.raises(ValueError, match=match):
            convert.vit_state_dict_from_flax(params)


VIT_KW = dict(name="vit", image_size=48, **SMALL, buckets=(1, 4))


class TestServable:
    def test_defaults_and_contract_are_jax_s(self):
        want = inspect.signature(jax_build_vit).parameters
        got = inspect.signature(build_vit).parameters
        for name, param in want.items():
            assert got[name].default == param.default, name
        port = build_vit(**VIT_KW)
        jax_sv = jax_build_vit(**VIT_KW)
        assert port.input_shape == jax_sv.input_shape == (48, 48, 3)
        assert np.dtype(port.input_dtype) == np.dtype(jax_sv.input_dtype) \
            == np.float32
        assert port.batch_buckets == jax_sv.batch_buckets
        assert port.postprocess(np.arange(10.0)) == \
            jax_sv.postprocess(np.arange(10.0)) == {"class_id": 9}
        with pytest.raises(ValueError) as w:
            jax_sv.preprocess(npy(np.zeros((40, 48, 3), np.float32)), "")
        with pytest.raises(ValueError) as g:
            port.preprocess(npy(np.zeros((40, 48, 3), np.float32)), "")
        assert str(g.value) == str(w.value)

    def test_worker_restores_a_vit_npz(self, tmp_path):
        """A spec's ``checkpoint`` restores a ViT ``.npz`` (JAX's weights
        saved flat) into the worker's model: each tensor JAX's, rounded
        once to the served model's type."""
        params = flax_params()
        path = str(tmp_path / "vit.npz")
        convert.save_npz(params, path)
        worker, _, _ = build_worker({"models": [{
            "family": "vit", **VIT_KW, "checkpoint": path}]}, device="cpu")
        got = worker.runtime.models["vit"].module.state_dict()
        for name, t in convert.vit_state_dict_from_flax(params).items():
            assert torch.equal(got[name], t.to(got[name].dtype)), name

    def test_answers_over_http_equal_jax_s_worker(self):
        """Three sync requests each through JAX's worker and the port's on
        the same weights: the same class wherever JAX's top-two logit gap
        exceeds 1e-2."""
        x = images(3, 48, 8)

        async def main():
            stacks = (jax_stack("vit", VIT_KW), port_stack("vit", VIT_KW))
            jax_params = jax.tree.map(np.asarray, stacks[0][2].params)
            port = stacks[1][2]
            port.module.load_state_dict(port.state_dict_from_flax(jax_params))
            async with serving(*stacks) as clients:
                return [[await answer(await c.post(
                    "/v1/echo/run", data=npy(img),
                    headers={"Content-Type": "application/octet-stream"}))
                    for img in x] for c in clients], jax_params

        (want, got), params = asyncio.run(main())
        logits = np.asarray(FlaxViT(**SMALL).apply(params, jnp.asarray(x)))
        held = 0
        for (gs, g), (ws, w), row in zip(got, want, logits):
            assert gs == ws == 200
            assert set(g) == set(w) == {"class_id"}
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] > 1e-2:
                assert g == w
                held += 1
        assert held >= 2
