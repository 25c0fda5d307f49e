"""The port's species ResNet (``ai4e_tpu_torch.models.resnet``), its weight
conversion and its servable against the JAX package's flax ``ResNet`` and
``build_resnet``.

Weights come from flax's init and reach the port through
``resnet_state_dict_from_flax``. A fresh ResNet hides most of its
arithmetic: each bottleneck's third BatchNorm starts at scale zero (the
block is the identity on its shortcut) and the running statistics at zero
and one, so the parity tests perturb every BatchNorm's scale, bias, mean
and variance first. Inputs are made with numpy from a seed."""

import functools
import io
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ai4e_tpu.models.resnet import ResNet as FlaxResNet
from ai4e_tpu.runtime.families import build_resnet as jax_build_resnet
from ai4e_tpu.runtime.ladder import DETECTOR_BUCKETS as JAX_DETECTOR_BUCKETS
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.models import ResNet
from ai4e_tpu_torch.models.resnet import BatchNorm, max_pool_same
from ai4e_tpu_torch.models.unet import same_conv
from ai4e_tpu_torch.runtime.families import build_servable
from ai4e_tpu_torch.runtime.ladder import DETECTOR_BUCKETS

torch.set_num_threads(2)

#: (image size, stage sizes, width, classes): a small geometry and the
#: ``species`` entry of deploy/specs/models.json.
SMALL = (32, (1, 1), 8, 4)
DEPLOYED = (224, (2, 2, 2), 32, 8)
LABELS = ["lion", "zebra", "elephant", "giraffe", "leopard", "okapi",
          "rhino", "buffalo"]
# bfloat16 logits: the two frameworks round the convs' bfloat16 products
# at other places; measured 6.1e-4 at the deployed geometry.
LOGIT_ATOL = 5e-3
F32_ATOL = 1e-4  # the float32 model: only summation order differs


@functools.lru_cache(maxsize=None)
def _variables(size, stages, width, classes):
    model = FlaxResNet(stage_sizes=stages, num_classes=classes, width=width)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, size, size, 3), jnp.float32))
    return jax.tree.map(np.asarray, variables)


def perturbed(size, stages, width, classes, seed=0):
    """flax's init with every BatchNorm's scale, bias, mean and variance
    drawn from a seed, so no bottleneck is the identity."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if "BatchNorm" not in name:
            return np.array(a)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name.endswith("['mean']"):
            return rng.normal(0.0, 0.2, a.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, _variables(size, stages, width, classes))


def port_resnet(variables, stages, width, classes, dtype=torch.bfloat16):
    model = ResNet(stage_sizes=stages, num_classes=classes, width=width,
                   dtype=dtype)
    model.load_state_dict(convert.resnet_state_dict_from_flax(variables))
    return model.to(memory_format=torch.channels_last).eval()


def logits_both(geometry, batch, dtype=torch.bfloat16, seed=0):
    size, stages, width, classes = geometry
    variables = perturbed(*geometry, seed=seed)
    x = np.random.default_rng(seed + 1).uniform(
        0, 1, (batch, size, size, 3)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(FlaxResNet(stage_sizes=stages, num_classes=classes,
                                 width=width, dtype=jdt).apply(variables, x))
    with torch.inference_mode():
        got = port_resnet(variables, stages, width, classes, dtype)(
            torch.from_numpy(x)).numpy()
    return got, want


def assert_same_classes(got, want, atol):
    """argmax equal wherever the reference's top-two gap exceeds twice the
    logit tolerance."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * atol
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


class TestParity:
    @pytest.mark.parametrize("geometry,batch", [(SMALL, 2), (DEPLOYED, 2)],
                             ids=["small", "deployed"])
    def test_bf16_logits(self, geometry, batch):
        got, want = logits_both(geometry, batch)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
        assert_same_classes(got, want, LOGIT_ATOL)

    @pytest.mark.parametrize("size", [32, 33], ids=["even", "odd"])
    def test_float32_logits(self, size):
        """The float32 model has no bfloat16 rounding to hide behind: the
        SAME pads, the pool and BatchNorm's order must all be right."""
        got, want = logits_both((size, (1, 1), 8, 4), 2, torch.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)

    def test_perturbation_matters(self):
        """On flax's own init the third BatchNorm zeroes each bottleneck's
        body; the perturbed weights must not."""
        size, stages, width, classes = SMALL
        fresh = _variables(*SMALL)
        for name, block in fresh["params"].items():
            if name.startswith("Bottleneck_"):
                assert not block["BatchNorm_2"]["scale"].any()
        varied = perturbed(*SMALL)
        assert varied["params"]["Bottleneck_0"]["BatchNorm_2"]["scale"].all()


class TestLayers:
    @pytest.mark.parametrize("size", [7, 8, 111, 112])
    def test_max_pool_same(self, size):
        """flax's SAME pool pads (0, 1) at an even size, where a symmetric
        ``padding=1`` moves every window."""
        x = np.random.default_rng(size).normal(
            0, 1, (2, size, size, 4)).astype(np.float32)
        want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), (2, 2),
                                       padding="SAME"))
        nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = max_pool_same(nchw).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)
        symmetric = F.max_pool2d(nchw, 3, 2, padding=1).permute(0, 2, 3, 1)
        assert np.array_equal(symmetric.numpy(), want) == (size % 2 == 1)

    @pytest.mark.parametrize("size", [7, 8, 55, 56])
    def test_strided_same_conv(self, size):
        x = np.random.default_rng(size).normal(
            0, 1, (2, size, size, 4)).astype(np.float32)
        conv = fnn.Conv(5, (3, 3), (2, 2), padding="SAME", use_bias=False)
        params = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))
        want = np.asarray(conv.apply(params, jnp.asarray(x)))
        tconv = torch.nn.Conv2d(4, 5, 3, stride=2, padding=0, bias=False)
        with torch.no_grad():
            tconv.weight.copy_(convert._conv_weight(
                params["params"]["kernel"]))
            got = same_conv(tconv, torch.from_numpy(x).permute(0, 3, 1, 2))
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def test_batchnorm_is_flax_s_bit_for_bit(self):
        """Running statistics in float32, ``(x - mean) * (rsqrt(var + eps)
        * scale) + bias``, cast to bfloat16: flax's order of operations."""
        rng = np.random.default_rng(0)
        c = 16
        x = rng.normal(0, 2, (2, 9, 9, c)).astype(np.float32)
        xb = jnp.asarray(x, jnp.bfloat16)
        variables = {
            "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": rng.normal(0, 0.1, c).astype(np.float32)},
            "batch_stats": {"mean": rng.normal(0, 0.3, c).astype(np.float32),
                            "var": rng.uniform(0.5, 2, c).astype(np.float32)}}
        want = fnn.BatchNorm(use_running_average=True, dtype=jnp.bfloat16
                             ).apply(variables, xb)
        norm = BatchNorm(c)
        with torch.no_grad():
            norm.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
            norm.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
            norm.running_mean.copy_(
                torch.from_numpy(variables["batch_stats"]["mean"]))
            norm.running_var.copy_(
                torch.from_numpy(variables["batch_stats"]["var"]))
            got = norm(torch.from_numpy(x).to(torch.bfloat16)
                       .permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
        assert set(dict(norm.named_buffers())) == {"running_mean",
                                                   "running_var"}

    def test_detector_ladder_is_jax_s(self):
        assert DETECTOR_BUCKETS == JAX_DETECTOR_BUCKETS


class TestConvert:
    def test_round_trip_through_npz(self, tmp_path):
        variables = perturbed(*SMALL)
        path = tmp_path / "species.npz"
        convert.save_npz(variables, str(path))
        back = convert.load_npz(str(path))
        assert jax.tree.structure(back) == jax.tree.structure(variables)
        sd = convert.resnet_state_dict_from_flax(back)
        model = ResNet(stage_sizes=SMALL[1], num_classes=SMALL[3],
                       width=SMALL[2], dtype=torch.float32)
        model.load_state_dict(sd)
        again = convert.resnet_flax_from_state_dict(model.state_dict())
        assert jax.tree.structure(again) == jax.tree.structure(variables)
        for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(variables)):
            np.testing.assert_array_equal(a, b)
        want = variables["batch_stats"]["Bottleneck_0"]["BatchNorm_1"]["var"]
        assert torch.equal(model.blocks[0].norms[1].running_var,
                           torch.from_numpy(want))

    @pytest.mark.parametrize("edit", ["missing", "extra", "shape"])
    def test_bad_trees_raise(self, edit):
        variables = perturbed(*SMALL)
        if edit == "missing":
            del variables["batch_stats"]["Bottleneck_1"]["BatchNorm_3"]
        elif edit == "extra":
            variables["params"]["Dense_1"] = {"kernel": np.zeros((64, 4))}
        else:
            variables["params"]["Dense_0"]["bias"] = np.zeros(5, np.float32)
        with pytest.raises(ValueError):
            convert.resnet_state_dict_from_flax(variables)


def npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


class TestServable:
    @pytest.mark.parametrize("labels", [None, LABELS], ids=["ids", "labels"])
    def test_matches_jax_servable_on_uint8(self, labels):
        """``build_servable("resnet")`` on the JAX servable's weights: the
        normalize -> ResNet apply on uint8 pixels and the JSON of
        postprocess, against JAX's (its normalize in interpret mode)."""
        size, stages, width, classes = DEPLOYED
        kwargs = dict(name="species", image_size=size, num_classes=classes,
                      stage_sizes=stages, width=width, labels=labels,
                      buckets=(1, 4))
        jax_servable = jax_build_resnet(**kwargs)
        variables = jax.tree.map(np.asarray, jax_servable.params)
        port = build_servable("resnet", **kwargs)
        assert port.input_dtype == np.uint8
        assert port.input_shape == jax_servable.input_shape
        port.module.load_state_dict(
            convert.resnet_state_dict_from_flax(variables))
        images = np.random.default_rng(3).integers(
            0, 256, (4, size, size, 3), np.uint8)
        want = np.asarray(jax_servable.apply_fn(jax_servable.params,
                                                jnp.asarray(images)))
        with torch.inference_mode():
            got = port.apply_fn(port.module, torch.from_numpy(images)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
        assert_same_classes(got, want, LOGIT_ATOL)
        for g, w in zip(got, want):
            got_json = json.loads(json.dumps(port.postprocess(g)))
            want_json = json.loads(json.dumps(jax_servable.postprocess(w)))
            assert set(got_json) == set(want_json) == {
                "class_id", "label", "confidence"}
            if abs(np.diff(np.sort(w)[-2:])[0]) > 2 * LOGIT_ATOL:
                assert got_json["class_id"] == want_json["class_id"]
                assert got_json["label"] == want_json["label"]
            assert abs(got_json["confidence"] - want_json["confidence"]) \
                < LOGIT_ATOL
        # The preprocess is JAX's: npy of the exact shape, or an image.
        assert np.array_equal(port.preprocess(npy(images[0]), ""), images[0])
        with pytest.raises(ValueError, match="expected"):
            port.preprocess(npy(images[0, :8]), "")

    def test_reload_tree_check_takes_both_collections(self):
        from ai4e_tpu_torch.runtime.registry import ModelRuntime

        size, stages, width, classes = SMALL
        runtime = ModelRuntime(device="cpu")
        servable = runtime.register(build_servable(
            "resnet", name="cls", image_size=size, num_classes=classes,
            stage_sizes=stages, width=width, buckets=(1,)))
        variables = perturbed(*SMALL)
        runtime.reload_params("cls", variables)
        assert servable.params_version == 2
        assert torch.equal(
            servable.module.stem_norm.running_mean,
            torch.from_numpy(variables["batch_stats"]["BatchNorm_0"]["mean"]))
        del variables["batch_stats"]
        with pytest.raises(ValueError, match="does not match"):
            runtime.reload_params("cls", variables)

    @pytest.mark.parametrize("wire,item", [("yuv420", "A9"), ("dct", "A9")])
    def test_compressed_wires_name_their_item(self, wire, item):
        """The compressed wires, ported under ROADMAP ``item``, build as
        JAX's do: the wire's byte layout as the input, uint8 stacks, and a
        size the wire cannot encode refused at build time, naming it."""
        servable = build_servable("resnet", image_size=32, stage_sizes=(1,),
                                  width=8, num_classes=4, wire=wire)
        want = jax_build_resnet(image_size=32, stage_sizes=(1,), width=8,
                                num_classes=4, wire=wire)
        assert servable.input_shape == want.input_shape
        assert np.dtype(servable.input_dtype) == np.dtype(want.input_dtype)
        assert servable.stack_item_shape == want.stack_item_shape == (32, 32,
                                                                      3)
        with pytest.raises(ValueError, match=f"wire='{wire}' needs"):
            build_servable("resnet", image_size=30 if wire == "dct" else 31,
                           stage_sizes=(1,), width=8, num_classes=4,
                           wire=wire)
