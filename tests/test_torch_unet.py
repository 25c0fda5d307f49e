"""The port's land-cover UNet (``ai4e_tpu_torch.models.unet``) and weight
conversion (``ai4e_tpu_torch.convert``) against the JAX package's flax UNet.

Weights come from flax's init and reach the port through
``unet_state_dict_from_flax``; inputs are made with numpy from a seed.
Each trap of the translation (padding, normalisation, activation,
precision, upsampling, concat order, layout) has its own assertion."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ai4e_tpu.models.unet import UNet as FlaxUNet
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.models import UNet, segment_logits_to_classes
from ai4e_tpu_torch.models.unet import GROUPNORM_EPS, gelu, same_pads

torch.set_num_threads(2)

DEPLOYED = (64, 128, 256, 512)  # deploy/specs/models.json landcover
SMALL = (8, 16, 32)


@functools.lru_cache(maxsize=None)
def _flax_params(widths, num_classes, tile, seed):
    # The values of ai4e_tpu.models.unet.create_unet; jitted, init takes a
    # fifth of its eager time.
    model = FlaxUNet(num_classes=num_classes, widths=widths)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, tile, tile, 3), jnp.float32))
    return jax.tree.map(np.asarray, params)


def flax_params(widths, num_classes=4, tile=32, seed=0):
    """A fresh copy of the flax params tree as numpy arrays (tests edit it)."""
    return jax.tree.map(np.array, _flax_params(widths, num_classes, tile, seed))


def port_unet(params, dtype=torch.bfloat16):
    sd = convert.unet_state_dict_from_flax(params)
    widths = tuple(sd[f"encoder.{i}.convs.0.weight"].shape[0]
                   for i in range(len([k for k in sd if k.endswith(
                       "convs.0.weight") and k.startswith("encoder.")])))
    model = UNet(num_classes=sd["head.weight"].shape[0], widths=widths,
                 dtype=dtype)
    model.load_state_dict(sd)
    return model.to(memory_format=torch.channels_last).eval()


def forward_both(params, x, dtype):
    """JAX and port logits for one float32 NHWC batch ``x``."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    widths = tuple(params["params"][f"ConvBlock_{i}"]["Conv_0"]["kernel"]
                   .shape[-1] for i in range((len([
                       k for k in params["params"] if "ConvBlock" in k]) + 1) // 2))
    want = np.asarray(FlaxUNet(num_classes=4, widths=widths, dtype=jdt).apply(
        params, jnp.asarray(x)))
    with torch.inference_mode():
        got = port_unet(params, dtype)(torch.from_numpy(x)).numpy()
    return got, want


class TestConvert:
    def test_round_trip_through_npz(self, tmp_path):
        params = flax_params(SMALL)
        path = tmp_path / "unet.npz"
        convert.save_npz(params, str(path))
        back = convert.load_npz(str(path))
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
        sd = convert.unet_state_dict_from_flax(back)
        assert set(sd) == set(UNet(4, SMALL).state_dict())

    def test_layouts(self):
        """HWIO -> OIHW, GroupNorm scale -> weight, one bias (the head's)."""
        params = flax_params(SMALL)
        p = params["params"]
        sd = convert.unet_state_dict_from_flax(params)
        np.testing.assert_array_equal(
            sd["encoder.0.convs.1.weight"].numpy(),
            p["ConvBlock_0"]["Conv_1"]["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(
            sd["decoder.0.norms.1.weight"].numpy(),
            p["ConvBlock_3"]["GroupNorm_1"]["scale"])
        # Flax numbers modules in creation order: down convs Conv_0..1, up
        # convs Conv_2..3, head Conv_4 (the only bias).
        np.testing.assert_array_equal(
            sd["down.1.weight"].numpy(),
            p["Conv_1"]["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(
            sd["up.0.weight"].numpy(),
            p["Conv_2"]["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd["head.bias"].numpy(),
                                      p["Conv_4"]["bias"])
        assert [k for k in sd if k.endswith(".bias") and "norms" not in k] \
            == ["head.bias"]

    def test_deployed_tree_names(self):
        p = flax_params(DEPLOYED, tile=32)["params"]
        assert sorted(k for k in p if k.startswith("Conv_")) == [
            f"Conv_{i}" for i in range(7)]
        assert p["Conv_6"]["kernel"].shape == (1, 1, 64, 4)
        assert set(p["ConvBlock_4"]) == {"Conv_0", "GroupNorm_0", "Conv_1",
                                         "GroupNorm_1"}
        assert p["ConvBlock_4"]["Conv_0"]["kernel"].shape == (3, 3, 512, 256)

    @pytest.mark.parametrize("edit,match", [
        (lambda p: p["params"]["ConvBlock_1"].pop("GroupNorm_0"), "missing"),
        (lambda p: p["params"].__setitem__(
            "Dense_0", {"kernel": np.zeros((2, 2), np.float32)}), "keys"),
        (lambda p: p["params"]["Conv_0"].__setitem__(
            "kernel", np.zeros((3, 3, 8, 9), np.float32)), "shape"),
        (lambda p: p["params"]["Conv_0"].__setitem__(
            "bias", np.zeros((8,), np.float32)), "keys"),
    ], ids=["missing", "extra-module", "wrong-shape", "extra-bias"])
    def test_raises(self, edit, match):
        params = flax_params(SMALL)
        edit(params)
        with pytest.raises(ValueError, match=match):
            convert.unet_state_dict_from_flax(params)


class TestTraps:
    def test_stride2_same_padding_is_asymmetric(self):
        pads = jax.lax.padtype_to_pads((256, 256), (3, 3), (2, 2), "SAME")
        assert [tuple(p) for p in pads] == [(0, 1), (0, 1)]
        assert same_pads(256) == (0, 1) and same_pads(125) == (1, 1)
        x = torch.randn(1, 4, 8, 8).to(memory_format=torch.channels_last)
        padded = F.pad(x, (0, 1, 0, 1))
        assert padded.is_contiguous(memory_format=torch.channels_last)
        # The port's stride-2 conv equals flax's SAME conv on one layer.
        kernel = np.random.default_rng(0).standard_normal(
            (3, 3, 4, 5)).astype(np.float32)
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x.permute(0, 2, 3, 1).numpy()), jnp.asarray(kernel),
            (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        got = F.conv2d(padded, torch.from_numpy(kernel).permute(3, 2, 0, 1),
                       stride=2)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=1e-5)

    def test_groupnorm_matches_flax(self):
        import flax.linen as fnn

        assert all(m.eps == GROUPNORM_EPS == 1e-6 for m in UNet(
            4, SMALL).modules() if isinstance(m, torch.nn.GroupNorm))
        x = np.random.default_rng(1).standard_normal(
            (2, 8, 8, 64)).astype(np.float32) * 1e-3  # eps matters here
        norm = fnn.GroupNorm(num_groups=32)
        want = norm.apply(norm.init(jax.random.PRNGKey(0), x), x)
        got = F.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2), 32,
                           eps=GROUPNORM_EPS).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

    def test_gelu_is_the_tanh_approximation(self):
        x = np.linspace(-6, 6, 1001, dtype=np.float32)
        want = np.asarray(jax.nn.gelu(jnp.asarray(x)))  # flax nn.gelu
        got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_array_equal(gelu(torch.from_numpy(x)).numpy(), got)
        assert not np.allclose(F.gelu(torch.from_numpy(x)).numpy(), want,
                               atol=1e-6)

    def test_gelu_bfloat16_is_jax_bit_for_bit(self):
        """Every bfloat16 with 1e-6 < |x| < 16: JAX rounds its constants
        and each op to bfloat16, and the port's chain does the same. (XLA
        on the CPU flushes subnormal products to zero and PyTorch does
        not, so inputs whose cube is subnormal are left out.)"""
        bits = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
        with np.errstate(invalid="ignore"):
            x = bits[(np.abs(bits) > 1e-6) & (np.abs(bits) < 16)]
        want = np.asarray(jax.nn.gelu(jnp.asarray(x, jnp.bfloat16)),
                          np.float32)
        got = gelu(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
        np.testing.assert_array_equal(got, want)

    def test_precision_body_bf16_head_f32_with_bias(self):
        model = UNet(4, SMALL)
        convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
        assert all(c.weight.dtype == torch.bfloat16 for c in convs
                   if c is not model.head)
        assert model.head.weight.dtype == torch.float32
        assert model.head.bias is not None
        assert [c for c in convs if c.bias is not None] == [model.head]
        with torch.inference_mode():
            out = model(torch.rand(1, 16, 16, 3))
        assert out.dtype == torch.float32 and out.shape == (1, 16, 16, 4)

    def test_upsample_is_jax_nearest_at_2x(self):
        x = np.random.default_rng(2).standard_normal(
            (1, 5, 6, 3)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 10, 12, 3),
                                           "nearest"))
        t = torch.from_numpy(x).permute(0, 3, 1, 2)
        for got in (F.interpolate(t, scale_factor=2, mode="nearest"),
                    F.interpolate(t, size=(10, 12), mode="nearest-exact")):
            np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)

    def test_concat_order_up_then_skip(self):
        model = UNet(4, SMALL)
        for block, w in zip(model.decoder, reversed(SMALL[:-1])):
            assert block.convs[0].in_channels == 2 * w
        seen = {}

        def keep(name):
            def hook(module, inputs, output):
                seen[name] = (inputs[0], output)
            return hook

        model.up[0].register_forward_hook(keep("up"))
        model.encoder[1].register_forward_hook(keep("skip"))
        model.decoder[0].convs[0].register_forward_hook(keep("cat"))
        with torch.inference_mode():
            model(torch.rand(1, 16, 16, 3))
        cat, up, skip = seen["cat"][0], seen["up"][1], seen["skip"][1]
        w = SMALL[1]
        assert torch.equal(cat[:, :w], up) and torch.equal(cat[:, w:], skip)

    def test_layout_nhwc_out_channels_last_inside(self):
        model = UNet(4, SMALL).to(memory_format=torch.channels_last)
        seen = {}

        def hook(module, inputs, output):
            seen["head"] = output.is_contiguous(
                memory_format=torch.channels_last)

        model.head.register_forward_hook(hook)
        x = torch.rand(2, 16, 16, 3)
        assert x.permute(0, 3, 1, 2).is_contiguous(
            memory_format=torch.channels_last)  # no copy to enter NCHW
        with torch.inference_mode():
            out = model(x)
        assert seen["head"], "head output is not channels_last"
        assert out.is_contiguous() and out.shape == (2, 16, 16, 4)

    def test_segment_logits_to_classes(self):
        logits = np.random.default_rng(3).standard_normal(
            (2, 8, 8, 4)).astype(np.float32)
        from ai4e_tpu.models.unet import segment_logits_to_classes as jax_seg
        np.testing.assert_array_equal(
            segment_logits_to_classes(torch.from_numpy(logits)).numpy(),
            np.asarray(jax_seg(jnp.asarray(logits))))


class TestParityAtDeployedWidths:
    """Deployed land-cover widths (64, 128, 256, 512), 4 classes, tile
    256, the same converted weights on both sides."""

    @pytest.fixture(scope="class")
    def params(self):
        return flax_params(DEPLOYED, tile=32)

    @pytest.fixture(scope="class")
    def tile(self):
        return np.random.default_rng(7).uniform(
            size=(1, 256, 256, 3)).astype(np.float32)

    def test_float32(self, params, tile):
        """Both in float32: the convolutions sum in different orders, so
        logits agree to 1e-3 relative to their scale, and the argmax on at
        least 99.99% of pixels."""
        got, want = forward_both(params, tile, torch.float32)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale)
        agree = float((got.argmax(-1) == want.argmax(-1)).mean())
        assert agree >= 0.9999, agree

    def test_bfloat16_as_served(self, params, tile):
        """The served precision: bf16 body, f32 head. gelu rounds as JAX
        does (``models.unet.gelu``); the convolutions still sum in other
        orders, and a last-bit difference in float32 moves a bfloat16
        rounding that the next 17 layers carry on. Measured agreement on
        this input: 99.15% of pixels (99.13% and 99.05% on the tiles of
        seeds 8 and 9; 98.89% with ``F.gelu``'s single rounding)."""
        got, want = forward_both(params, tile, torch.bfloat16)
        assert np.isfinite(got).all() and got.shape == (1, 256, 256, 4)
        agree = float((got.argmax(-1) == want.argmax(-1)).mean())
        assert agree >= 0.99, agree
