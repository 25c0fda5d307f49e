"""The compressed image wires in the port (``ai4e_tpu_torch.ops.yuv``,
``ai4e_tpu_torch.ops.dct`` and the wire servables of
``runtime/families.py``) against the JAX package's (``ai4e_tpu.ops.yuv``,
``ai4e_tpu.ops.dct``, ``build_unet``/``build_resnet``/``build_detector``
with ``wire=``).

Inputs are made with numpy from a seed. The device decodes are held to
1e-6 (yuv420: the same float32 operations in the same order) and 1e-5
(dct: the inverse DCT's products sum in another order) of JAX's on the
same payload; the host encoders and inverses bit for bit (an encoder's
C++ build within the numpy version's 1-LSB contract, as JAX's); the
servables at the tolerances of the rgb8 parity tests (the land-cover
argmax on 99% of pixels, C1's gate; the ResNet's logits within
``test_torch_resnet.LOGIT_ATOL``; the detector's heads within
``test_torch_detector.HEAD_ATOL`` and its decoded rows as
``test_torch_detector`` compares them). A batch stack and the camera-trap
crops handoff run on each wire against the JAX worker."""

import asyncio
import copy
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_handoff as handoff
from ai4e_tpu.ops import dct as jax_dct
from ai4e_tpu.ops import yuv as jax_yuv
from ai4e_tpu.runtime.families import build_detector as jax_build_detector
from ai4e_tpu.runtime.families import build_resnet as jax_build_resnet
from ai4e_tpu.runtime.families import build_unet as jax_build_unet
from ai4e_tpu_torch.ops import dct, yuv
from ai4e_tpu_torch.runtime.families import build_servable
from test_torch_handoff import checkpoints  # noqa: F401 — a fixture
from test_torch_detector import (HEAD_ATOL, SCORE_TOL, ambiguous,
                                 jnp_decode, peak_pixels, sigmoid,
                                 torch_decode)
from test_torch_resnet import LOGIT_ATOL, assert_same_classes, perturbed

torch.set_num_threads(2)

WIRES = ("yuv420", "dct")
#: (H, W): square, not square, and 224 (a multiple of 16, not a power of
#: two: species' input).
SIZES = [(16, 16), (48, 80), (224, 224)]
YUV_ATOL = 1e-6
DCT_ATOL = 1e-5
ENCODE = {"yuv420": yuv.rgb_to_yuv420, "dct": dct.rgb_to_dct}
JAX_ENCODE = {"yuv420": jax_yuv.rgb_to_yuv420, "dct": jax_dct.rgb_to_dct}


def images(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """uint8 RGB: a smooth field under coloured blocks and some noise, so
    chroma and high frequencies both carry information."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        img = np.stack([128 + 90 * np.sin(yy / rng.uniform(5, 20)
                                          + xx / rng.uniform(5, 20) + c)
                        for c in range(3)], axis=-1)
        for _ in range(3):
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            img[y0:y0 + h // 3, x0:x0 + w // 3] = rng.integers(0, 256, 3)
        img += rng.normal(0, 12, img.shape)
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def payload(wire: str, imgs: np.ndarray, encode=ENCODE) -> np.ndarray:
    return np.stack([encode[wire](x) for x in imgs])


class TestDecode:
    @pytest.mark.parametrize("h,w", SIZES)
    def test_yuv420_matches_jax(self, h, w):
        flat = payload("yuv420", images(3, h, w, seed=h + w))
        got = yuv.yuv420_to_rgb(torch.from_numpy(flat), h, w)
        want = np.asarray(jax_yuv.yuv420_to_rgb(jnp.asarray(flat), h, w))
        assert got.dtype == torch.float32 and got.shape == (3, h, w, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=YUV_ATOL)
        assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0

    @pytest.mark.parametrize("h,w", SIZES)
    def test_dct_matches_jax(self, h, w):
        flat = payload("dct", images(3, h, w, seed=h * w))
        got = dct.dct_to_rgb(torch.from_numpy(flat), h, w)
        want = np.asarray(jax_dct.dct_to_rgb(jnp.asarray(flat), h, w))
        assert got.dtype == torch.float32 and got.shape == (3, h, w, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DCT_ATOL)

    def test_dct_decode_takes_the_wire_s_extremes(self):
        """Every coefficient at +-127 (far past what an image quantises
        to): the clip to [0, 1] and the int8 view hold as JAX's."""
        h = w = 32
        n = dct.dct_nbytes(h, w)
        flat = np.resize(np.array([127, -127, 0, 5], np.int8), (2, n))
        got = dct.dct_to_rgb(torch.from_numpy(flat), h, w).numpy()
        want = np.asarray(jax_dct.dct_to_rgb(jnp.asarray(flat), h, w))
        np.testing.assert_allclose(got, want, rtol=0, atol=DCT_ATOL)

    def test_tables_and_sizes_are_jax_s(self):
        for k, q in ((4, 75), (2, 30), (8, 95)):
            for got, want in zip(dct.quant_tables(k, q),
                                 jax_dct.quant_tables(k, q)):
                np.testing.assert_array_equal(got, want)
            assert dct.dct_nbytes(64, 48, k) == jax_dct.dct_nbytes(64, 48, k)
        np.testing.assert_array_equal(dct.dct_matrix(), jax_dct.dct_matrix())
        assert yuv.yuv420_nbytes(256, 256) == 98304
        assert dct.dct_nbytes(256, 256) == 24576
        luma, chroma, basis = dct.device_tables(torch.device("cpu"))
        assert dct.device_tables(torch.device("cpu"))[0] is luma  # made once
        assert basis.shape == (4, 8) and luma.dtype == torch.float32


class TestHostCodecs:
    @pytest.mark.parametrize("wire", WIRES)
    @pytest.mark.parametrize("h,w", SIZES)
    def test_numpy_encoders_are_jax_s_bit_for_bit(self, wire, h, w):
        img = images(1, h, w, seed=3)[0]
        port = {"yuv420": yuv._rgb_to_yuv420_numpy,
                "dct": dct._rgb_to_dct_numpy}[wire]
        ref = {"yuv420": jax_yuv._rgb_to_yuv420_numpy,
               "dct": jax_dct._rgb_to_dct_numpy}[wire]
        got, want = port(img), ref(img)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("wire", WIRES)
    @pytest.mark.parametrize("h,w", SIZES)
    def test_cpp_encoder_within_jax_s_contract(self, wire, h, w):
        """The port's C++ encoder, built from its own copy of the source
        into ``build/ai4e_tpu_torch``: within 1 LSB of JAX's numpy version
        (JAX's stated contract) and bit-equal to JAX's dispatching
        encoder."""
        mod = {"yuv420": yuv, "dct": dct}[wire]
        assert mod.encoder() == "cpp", "the C++ encoder did not build"
        img = images(1, h, w, seed=4)[0]
        got = ENCODE[wire](img)
        ref_numpy = {"yuv420": jax_yuv._rgb_to_yuv420_numpy,
                     "dct": jax_dct._rgb_to_dct_numpy}[wire](img)
        assert np.abs(got.astype(int) - ref_numpy.astype(int)).max() <= 1
        np.testing.assert_array_equal(got, JAX_ENCODE[wire](img))

    def test_library_lands_in_the_port_s_build_directory(self):
        from ai4e_tpu_torch.utils import native_build

        path = native_build.build_native_library("yuv_codec.cpp",
                                                 "libyuv_codec.so")
        assert path.startswith(str(native_build.BUILD_DIR))
        assert "ai4e_tpu_torch" in path and path.endswith(".so")

    @pytest.mark.parametrize("h,w", SIZES)
    def test_host_inverses_are_jax_s_bit_for_bit(self, h, w):
        img = images(1, h, w, seed=5)[0]
        flat = yuv.rgb_to_yuv420(img)
        np.testing.assert_array_equal(yuv.yuv420_to_rgb_numpy(flat, h, w),
                                      jax_yuv.yuv420_to_rgb_numpy(flat, h, w))
        flat = dct.rgb_to_dct(img)
        np.testing.assert_array_equal(dct.dct_to_rgb_numpy(flat, h, w),
                                      jax_dct.dct_to_rgb_numpy(flat, h, w))

    @pytest.mark.parametrize("wire", WIRES)
    @pytest.mark.parametrize("bad", [np.zeros((32, 32, 3), np.float32),
                                     np.zeros((32, 32, 4), np.uint8),
                                     np.zeros((32, 32), np.uint8)],
                             ids=["float", "rgba", "gray"])
    def test_encoders_refuse_what_jax_s_refuse(self, wire, bad):
        with pytest.raises(ValueError, match="uint8") as got:
            ENCODE[wire](bad)
        with pytest.raises(ValueError) as want:
            JAX_ENCODE[wire](bad)
        assert str(got.value) == str(want.value)


class TestBuildRejections:
    @pytest.mark.parametrize("family,flag,kwargs", [
        ("unet", "fused_postprocess", {"tile": 64, "widths": [8]}),
        ("resnet", "fused_normalize", {"image_size": 32, "width": 8,
                                       "stage_sizes": [1]}),
        ("detector", "fused_normalize", {"image_size": 64,
                                         "widths": [8, 8, 8]}),
    ])
    @pytest.mark.parametrize("wire", WIRES)
    def test_compressed_wire_needs_fused_ingestion(self, family, flag,
                                                   kwargs, wire):
        with pytest.raises(ValueError, match=f"wire='{wire}' requires "
                                             f"{flag}=True"):
            build_servable(family, wire=wire, **{flag: False}, **kwargs)

    @pytest.mark.parametrize("family", ["unet", "resnet", "detector"])
    def test_unknown_wire(self, family):
        with pytest.raises(ValueError, match=r"wire must be rgb8\|yuv420\|dct"):
            build_servable(family, wire="bmp")

    @pytest.mark.parametrize("family,size_key", [
        ("unet", "tile"), ("resnet", "image_size"),
        ("detector", "image_size")])
    @pytest.mark.parametrize("wire,size,match", [
        ("yuv420", 63, "needs even dims, got 63x63"),
        ("dct", 40, "needs dims divisible by 16, got 40x40"),
        ("dct", 24, "needs dims divisible by 16, got 24x24")])
    def test_size_the_wire_cannot_encode(self, family, size_key, wire, size,
                                         match):
        builders = {"unet": jax_build_unet, "resnet": jax_build_resnet,
                    "detector": jax_build_detector}
        with pytest.raises(ValueError, match=match):
            build_servable(family, wire=wire, **{size_key: size})
        with pytest.raises(ValueError, match=match):
            builders[family](wire=wire, **{size_key: size})


def run_both(jax_servable, port, batch: np.ndarray):
    """Each servable's device outputs on the same wire payload: its
    ``apply_fn`` on the batch (JAX's Pallas kernels in interpret mode)."""
    with torch.inference_mode():
        got = port.apply_fn(port.module, torch.from_numpy(batch))
    want = jax_servable.apply_fn(jax_servable.params, jnp.asarray(batch))
    as_numpy = (lambda out: {k: np.asarray(v) for k, v in out.items()}
                if isinstance(out, dict) else np.asarray(out))
    return as_numpy(got), as_numpy(want)


class TestServables:
    @pytest.mark.parametrize("wire", WIRES)
    def test_unet_argmax_matches_jax(self, wire):
        """Land cover on the wire, decode -> UNet -> argmax + histogram:
        the class map agrees on at least 99% of pixels (C1's gate) and
        the histogram sums to the tile."""
        kwargs = dict(name="lc", tile=64, widths=[8, 16, 32], num_classes=4,
                      buckets=(2,), wire=wire, return_classmap=True)
        jax_servable = jax_build_unet(**kwargs)
        port = build_servable("unet", **kwargs)
        assert port.input_shape == jax_servable.input_shape
        assert np.dtype(port.input_dtype) == np.dtype(jax_servable.input_dtype)
        port.module.load_state_dict(port.state_dict_from_flax(
            jax.tree.map(np.asarray, jax_servable.params)))
        batch = payload(wire, images(2, 64, 64, seed=11))
        got, want = run_both(jax_servable, port, batch)
        agree = float((got["classmap"] == np.asarray(want["classmap"]))
                      .mean())
        assert agree >= 0.99, agree
        assert (got["counts"].sum(-1) == 64 * 64).all()
        result = port.postprocess({k: v[0] for k, v in got.items()})
        assert sum(result["class_histogram"].values()) == 64 * 64

    @pytest.mark.parametrize("wire", WIRES)
    def test_resnet_logits_match_jax(self, wire):
        """Species on the wire, every BatchNorm perturbed (a fresh init
        hides most of the ResNet): logits within ``LOGIT_ATOL``, the class
        equal wherever the top-two gap is clear of it."""
        geometry = (32, (1, 1), 8, 4)
        size, stages, width, classes = geometry
        kwargs = dict(name="sp", image_size=size, stage_sizes=stages,
                      width=width, num_classes=classes, buckets=(4,),
                      wire=wire)
        jax_servable = jax_build_resnet(**kwargs)
        jax_servable.params = perturbed(*geometry, seed=2)
        port = build_servable("resnet", **kwargs)
        port.module.load_state_dict(
            port.state_dict_from_flax(jax_servable.params))
        batch = payload(wire, images(4, size, size, seed=12))
        got, want = run_both(jax_servable, port, batch)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=LOGIT_ATOL)
        assert_same_classes(got, np.asarray(want), LOGIT_ATOL)

    @pytest.mark.parametrize("wire", WIRES)
    def test_detector_matches_jax(self, wire):
        """The detector on the wire: the heads on each package's decode of
        the same payload within ``HEAD_ATOL``, then the served rows
        compared peak by peak, skipping only peaks whose reference
        decision (threshold, top-k cut, 3x3 NMS) lies within
        ``SCORE_TOL``."""
        from ai4e_tpu.models.detector import CenterNetDetector as Flax

        size, widths = 64, (8, 16, 32)
        kwargs = dict(name="det", image_size=size, widths=widths,
                      buckets=(2,), wire=wire)
        jax_servable = jax_build_detector(**kwargs)
        params = jax.tree.map(np.asarray, jax_servable.params)
        port = build_servable("detector", **kwargs)
        port.module.load_state_dict(port.state_dict_from_flax(params))
        batch = payload(wire, images(2, size, size, seed=13))
        decode = {"yuv420": (yuv.yuv420_to_rgb, jax_yuv.yuv420_to_rgb),
                  "dct": (dct.dct_to_rgb, jax_dct.dct_to_rgb)}[wire]
        want_heads = Flax(widths=widths).apply(
            params, decode[1](jnp.asarray(batch), size, size))
        with torch.inference_mode():
            got_heads = port.module(decode[0](torch.from_numpy(batch),
                                              size, size))
        for key in ("heatmap", "wh", "offset"):
            np.testing.assert_allclose(got_heads[key].numpy(),
                                       np.asarray(want_heads[key]), rtol=0,
                                       atol=HEAD_ATOL, err_msg=key)
        got, want = run_both(jax_servable, port, batch)
        heat = sigmoid(np.asarray(want_heads["heatmap"]))
        want_pix = peak_pixels(jnp_decode, np.asarray(want_heads["heatmap"]))
        got_pix = peak_pixels(torch_decode, got_heads["heatmap"].numpy())
        checked = 0
        for i in range(len(batch)):
            cut = float(np.asarray(want["scores"])[i, -1])
            index = {tuple(p): k for k, p in enumerate(got_pix[i])}
            for k, pixel in enumerate(map(tuple, want_pix[i])):
                # Fill rows (fewer peaks than rows) score 0 on both sides.
                if (np.asarray(want["scores"])[i, k] <= 0
                        or ambiguous(heat[i], pixel, cut)):
                    continue
                assert pixel in index, (i, pixel)
                j = index[pixel]
                assert abs(float(got["scores"][i, j])
                           - float(np.asarray(want["scores"])[i, k])) \
                    <= SCORE_TOL
                assert int(got["classes"][i, j]) == pixel[2]
                checked += 1
        assert checked >= 16


class TestRuntimeOnWires:
    @pytest.mark.parametrize("wire,dtype", [("yuv420", np.uint8),
                                            ("dct", np.int8)])
    def test_ladder_and_staging_take_the_wire_s_shape_and_dtype(
            self, wire, dtype):
        """A derived ladder on a wire servable fingerprints and prepares
        the wire's layout (JAX's fingerprint string), and the batcher's
        staging ring holds it in the wire's dtype (int8 for dct)."""
        from ai4e_tpu.runtime.ladder import \
            servable_fingerprint as jax_fingerprint
        from ai4e_tpu_torch.metrics import MetricsRegistry
        from ai4e_tpu_torch.runtime.batcher import MicroBatcher
        from ai4e_tpu_torch.runtime.ladder import servable_fingerprint
        from ai4e_tpu_torch.runtime.registry import ModelRuntime

        kwargs = dict(name="sp", image_size=32, stage_sizes=(1,), width=8,
                      num_classes=4, buckets=(1, 4), wire=wire)
        runtime = ModelRuntime(device="cpu")
        servable = runtime.register(build_servable("resnet", **kwargs))
        assert servable_fingerprint(servable) == jax_fingerprint(
            jax_build_resnet(**kwargs))
        assert np.dtype(dtype).name in servable_fingerprint(servable)
        runtime.warmup()
        assert runtime.prepare_buckets("sp", [3]) == (3,)
        assert runtime.apply_ladder("sp", (1, 3, 4)) == (1, 3, 4)
        batcher = MicroBatcher(runtime, metrics=MetricsRegistry(),
                               double_buffer=True)
        ring = batcher._staging_buffer("sp", 3, servable)
        assert ring.shape == (3, *servable.input_shape)
        assert ring.dtype == np.dtype(dtype)


class TestStacksAndHandoffs:
    @pytest.mark.parametrize("wire", WIRES)
    def test_batch_stack_converts_item_by_item(self, wire):
        """A batch-API stack of (N, H, W, 3) uint8 on a wire servable: each
        item goes through the wire's encoder (bit-equal to JAX's
        ``stack_adapter``) and answers as that item's own request does."""
        from aiohttp.test_utils import TestClient, TestServer

        from ai4e_tpu_torch.cli import build_worker

        spec = {"service_name": "sp", "prefix": "v1/sp", "models": [
            {"family": "resnet", "name": "sp", "image_size": 32,
             "stage_sizes": [1], "width": 8, "num_classes": 4,
             "buckets": [1, 4], "wire": wire, "batch": True}]}
        worker, batcher, _ = build_worker(spec, device="cpu")
        servable = worker.runtime.models["sp"]
        want_servable = jax_build_resnet(image_size=32, stage_sizes=[1],
                                         width=8, num_classes=4, wire=wire)
        stack = images(5, 32, 32, seed=14)
        for item in stack:
            np.testing.assert_array_equal(servable.stack_adapter(item),
                                          want_servable.stack_adapter(item))

        async def run():
            await batcher.start()
            try:
                async with TestClient(TestServer(worker.service.app)) as c:
                    batch = await (await c.post(
                        "/v1/sp/sp-batch", data=handoff.npy(stack))).json()
                    singles = [await (await c.post(
                        "/v1/sp/sp", data=handoff.npy(x))).json()
                        for x in stack]
            finally:
                await batcher.stop()
            return batch, singles

        batch, singles = asyncio.run(run())
        assert batch["count"] == 5 and batch["failed"] == 0
        for item, single in zip(batch["items"], singles):
            assert item["result"]["class_id"] == single["class_id"]
            assert abs(item["result"]["confidence"]
                       - single["confidence"]) < 1e-6

    @pytest.mark.parametrize("wire", WIRES)
    def test_crops_handoff_decodes_on_the_host_first(self, wire,
                                                     checkpoints,
                                                     monkeypatch):
        """The camera-trap composite with the detector on the wire: the
        port's worker (behind the port's control plane, in process) and
        JAX's answer alike, and the crops are cut from the host inverse of
        the wire payload, byte for byte JAX's handoff of JAX's inverse."""
        models = copy.deepcopy(handoff.SPECS["crops"])
        models[0]["wire"] = wire
        want = asyncio.run(handoff.in_process(copy.deepcopy(models),
                                              port=False))
        got = asyncio.run(handoff.in_process(models, True, checkpoints))
        decoder = {"yuv420": jax_yuv.yuv420_to_rgb_numpy,
                   "dct": jax_dct.dct_to_rgb_numpy}[wire]
        seen = [decoder(JAX_ENCODE[wire](img), 64, 64)
                for img in handoff.images()]
        port_servable = build_servable(
            "detector", **handoff.servable_kwargs(models[0]))
        for img, decoded in zip(handoff.images(), seen):
            np.testing.assert_array_equal(
                port_servable.example_decoder(ENCODE[wire](img)), decoded)
        # The species reference crops what the handoff saw: the decode.
        monkeypatch.setattr(handoff, "images", lambda: seen)
        assert handoff.assert_same_pipeline(got, want) >= 1
        for (_, stage, _), img in zip(want, seen):
            kwargs = dict(crop_size=16, max_crops=3)
            from ai4e_tpu.runtime.handoffs import crops_handoff as jax_crops

            from ai4e_tpu_torch.runtime.handoffs import crops_handoff
            assert (crops_handoff("x", **kwargs)(stage, img)
                    == jax_crops("x", **kwargs)(stage, img))
