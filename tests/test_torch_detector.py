"""The port's camera-trap detector (``ai4e_tpu_torch.models.detector``), its
decode, its weight conversion and its servable against the JAX package's
flax ``CenterNetDetector``, ``decode_detections`` and ``build_detector``.

Weights come from flax's init and reach the port through
``detector_state_dict_from_flax``. Inputs are made with numpy from a seed:
camera-trap-like scenes (a smooth background with coloured rectangles).

On random weights the scores crowd at 0.19-0.42, so bfloat16 differences
land exactly on the 0.2 threshold, on the ``max_detections`` cut and on
near-plateaus of the heatmap, where the 3x3 peak NMS may keep a
neighbouring pixel instead. The served lists are therefore compared
detection by detection, each identified by its peak (row, column, class),
and a detection may differ only where the reference heatmap leaves it
within ``SCORE_TOL`` of one of those decisions."""

import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai4e_tpu.models.detector import CenterNetDetector as FlaxDetector
from ai4e_tpu.models.detector import decode_detections as jax_decode
from ai4e_tpu.ops.pallas import normalize_image as jax_normalize
from ai4e_tpu.runtime.families import build_detector as jax_build_detector
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.models import CenterNetDetector, decode_detections
from ai4e_tpu_torch.ops import normalize_image
from ai4e_tpu_torch.runtime.families import build_servable

torch.set_num_threads(2)

SIZE = 512
WIDTHS = (64, 128, 256)  # deploy/specs/models.json megadetector (defaults)
SMALL = (8, 8, 8)
# Heads in float32 after a bfloat16 backbone: measured 0.013-0.035 of
# logits reaching 3.3 at the deployed widths.
HEAD_ATOL = 0.05
SCORE_TOL = HEAD_ATOL / 4     # the sigmoid's slope is at most 1/4
BOX_TOL = 12 * HEAD_ATOL      # stride 8: centre offset + half the size
THRESHOLD = 0.2


def scenes(n: int, seed: int, size: int = SIZE) -> np.ndarray:
    """uint8 camera-trap-like images: a smooth background with 2-5
    coloured rectangles, so detections vary from image to image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        img = np.empty((size, size, 3), np.float32)
        for c in range(3):
            fy, fx, phase = rng.uniform(0.5, 2), rng.uniform(0.5, 2), \
                rng.uniform(0, 6)
            img[..., c] = 80 + 60 * np.sin(2 * np.pi * (fy * yy + fx * xx)
                                           + phase)
        for _ in range(rng.integers(2, 6)):
            h, w = rng.integers(size // 16, size // 3, 2)
            y, x = rng.integers(0, size - h), rng.integers(0, size - w)
            img[y:y + h, x:x + w] = rng.integers(0, 256, 3)
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


@functools.lru_cache(maxsize=None)
def _flax_params(widths, size):
    model = FlaxDetector(widths=widths)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, size, size, 3), jnp.float32))
    return jax.tree.map(np.asarray, params)


def port_detector(params, widths, dtype=torch.bfloat16):
    model = CenterNetDetector(widths=widths, dtype=dtype)
    model.load_state_dict(convert.detector_state_dict_from_flax(params))
    return model.to(memory_format=torch.channels_last).eval()


def heads_both(widths, images, dtype=torch.bfloat16):
    """Each framework's head outputs (NHWC float32 numpy) for uint8
    ``images``, its own normalize first."""
    params = _flax_params(widths, images.shape[1])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = FlaxDetector(widths=widths, dtype=jdt).apply(
        params, jax_normalize(jnp.asarray(images)))
    with torch.inference_mode():
        got = port_detector(params, widths, dtype)(
            normalize_image(torch.from_numpy(images)))
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x.astype(np.float64)))


class TestHeads:
    def test_deployed_widths_at_512(self):
        got, want = heads_both(WIDTHS, scenes(1, seed=0))
        assert set(got) == set(want) == {"heatmap", "wh", "offset"}
        for key in want:
            assert got[key].shape == want[key].shape
            assert got[key].dtype == np.float32
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=HEAD_ATOL, err_msg=key)

    def test_float32_model_is_exact_to_summation_order(self):
        got, want = heads_both(SMALL, scenes(2, seed=1, size=64),
                               torch.float32)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-4, err_msg=key)

    def test_heatmap_bias_starts_at_minus_2_19(self):
        from ai4e_tpu_torch.models import create_detector

        model = create_detector(widths=SMALL, device="cpu")
        assert torch.all(model.heatmap.bias == -2.19)
        assert not model.wh.bias.any() and not model.offset.bias.any()


def planted_heads(b: int, h: int, w: int, c: int, seed: int) -> dict:
    """Random head outputs with planted NMS traps: a 2x2 plateau of equal
    logits (four kept peaks of one score), two separate equal peaks (a tie
    in the top-k order) and a near-plateau 1e-7 apart; no NaN."""
    rng = np.random.default_rng(seed)
    heat = rng.normal(-1.0, 1.0, (b, h, w, c)).astype(np.float32)
    heat[:, 2:4, 2:4, 1] = 4.0                 # plateau
    heat[:, 1, w - 2, 0] = heat[:, h - 2, 1, 2] = 3.5   # equal peaks
    heat[:, h // 2, w // 2, 0] = 3.0
    heat[:, h // 2, w // 2 + 1, 0] = np.float32(3.0) + np.float32(2.4e-7)
    return {"heatmap": heat,
            "wh": rng.normal(0, 2, (b, h, w, 2)).astype(np.float32),
            "offset": rng.uniform(0, 1, (b, h, w, 2)).astype(np.float32)}


class TestDecode:
    @pytest.mark.parametrize("shape", [(2, 8, 8, 3), (2, 64, 64, 3)],
                             ids=["few-peaks", "many-peaks"])
    def test_same_heads_same_detections(self, shape):
        """Fed the same float head outputs, the port's decode gives JAX's
        boxes, scores and classes on every row with a finite score, planted
        plateaus and ties included; the -inf fill rows (fewer peaks than
        rows) score 0 on both sides."""
        heads = planted_heads(*shape, seed=sum(shape))
        want = {k: np.asarray(v) for k, v in jax_decode(
            {k: jnp.asarray(v) for k, v in heads.items()}).items()}
        got = {k: v.numpy() for k, v in decode_detections(
            {k: torch.from_numpy(v) for k, v in heads.items()}).items()}
        assert got["boxes"].shape == want["boxes"].shape == (shape[0], 64, 4)
        assert got["classes"].dtype == np.int32
        finite = want["scores"] > 0
        np.testing.assert_array_equal(got["scores"] > 0, finite)
        for key in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(got[key][finite], want[key][finite],
                                          err_msg=key)
        np.testing.assert_array_equal(got["scores"][~finite], 0.0)
        if shape[1] == 8:
            assert (~finite).any(), "the few-peaks case must leave fill rows"
        # The planted plateau: its four pixels all survive NMS, in the
        # reference's (score, flat index) order.
        top = got["scores"][0, :4]
        assert (top == top[0]).all()

    def test_nms_keeps_only_local_maxima(self):
        heads = planted_heads(1, 16, 16, 3, seed=5)
        got = decode_detections({k: torch.from_numpy(v)
                                 for k, v in heads.items()})
        heat = sigmoid(heads["heatmap"][0])
        padded = np.pad(heat, ((1, 1), (1, 1), (0, 0)),
                        constant_values=-np.inf)
        for score, cls, box in zip(got["scores"][0].numpy(),
                                   got["classes"][0].numpy(),
                                   got["boxes"][0].numpy()):
            if score <= 0:
                continue
            hits = np.argwhere(np.isclose(heat[..., cls], score, atol=0,
                                          rtol=1e-6))
            assert any(padded[y:y + 3, x:x + 3, cls].max() - score < 1e-6
                       for y, x in hits)
            assert box[2] >= box[0] and box[3] >= box[1]


def peak_pixels(decode, heatmap: np.ndarray) -> np.ndarray:
    """(B, K, 3) (row, column, class) of each decoded row: the decode run
    with zero ``wh`` and ``offset``, whose boxes are then the peaks'
    corners at stride 8."""
    zeros = np.zeros(heatmap.shape[:3] + (2,), np.float32)
    out = decode({"heatmap": heatmap, "wh": zeros, "offset": zeros})
    boxes = np.asarray(out["boxes"])
    return np.stack([boxes[..., 0] / 8, boxes[..., 1] / 8,
                     np.asarray(out["classes"])], axis=-1).round().astype(int)


def ambiguous(heat: np.ndarray, pixel, cut: float) -> bool:
    """Whether the reference's decisions on this (row, col, class) are
    within ``SCORE_TOL``: its score against the threshold or the top-k cut,
    or against a 3x3 neighbour's (the NMS)."""
    y, x, c = pixel
    s = heat[y, x, c]
    if abs(s - THRESHOLD) <= SCORE_TOL or abs(s - cut) <= SCORE_TOL:
        return True
    window = heat[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2, c]
    others = np.sort(np.abs(window - s).ravel())[1:]  # [0] is the pixel
    return bool((others <= SCORE_TOL).any())


def jnp_decode(heads):
    return jax_decode({k: jnp.asarray(v) for k, v in heads.items()})


def torch_decode(heads):
    return {k: v.numpy() for k, v in decode_detections(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in heads.items()}).items()}


class TestServable:
    def test_detections_match_jax_servable(self):
        """``build_servable("detector")`` at the deployed widths on the JAX
        servable's weights, uint8 scenes in: every detection of either
        list whose reference decisions are clear of ``SCORE_TOL`` is in
        the other list at the same peak, with the score within
        ``SCORE_TOL`` and the box within ``BOX_TOL`` pixels."""
        jax_servable = jax_build_detector(buckets=(1, 2))
        port = build_servable("detector", buckets=(1, 2))
        assert port.input_dtype == np.uint8
        assert port.input_shape == jax_servable.input_shape == (SIZE, SIZE, 3)
        port.module.load_state_dict(convert.detector_state_dict_from_flax(
            jax.tree.map(np.asarray, jax_servable.params)))
        images = scenes(2, seed=2)
        want_out = jax_servable.apply_fn(jax_servable.params,
                                         jnp.asarray(images))
        with torch.inference_mode():
            got_out = port.apply_fn(port.module, torch.from_numpy(images))
            got_heads = port.module(normalize_image(torch.from_numpy(images)))
        want_heads = FlaxDetector().apply(jax_servable.params,
                                          jax_normalize(jnp.asarray(images)))
        want_pix = peak_pixels(jnp_decode, np.asarray(want_heads["heatmap"]))
        got_pix = peak_pixels(torch_decode,
                              got_heads["heatmap"].numpy())
        checked = 0
        for i in range(len(images)):
            want = json.loads(json.dumps(jax_servable.postprocess(
                {k: np.asarray(v)[i] for k, v in want_out.items()})))
            got = json.loads(json.dumps(port.postprocess(
                {k: v.numpy()[i] for k, v in got_out.items()})))
            assert set(got) == set(want) == {"detections"}
            assert 5 <= len(want["detections"]) <= 64
            heat = sigmoid(np.asarray(want_heads["heatmap"])[i])
            cut = float(np.asarray(want_out["scores"])[i, -1])
            for mine, theirs, pix_mine, pix_theirs in (
                    (want, got, want_pix[i], got_pix[i]),
                    (got, want, got_pix[i], want_pix[i])):
                index = {tuple(p): k for k, p in enumerate(pix_theirs)
                         if k < len(theirs["detections"])}
                for k, det in enumerate(mine["detections"]):
                    pixel = tuple(pix_mine[k])
                    if ambiguous(heat, pixel, cut):
                        continue
                    assert det["class_id"] == pixel[2]
                    assert pixel in index, (i, det, pixel)
                    other = theirs["detections"][index[pixel]]
                    assert abs(other["score"] - det["score"]) <= SCORE_TOL
                    np.testing.assert_allclose(other["box"], det["box"],
                                               rtol=0, atol=BOX_TOL)
                    checked += 1
        assert checked >= 20

    def test_postprocess_keeps_scores_at_or_above_the_threshold(self):
        port = build_servable("detector", image_size=64, widths=SMALL,
                              buckets=(1,))
        out = {"boxes": np.arange(12, dtype=np.float32).reshape(3, 4),
               "scores": np.array([0.5, 0.2, 0.19999], np.float32),
               "classes": np.array([2, 0, 1], np.int32)}
        got = port.postprocess(out)
        assert [d["class_id"] for d in got["detections"]] == [2, 0]
        assert got["detections"][0]["box"] == [0.0, 1.0, 2.0, 3.0]

    def test_round_trip_through_npz(self, tmp_path):
        params = _flax_params(SMALL, 64)
        path = tmp_path / "megadetector.npz"
        convert.save_npz(params, str(path))
        back = convert.load_npz(str(path))
        model = CenterNetDetector(widths=SMALL, dtype=torch.float32)
        model.load_state_dict(convert.detector_state_dict_from_flax(back))
        again = convert.detector_flax_from_state_dict(model.state_dict())
        assert jax.tree.structure(again) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)

    def test_bad_tree_raises(self):
        params = jax.tree.map(np.array, _flax_params(SMALL, 64))
        del params["params"]["Conv_3"]
        with pytest.raises(ValueError, match="Conv_3"):
            convert.detector_state_dict_from_flax(params)

    def test_preprocess_takes_images_and_npy(self):
        from PIL import Image

        port = build_servable("detector", image_size=64, widths=SMALL,
                              buckets=(1,))
        img = scenes(1, seed=3, size=96)[0]
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "PNG")
        x = port.preprocess(buf.getvalue(), "image/png")
        assert x.shape == (64, 64, 3) and x.dtype == np.uint8
        npy = io.BytesIO()
        np.save(npy, img[:64, :64])
        assert np.array_equal(port.preprocess(npy.getvalue(), ""),
                              img[:64, :64])

    @pytest.mark.parametrize("wire", ["yuv420", "dct"])
    def test_compressed_wires_name_their_item(self, wire):
        """The compressed wires (ROADMAP A9) serve: the wire's bytes are
        the input, and a size the wire cannot encode is refused at build
        time, naming the wire."""
        from ai4e_tpu_torch.ops.dct import dct_nbytes
        from ai4e_tpu_torch.ops.yuv import yuv420_nbytes

        servable = build_servable("detector", image_size=64, widths=SMALL,
                                  wire=wire)
        nbytes = yuv420_nbytes if wire == "yuv420" else dct_nbytes
        assert servable.input_shape == (nbytes(64, 64),)
        with pytest.raises(ValueError, match=f"wire='{wire}' needs"):
            build_servable("detector", image_size=63 if wire == "yuv420"
                           else 72, widths=SMALL, wire=wire)
