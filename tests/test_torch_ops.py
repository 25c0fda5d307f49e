"""The port's ops (``ai4e_tpu_torch.ops``) against the JAX package's Pallas
kernels, which run here in interpret mode as ``tests/test_pallas_ops.py``
runs them. On the CPU each port wrapper takes its plain PyTorch version.
The JAX-free checks of the wrappers, and the CUDA kernels against their
plain versions on the card, are in ``test_torch_kernels.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import IMAGENET, planted_logits

from ai4e_tpu.ops.pallas import class_histogram as jax_class_histogram
from ai4e_tpu.ops.pallas import fused_seg_postprocess as jax_fused
from ai4e_tpu.ops.pallas import normalize_image as jax_normalize
from ai4e_tpu.ops.pallas import segmentation_argmax as jax_argmax
from ai4e_tpu_torch.ops import (
    class_histogram,
    fused_seg_postprocess,
    normalize_image,
    segmentation_argmax,
)

torch.set_num_threads(2)


class TestNormalizeImage:
    @pytest.mark.parametrize("shape,mean_std", [
        ((2, 256, 256, 3), (None, None)),
        ((2, 256, 256, 3), IMAGENET),
        ((3, 250, 250, 3), IMAGENET),
        ((2, 64, 48, 13), (tuple(np.linspace(0.1, 0.7, 13)),
                           tuple(np.linspace(0.15, 0.4, 13)))),
    ], ids=["default", "imagenet", "ragged", "sentinel2-13-bands"])
    def test_matches_jax(self, shape, mean_std):
        """Same affine in float32 on both sides; 1e-6 absolute allows one
        rounding of difference where XLA contracts the multiply-add."""
        images = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
        want = np.asarray(jax_normalize(jnp.asarray(images), *mean_std))
        got = normalize_image(torch.from_numpy(images), *mean_std)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


class TestSegPostprocess:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("with_classmap", [True, False])
    def test_fused_matches_jax_exactly(self, dtype, with_classmap):
        logits = planted_logits((2, 256, 256, 4), seed=1)
        want = jax_fused(jnp.asarray(logits, dtype),
                         with_classmap=with_classmap)
        got = fused_seg_postprocess(
            torch.from_numpy(logits).to(getattr(torch, dtype)),
            with_classmap=with_classmap)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["counts"].numpy(),
                                      np.asarray(want["counts"]))
        assert got["counts"].dtype == torch.int32
        if with_classmap:
            assert got["classmap"].dtype == torch.uint8
            np.testing.assert_array_equal(got["classmap"].numpy(),
                                          np.asarray(want["classmap"]))

    def test_256_classes_map_class_255(self):
        """C = 256: the uint8 map holds class 255, as JAX's does."""
        logits = np.random.default_rng(3).standard_normal(
            (2, 16, 24, 256)).astype(np.float32)
        logits[0, 0, 0, 255] = 1e3  # class 255 wins here
        got = fused_seg_postprocess(torch.from_numpy(logits))
        want = jax_fused(jnp.asarray(logits))
        assert int(got["classmap"][0, 0, 0]) == 255
        np.testing.assert_array_equal(got["classmap"].numpy(),
                                      np.asarray(want["classmap"]))
        np.testing.assert_array_equal(got["counts"].numpy(),
                                      np.asarray(want["counts"]))

    def test_argmax_and_histogram_match_jax(self):
        logits = planted_logits((2, 64, 96, 7), seed=2)
        classmap = segmentation_argmax(torch.from_numpy(logits))
        want = np.asarray(jax_argmax(jnp.asarray(logits), tile_h=32))
        np.testing.assert_array_equal(classmap.numpy(), want)
        np.testing.assert_array_equal(
            class_histogram(classmap, 7).numpy(),
            np.asarray(jax_class_histogram(jnp.asarray(want), 7)))
