"""The port's kernel wrappers (``ai4e_tpu_torch.ops``) without JAX: argument
checks, argmax semantics, the launch counters, the build's refusal to fall
back, and (marked ``cuda``) each CUDA kernel against its plain PyTorch
version on the card. This file imports no JAX, so it runs on a GPU machine
that has none:

    python -m pytest tests/test_torch_kernels.py -q

The same wrappers are held against the JAX package's Pallas kernels in
``test_torch_ops.py``."""

import numpy as np
import pytest
import torch

from ai4e_tpu_torch.ops import (
    _native,
    fused_seg_postprocess,
    image_preprocess,
    normalize_image,
    seg_postprocess,
)

torch.set_num_threads(2)

IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def planted_logits(shape, seed):
    """Random logits with ties between classes 0/1 and 2/3, NaN at class 0
    (it wins) and NaN at later classes (they never win)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    idx = rng.permutation(flat.shape[0])[:4 * 500].reshape(4, -1)
    flat[idx[0], 1] = flat[idx[0], 0]
    flat[idx[1], 3] = flat[idx[1], 2]
    flat[idx[2], 0] = np.nan
    flat[idx[3], 1 + np.arange(idx.shape[1]) % (shape[-1] - 1)] = np.nan
    return x


class TestWrappers:
    def test_rejects_float_input(self):
        with pytest.raises(ValueError, match="expected uint8"):
            normalize_image(torch.zeros((1, 8, 8, 3)))

    def test_rejects_wrong_channel_count_of_mean(self):
        with pytest.raises(ValueError, match="3 entries"):
            normalize_image(torch.zeros((1, 8, 8, 3), dtype=torch.uint8),
                            mean=(0.5, 0.5))

    def test_nan_and_tie_semantics(self):
        """First maximum wins a tie; NaN wins only at class 0 (unlike
        torch.argmax, which lets NaN win anywhere)."""
        nan = float("nan")
        logits = torch.tensor([[[[1.0, 1.0, 0.0, 0.0],
                                 [nan, 5.0, 6.0, 7.0],
                                 [0.0, nan, 2.0, 1.0],
                                 [0.0, 3.0, 3.0, nan]]]])
        out = fused_seg_postprocess(logits)
        assert out["classmap"].tolist() == [[[0, 0, 2, 1]]]
        assert out["counts"].tolist() == [[2, 1, 1, 0]]
        assert torch.argmax(logits, -1).tolist() != [[[0, 0, 2, 1]]]

    def test_counts_only_leaves_the_map_out(self):
        out = fused_seg_postprocess(torch.from_numpy(
            planted_logits((2, 16, 16, 4), 0)), with_classmap=False)
        assert set(out) == {"counts"}
        assert out["counts"].sum(dim=1).tolist() == [256, 256]

    @pytest.mark.parametrize("bad,match", [
        (torch.zeros((2, 8, 8), dtype=torch.float32), "expected"),
        (torch.zeros((1, 8, 8, 4), dtype=torch.int32), "float32 or bfloat16"),
        (torch.zeros((1, 8, 8, 256)), "class count"),
    ], ids=["rank", "dtype", "classes"])
    def test_rejects_bad_logits(self, bad, match):
        with pytest.raises(ValueError, match=match):
            fused_seg_postprocess(bad)

    def test_cpu_tensors_never_launch_a_kernel(self):
        before = (image_preprocess.launches, seg_postprocess.launches)
        fused_seg_postprocess(normalize_image(
            torch.zeros((2, 16, 16, 4), dtype=torch.uint8)))
        assert (image_preprocess.launches, seg_postprocess.launches) == before
        if not torch.cuda.is_available():
            assert before == (0, 0)


class TestNativeBuild:
    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        """No fallback: without a compiler the build raises."""
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setattr(_native, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _native.find_nvcc()

    def test_library_name_is_keyed_by_source_and_flags(self):
        paths = {_native.library_path(n) for n in _native.SOURCES}
        assert len(paths) == len(_native.SOURCES)
        assert "arch=compute_90a,code=sm_90a" in _native.NVCC_FLAGS
        for name in _native.SOURCES:
            path = _native.library_path(name)
            assert path.parent == _native.BUILD_DIR
            assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("shape,mean_std", [
        ((64, 256, 256, 3), (None, None)),
        ((3, 250, 250, 3), IMAGENET),
    ])
    def test_normalize_kernel_matches_plain(self, cuda, shape, mean_std):
        x = torch.from_numpy(np.random.default_rng(3).integers(
            0, 256, shape, np.uint8)).to(cuda)
        before = image_preprocess.launches
        got = normalize_image(x, *mean_std)
        assert image_preprocess.launches == before + 1
        scale, bias = image_preprocess.channel_affine(*mean_std, shape[-1])
        want = image_preprocess.normalize_image_plain(x, scale, bias)
        assert float((got - want).abs().max()) <= 1e-6

    @pytest.mark.parametrize("shape", [(64, 256, 256, 4), (3, 250, 250, 4)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("with_classmap", [True, False])
    def test_seg_kernel_matches_plain(self, cuda, shape, dtype, with_classmap):
        logits = torch.from_numpy(planted_logits(shape, 4)).to(dtype).to(cuda)
        before = seg_postprocess.launches
        got = fused_seg_postprocess(logits, with_classmap=with_classmap)
        assert seg_postprocess.launches == before + 1
        want = seg_postprocess.fused_seg_postprocess_plain(logits, with_classmap)
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), key

    def test_seg_kernel_any_class_count(self, cuda):
        """C != 4 takes the kernel's generic path."""
        logits = torch.from_numpy(planted_logits((2, 40, 56, 7), 5)).to(cuda)
        got = fused_seg_postprocess(logits)
        want = seg_postprocess.fused_seg_postprocess_plain(logits)
        for key in want:
            assert torch.equal(got[key], want[key]), key

    def test_unaligned_logits_are_refused(self, cuda):
        flat = torch.zeros(4 * 8 * 8 * 4 + 1, device=cuda)
        with pytest.raises(ValueError, match="aligned"):
            fused_seg_postprocess(flat[1:].view(4, 8, 8, 4))
