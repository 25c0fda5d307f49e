"""The port's kernel wrappers (``ai4e_tpu_torch.ops``) without JAX: argument
checks, argmax semantics, the launch counters, the build's refusal to fall
back, and (marked ``cuda``) each CUDA kernel against its plain PyTorch
version on the card. This file imports no JAX, so it runs on a GPU machine
that has none:

    python -m pytest tests/test_torch_kernels.py -q

The same wrappers are held against the JAX package's Pallas kernels in
``test_torch_ops.py``."""

import ctypes

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
from ai4e_tpu_torch.ops import flash_attention as flash_module
from ai4e_tpu_torch.ops.flash_attention import flash_attention

torch.set_num_threads(2)

IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the test, the
    setting before it restored after."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before[0], warn_only=before[1])


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
        (torch.zeros((1, 8, 8, 257)), "class count"),
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


    def test_wide_affine_is_copied_to_the_device_once(self):
        """Past 8 channels the kernel reads its scales and biases from a
        device array: one per (device, values), kept for later calls."""
        scale, bias = image_preprocess.channel_affine(
            tuple(np.linspace(0.1, 0.7, 13)), tuple(np.linspace(0.15, 0.4, 13)),
            13)
        first = image_preprocess._device_affine(scale, bias,
                                                torch.device("cpu"))
        assert first.dtype == torch.float32 and first.shape == (26,)
        assert torch.equal(first, torch.from_numpy(np.r_[scale, bias]))
        assert image_preprocess._device_affine(
            scale, bias, torch.device("cpu")) is first
        assert image_preprocess._device_affine(
            scale * 2, bias, torch.device("cpu")) is not first


class TestNormalizeLaunchPlan:
    """``launch_plan`` against the kernel's index arithmetic, written out
    here: thread g of ``grid * THREADS`` takes words g, g + stride, ...
    (word w is elements 4w .. 4w + 3) and threads g < n_tail the elements
    past the last whole word."""

    @pytest.mark.parametrize("n,c,resident", [
        (64 * 256 * 256 * 3, 3, 1056),  # bucket 64: a persistent grid
        (256 * 256 * 3, 3, 1056),       # bucket 1: one word a thread
        (7 * 5 * 3, 3, 1056),           # ragged, under one CTA's words
        (2 * 45 * 29 * 8 + 3, 8, 40),   # n % 4 == 3, a small cap
        (3 * 61 * 67 * 4, 4, 7),
        (100 * 103 * 5, 5, 13),
        (1, 1, 1056), (3, 1, 1056), (5, 7, 1),
    ])
    def test_every_element_once_in_its_channel_phase(self, n, c, resident):
        grid, n_words, n_tail = image_preprocess.launch_plan(n, c, resident)
        threads = grid * image_preprocess.THREADS
        assert grid % c == 0 and grid >= 1
        assert grid <= max(resident, 1) + c - 1
        assert 4 * n_words + n_tail == n and 0 <= n_tail < 4
        seen = np.zeros(n, np.uint8)
        g = np.arange(threads)
        for w0 in range(0, n_words, threads):  # the kernel's stride loop
            w = w0 + g[w0 + g < n_words]
            for k in range(4):
                seen[4 * w + k] += 1
            # A thread's channel phase is the one of its first word.
            assert np.array_equal((4 * w) % c, (4 * (w - w0)) % c)
        seen[4 * n_words + g[g < n_tail]] += 1
        assert np.all(seen == 1)


def random_qkv(b, h, s_q, s_k, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (b, h, s, d)).astype(np.float32)) for s in (s_q, s_k, s_k))


class TestFlashWrapper:
    def test_cpu_tensors_never_launch_a_kernel(self):
        before = flash_module.launches
        out, lse = flash_attention(*random_qkv(1, 2, 40, 40, 16, 0),
                                   causal=True, return_lse=True)
        assert out.shape == (1, 2, 40, 16) and lse.shape == (1, 2, 40)
        assert flash_module.launches == before
        if not torch.cuda.is_available():
            assert before == 0

    @pytest.mark.parametrize("d", [257, 264, 512])
    def test_rejects_unsupported_head_dim(self, d):
        """Every D from 1 to 256 is taken (tests/test_torch_flash.py holds
        them against JAX's); past 256 the kernels refuse, naming the
        limit."""
        with pytest.raises(ValueError, match="head dim .* 1 to 256"):
            flash_attention(*random_qkv(1, 1, 8, 8, d, 0))

    @pytest.mark.parametrize("d,tile", [(1, 16), (8, 16), (16, 16),
                                        (17, 32), (48, 64), (80, 128),
                                        (96, 128), (129, 256), (256, 256)])
    def test_instantiation_is_the_narrowest_that_holds_d(self, d, tile):
        assert flash_module.instantiation(d) == tile

    @pytest.mark.parametrize("dtype,d,padded", [
        (torch.bfloat16, 8, 8), (torch.bfloat16, 13, 16),
        (torch.bfloat16, 250, 256), (torch.float32, 4, 4),
        (torch.float32, 5, 8), (torch.float32, 97, 100)])
    def test_rows_are_padded_to_whole_16_byte_chunks(self, dtype, d, padded):
        """A D that is not a whole number of 16-byte chunks is copied to a
        zero-padded tensor for the kernels; the values are kept."""
        q, k, v = (t.to(dtype) for t in random_qkv(1, 2, 5, 5, d, d))
        (pq, pk, pv), copied = flash_module._pad_d((q, k, v), d)
        assert copied == (padded != d)
        for src, got in zip((q, k, v), (pq, pk, pv)):
            assert got.shape[-1] == padded and got.dtype == dtype
            assert torch.equal(got[..., :d], src)
            assert not got[..., d:].any()

    def test_rejects_non_unit_d_stride(self):
        q, k, v = random_qkv(1, 1, 16, 16, 32, 0)
        q = q.transpose(2, 3).contiguous().transpose(2, 3)  # same values
        with pytest.raises(ValueError, match="unit stride"):
            flash_attention(q, k, v)

    @pytest.mark.parametrize("edit,match", [
        (lambda q, k, v: (q, k, v[:, :, :-1]), "shapes"),
        (lambda q, k, v: (q, k.double(), v), "dtype"),
        (lambda q, k, v: (q.half(), k.half(), v.half()), "dtype"),
        (lambda q, k, v: (q[0], k[0], v[0]), "expected"),
    ], ids=["kv-length", "mixed-dtype", "float16", "rank"])
    def test_rejects_bad_operands(self, edit, match):
        with pytest.raises(ValueError, match=match):
            flash_attention(*edit(*random_qkv(1, 2, 16, 16, 16, 0)))


    def test_tolerance_is_one_bfloat16_ulp_above_1e_2(self):
        want = torch.tensor([0.0, 0.5, 1.5, -2.0, 3.9, 100.0])
        assert torch.equal(flash_module.tolerance(want),
                           torch.full((6,), 2e-5))
        got = flash_module.tolerance(want.to(torch.bfloat16))
        assert got.tolist() == pytest.approx(
            [1e-2, 1e-2, 1e-2, 2 ** -6, 2 ** -6, 0.5])


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

    @pytest.mark.parametrize("edit", ["changed", "added"])
    def test_library_name_is_keyed_by_headers(self, monkeypatch, tmp_path,
                                              edit):
        """A source that includes a shared header is rebuilt when a header
        in csrc/ changes or appears, though the source itself did not."""
        (tmp_path / "kernel.cu").write_text('#include "shared.cuh"\n')
        header = tmp_path / "shared.cuh"
        header.write_text("// one\n")
        monkeypatch.setattr(_native, "CSRC_DIR", tmp_path)
        before = _native.library_path("kernel")
        if edit == "changed":
            header.write_text("// two\n")
        else:
            (tmp_path / "other.cuh").write_text("// new\n")
        after = _native.library_path("kernel")
        assert after != before and after.parent == before.parent
        assert after.name.startswith("libkernel-")
        assert _native.library_path("kernel") == after


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("shape,mean_std", [
        ((64, 256, 256, 3), (None, None)),
        ((16, 256, 256, 3), (None, None)),
        ((1, 256, 256, 3), (None, None)),
        ((64, 256, 256, 3), IMAGENET),
        ((3, 250, 250, 3), IMAGENET),
        ((1, 7, 5, 3), IMAGENET),  # n % 16 != 0, under one CTA's words
        ((2, 33, 17, 1), ((0.5,), (0.25,))),
        ((3, 61, 67, 4), ((0.1, 0.2, 0.3, 0.4), (0.2, 0.3, 0.4, 0.5))),
        ((2, 45, 29, 8), (tuple(np.linspace(0.1, 0.8, 8)),
                          tuple(np.linspace(0.2, 0.9, 8)))),
        ((1, 1, 1, 1), (None, None)),
    ])
    def test_normalize_kernel_matches_plain(self, cuda, shape, mean_std):
        """Bit for bit: the kernel rounds the multiply and the add
        separately, as the plain version does."""
        x = torch.from_numpy(np.random.default_rng(3).integers(
            0, 256, shape, np.uint8)).to(cuda)
        before = image_preprocess.launches
        got = normalize_image(x, *mean_std)
        assert image_preprocess.launches == before + 1
        scale, bias = image_preprocess.channel_affine(*mean_std, shape[-1])
        want = image_preprocess.normalize_image_plain(x, scale, bias)
        assert torch.equal(got, want)

    @pytest.mark.parametrize("c", [1, 3, 4, 8])
    def test_normalize_misaligned_view(self, cuda, c):
        """A view one byte into its storage: the wrapper copies it to an
        aligned tensor first."""
        shape = (2, 31, 29, c)
        flat = torch.from_numpy(np.random.default_rng(c).integers(
            0, 256, int(np.prod(shape)) + 1, np.uint8)).to(cuda)
        x = flat[1:].view(shape)
        assert x.data_ptr() % 16
        got = normalize_image(x, *IMAGENET) if c == 3 else normalize_image(x)
        mean_std = IMAGENET if c == 3 else (None, None)
        scale, bias = image_preprocess.channel_affine(*mean_std, c)
        assert torch.equal(
            got, image_preprocess.normalize_image_plain(x, scale, bias))

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

    @pytest.mark.parametrize("shape", [(65_600, 4, 4, 4), (2, 40, 56, 256)],
                             ids=["batch-past-grid-y", "256-classes"])
    def test_seg_kernel_past_the_old_limits(self, cuda, shape):
        logits = torch.from_numpy(planted_logits(shape, 6)).to(cuda)
        got = fused_seg_postprocess(logits)
        want = seg_postprocess.fused_seg_postprocess_plain(logits)
        for key in want:
            assert torch.equal(got[key], want[key]), key

    @pytest.mark.parametrize("c", [9, 13, 64])
    def test_normalize_wide_channels(self, cuda, c):
        """Past kMaxChannels the scales and biases are staged in shared
        memory: still bit for bit."""
        shape = (3, 37, 29, c)
        x = torch.from_numpy(np.random.default_rng(c).integers(
            0, 256, shape, np.uint8)).to(cuda)
        mean_std = (tuple(np.linspace(0.1, 0.7, c)),
                    tuple(np.linspace(0.15, 0.4, c)))
        before = image_preprocess.launches
        got = normalize_image(x, *mean_std)
        assert image_preprocess.launches == before + 1
        scale, bias = image_preprocess.channel_affine(*mean_std, c)
        assert torch.equal(
            got, image_preprocess.normalize_image_plain(x, scale, bias))

    def test_unaligned_logits_are_refused(self, cuda):
        flat = torch.zeros(4 * 8 * 8 * 4 + 1, device=cuda)
        with pytest.raises(ValueError, match="aligned"):
            fused_seg_postprocess(flat[1:].view(4, 8, 8, 4))


@pytest.mark.cuda
class TestFlashKernelOnCard:
    @staticmethod
    def check(q, k, v, causal):
        before = flash_module.launches
        got, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        assert flash_module.launches == before + 1
        want, want_lse = flash_module.flash_attention_plain(
            q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        assert got.dtype == q.dtype and got.shape == want.shape
        # The output lies in (B, S, H, D) memory order.
        assert got.transpose(1, 2).is_contiguous()
        err = (got.float() - want.float()).abs()  # see flash_module.tolerance
        assert bool((err <= flash_module.tolerance(want)).all()), \
            float(err.max())
        assert float((lse - want_lse).abs().max()) <= flash_module.LSE_ATOL

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
    @pytest.mark.parametrize("d", [8, 16, 32, 48, 64, 80, 96, 128, 136, 256])
    def test_ragged_matches_plain(self, cuda, dtype, causal, d):
        q, k, v = (t.to(dtype).to(cuda) for t in random_qkv(2, 3, 1000, 1000, d, d))
        self.check(q, k, v, causal)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d", [1, 5, 13, 250])
    def test_padded_head_dims(self, cuda, dtype, d):
        """A D of part of a 16-byte chunk runs on a zero-padded copy and
        is sliced back."""
        q, k, v = (t.to(dtype).to(cuda) for t in random_qkv(2, 2, 130, 130, d, d))
        before = flash_module.padded_copies
        got, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        assert flash_module.padded_copies == before + 1
        want, want_lse = flash_module.flash_attention_plain(
            q, k, v, causal=True, return_lse=True)
        torch.cuda.synchronize()
        assert got.shape == want.shape
        assert bool(((got.float() - want.float()).abs()
                     <= flash_module.tolerance(want)).all())
        assert float((lse - want_lse).abs().max()) <= flash_module.LSE_ATOL

    def test_batch_heads_past_the_grid_y_limit(self, cuda):
        """B*H = 65,600: the kernels take B*H in their one grid
        dimension."""
        q, k, v = (t.to(torch.bfloat16).to(cuda)
                   for t in random_qkv(1640, 40, 24, 24, 32, 4))
        self.check(q, k, v, causal=True)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_cross_attention(self, cuda, dtype):
        q, k, v = (t.to(dtype).to(cuda) for t in random_qkv(2, 2, 192, 320, 64, 1))
        self.check(q, k, v, causal=False)

    def test_strided_qkv_view_needs_no_copy(self, cuda):
        """q/k/v as the seqformer hands them over: (B, H, S, D) views of a
        fused (B, S, 3, H, D) projection."""
        b, s, h, d = 2, 333, 2, 128
        qkv = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (b, s, 3 * h * d)).astype(np.float32)).to(torch.bfloat16).to(cuda)
        parts = qkv.view(b, s, 3, h, d)
        q, k, v = (parts[:, :, i].transpose(1, 2) for i in range(3))
        assert not q.is_contiguous()
        self.check(q, k, v, causal=False)

    def test_unaligned_rows_are_refused(self, cuda):
        q, k, v = (t.to(cuda) for t in random_qkv(1, 1, 8, 8, 16, 3))
        flat = torch.zeros(8 * 16 + 1, device=cuda)
        with pytest.raises(ValueError, match="aligned"):
            flash_attention(flat[1:].view(1, 1, 8, 16), k, v)

    # The bf16 kernel's edges: a CTA owns 128 query rows (64 for each of two
    # consumer warpgroups), keys come in TMA tiles of 128 that are
    # zero-filled past S_k, and D = 16 and 32 swizzle at 32 and 64 bytes.

    @pytest.mark.parametrize("s_q", [50, 127, 129, 255, 257])
    @pytest.mark.parametrize("d", [64, 128])
    def test_query_rows_around_the_cta_tile(self, cuda, s_q, d):
        """S_q below one CTA tile, or one row off a multiple of it: the
        last tile's second warpgroup (or both) holds no real row."""
        q, k, v = (t.to(torch.bfloat16).to(cuda)
                   for t in random_qkv(2, 3, s_q, 300, d, s_q))
        self.check(q, k, v, causal=False)

    @pytest.mark.parametrize("s_k", [1, 200, 383])
    def test_keys_off_the_key_tile(self, cuda, s_k):
        """One key, and S_k that is not a multiple of the 128-key tile."""
        q, k, v = (t.to(torch.bfloat16).to(cuda)
                   for t in random_qkv(2, 2, 130, s_k, 128, s_k))
        self.check(q, k, v, causal=False)

    @pytest.mark.parametrize("d", [64, 128])
    def test_causal_one_row_past_two_tiles(self, cuda, d):
        q, k, v = (t.to(torch.bfloat16).to(cuda)
                   for t in random_qkv(2, 2, 257, 257, d, 7))
        self.check(q, k, v, causal=True)

    @pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
    @pytest.mark.parametrize("d", [16, 32])
    def test_narrow_heads(self, cuda, d, causal):
        q, k, v = (t.to(torch.bfloat16).to(cuda)
                   for t in random_qkv(1, 2, 300, 300, d, d + 2))
        self.check(q, k, v, causal)

    def test_strided_qkv_view_at_the_served_length(self, cuda):
        """The fused (B, S, 3, H, D) projection at S = 4096, D = 128: the
        tensor maps take H before S in stride order."""
        b, s, h, d = 2, 4096, 2, 128
        qkv = torch.from_numpy(np.random.default_rng(8).standard_normal(
            (b, s, 3 * h * d)).astype(np.float32)).to(torch.bfloat16).to(cuda)
        parts = qkv.view(b, s, 3, h, d)
        q, k, v = (parts[:, :, i].transpose(1, 2) for i in range(3))
        assert q.stride(1) < q.stride(2)
        self.check(q, k, v, causal=False)

    def test_lse_at_the_training_shape(self, cuda):
        """The forward with lse as a training step runs it, (8, 2, 4096,
        128) bf16: output and lse within their tolerances."""
        q, k, v = (t.to(torch.bfloat16).to(cuda)
                   for t in random_qkv(8, 2, 4096, 4096, 128, 9))
        self.check(q, k, v, causal=False)

    @pytest.mark.parametrize("b", [1, 16, 64])
    def test_moe_served_shapes(self, cuda, b):
        """The deployed moe model's attention, one head of 128 at S = 1024,
        at its buckets 1, 16 and 64 (16 is also its training batch)."""
        q, k, v = (t.to(torch.bfloat16).to(cuda)
                   for t in random_qkv(b, 1, 1024, 1024, 128, 10 + b))
        self.check(q, k, v, causal=False)


class TestFlashBackwardWrapper:
    def test_cpu_tensors_never_launch_a_kernel(self):
        before = flash_module.bwd_launches
        q, k, v = (t.requires_grad_(True) for t in random_qkv(1, 2, 40, 40, 16, 0))
        out = flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(out.sum(), (q, k, v))
        assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
        assert flash_module.bwd_launches == before
        if not torch.cuda.is_available():
            assert before == 0

    @pytest.mark.parametrize("edit,match", [
        (lambda t: dict(t, lse=t["lse"].transpose(1, 2).contiguous()
                        .transpose(1, 2)), "lse must be a contiguous"),
        (lambda t: dict(t, out=t["out"].double()), "out must be"),
        (lambda t: dict(t, do=t["do"].transpose(2, 3).contiguous()
                        .transpose(2, 3)), "do must be"),
        (lambda t: dict(t, do=t["flat"][1:].view(1, 2, 8, 16)), "aligned"),
    ], ids=["lse-strided", "out-dtype", "do-d-stride", "do-unaligned"])
    def test_kernel_wrapper_refuses_before_launching(self, edit, match):
        """``flash_bwd_cuda`` checks every operand before it allocates or
        launches anything, so a bad one raises here without a card."""
        q, k, v = random_qkv(1, 2, 8, 8, 16, 0)
        out, lse = flash_attention(q, k, v, return_lse=True)
        t = edit({"out": out, "lse": lse, "do": out.clone(),
                  "flat": torch.zeros(2 * 8 * 16 + 1)})
        before = flash_module.bwd_launches
        with pytest.raises(ValueError, match=match):
            flash_module.flash_bwd_cuda(q, k, v, t["out"], t["lse"], t["do"])
        assert flash_module.bwd_launches == before

    def test_one_backward_entry(self):
        """One C entry returns dq, dk and dv: ten pointers (q, k, v, out,
        do, lse, the scratch, dq, dk, dv), five ints, 24 strides."""
        types = flash_module._ARGTYPES["bwd"]
        assert set(flash_module._ARGTYPES) == {"fwd", "bwd"}
        assert types[:10] == [ctypes.c_void_p] * 10
        assert types[10:15] == [ctypes.c_int] * 5

    def test_ordered_dq_follows_the_flag(self):
        """Only the bf16 kernel orders its dQ adds, and only under PyTorch's
        deterministic flag: the float32 kernels are deterministic as they
        are."""
        assert flash_module.ordered_dq(torch.bfloat16, True)
        assert not flash_module.ordered_dq(torch.bfloat16, False)
        assert not flash_module.ordered_dq(torch.float32, True)
        assert not flash_module.ordered_dq(torch.float32, False)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
    def test_cpu_backward_under_the_deterministic_flag(self, deterministic,
                                                       dtype, causal):
        """With the flag set, a CPU tensor still takes the plain backward,
        launches nothing, and gives the unflagged result bit for bit."""
        q, k, v, do = (t.to(dtype) for t in random_qkv(1, 2, 70, 70, 32, 3)
                       + random_qkv(1, 2, 70, 70, 32, 4)[:1])
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        before = flash_module.bwd_launches
        flagged = flash_module.flash_attention_bwd(q, k, v, out, lse, do,
                                                   causal)
        torch.use_deterministic_algorithms(False)
        unflagged = flash_module.flash_attention_bwd(q, k, v, out, lse, do,
                                                     causal)
        assert flash_module.bwd_launches == before
        for a, b in zip(flagged, unflagged):
            assert torch.equal(a, b)

    def test_grad_tolerance(self):
        want = torch.tensor([0.0, 0.5, -3.0, 100.0])
        assert torch.allclose(flash_module.grad_tolerance(want),
                              torch.full((4,), 1e-3))
        got = flash_module.grad_tolerance(want.to(torch.bfloat16))
        top = 100 * 2 ** -8  # GRAD_BFLOAT16_RTOL of the largest magnitude
        assert got.tolist() == pytest.approx(  # plus two bf16 ulps
            [top + 2 ** -7, top + 2 ** -7, top + 2 ** -5, top + 1.0])


@pytest.mark.cuda
class TestFlashBackwardOnCard:
    @staticmethod
    def check(q, k, v, do, causal):
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        before = flash_module.bwd_launches
        got = flash_module.flash_attention_bwd(q, k, v, out, lse, do, causal)
        assert flash_module.bwd_launches == before + 1
        want = flash_module.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                      causal)
        torch.cuda.synchronize()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert g.transpose(1, 2).is_contiguous(), name  # (B, S, H, D)
            err = (g.float() - w.float()).abs()
            assert bool((err <= flash_module.grad_tolerance(w)).all()), \
                (name, float(err.max()))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
    @pytest.mark.parametrize("d", [8, 16, 32, 48, 64, 80, 96, 128, 136, 256])
    def test_ragged_matches_plain(self, cuda, dtype, causal, d):
        q, k, v, do = (t.to(dtype).to(cuda) for t in
                       random_qkv(2, 3, 1000, 1000, d, d) + random_qkv(
                           2, 3, 1000, 1000, d, d + 1)[:1])
        self.check(q, k, v, do, causal)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_cross_attention(self, cuda, dtype):
        q, k, v = (t.to(dtype).to(cuda) for t in random_qkv(2, 2, 192, 320, 64, 1))
        do = random_qkv(2, 2, 192, 320, 64, 2)[0].to(dtype).to(cuda)
        self.check(q, k, v, do, causal=False)

    def test_strided_qkv_and_do_need_no_copy(self, cuda, monkeypatch):
        """Through autograd as the seqformer runs it: q/k/v are views of a
        fused (B, S, 3, H, D) projection and the upstream gradient of the
        (B, S, H, D)-ordered output arrives as a strided (B, H, S, D) view;
        both kernels read them as they lie, and the gradients match the
        plain version's."""
        b, s, h, d = 2, 333, 2, 128
        rng = np.random.default_rng(2)
        qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(
            np.float32)).to(torch.bfloat16).to(cuda).requires_grad_(True)
        parts = qkv.view(b, s, 3, h, d)
        q, k, v = (parts[:, :, i].transpose(1, 2) for i in range(3))
        up = torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(
            np.float32)).to(torch.bfloat16).to(cuda)
        seen = []
        real = flash_module.flash_bwd_cuda
        monkeypatch.setattr(flash_module, "flash_bwd_cuda", lambda *a: (
            seen.append([t.data_ptr() for t in a[:3] + a[5:6]]), real(*a))[1])
        out = flash_attention(q, k, v)
        (grad,) = torch.autograd.grad(out.transpose(1, 2).reshape(b, s, h * d),
                                      qkv, up)
        do = up.view(b, s, h, d).transpose(1, 2)
        assert not do.is_contiguous()
        assert seen == [[q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         do.data_ptr()]]
        out2, lse = flash_attention(q.detach(), k.detach(), v.detach(),
                                    return_lse=True)
        want = flash_module.flash_attention_bwd_plain(
            q.detach(), k.detach(), v.detach(), out2, lse, do)
        got = grad.view(b, s, 3, h, d)
        for i, w in enumerate(want):
            err = (got[:, :, i].transpose(1, 2).float() - w.float()).abs()
            assert bool((err <= flash_module.grad_tolerance(w)).all()), i

    def test_padded_head_dim_and_batch_heads_past_the_grid(self, cuda):
        """D = 13 in bf16 (a padded copy) and B*H = 65,600."""
        for shape in ((2, 2, 130, 13), (1640, 40, 24, 32)):
            q, k, v, do = (t.to(torch.bfloat16).to(cuda) for t in
                           random_qkv(*shape[:3], shape[2], shape[3], 5)
                           + random_qkv(*shape[:3], shape[2], shape[3], 6)[:1])
            out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
            got = flash_module.flash_attention_bwd(q, k, v, out, lse, do, True)
            want = flash_module.flash_attention_bwd_plain(q, k, v, out, lse,
                                                          do, True)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.shape == w.shape
                assert bool(((g.float() - w.float()).abs()
                             <= flash_module.grad_tolerance(w)).all())

    def test_moe_training_shape(self, cuda):
        """``train_moe``'s backward, (16, 1, 1024, 128) bf16."""
        q, k, v, do = (t.to(torch.bfloat16).to(cuda) for t in
                       random_qkv(16, 1, 1024, 1024, 128, 11)
                       + random_qkv(16, 1, 1024, 1024, 128, 12)[:1])
        self.check(q, k, v, do, causal=False)

    def test_unaligned_do_is_refused(self, cuda):
        q, k, v = (t.to(cuda) for t in random_qkv(1, 1, 8, 8, 16, 3))
        out, lse = flash_attention(q, k, v, return_lse=True)
        flat = torch.zeros(8 * 16 + 1, device=cuda)
        with pytest.raises(ValueError, match="aligned"):
            flash_module.flash_attention_bwd(q, k, v, out, lse,
                                             flat[1:].view(1, 1, 8, 16))

    # The fused bf16 kernel's edges: a CTA owns 128 keys (64 for each of two
    # consumer warpgroups) and walks query tiles of 64 rows, both loaded by
    # TMA and zero-filled past S; dQ lands in an accumulator padded to a
    # multiple of 64 rows.

    @pytest.mark.parametrize("s_q", [63, 65, 127, 129])
    @pytest.mark.parametrize("d", [64, 128])
    def test_query_rows_around_the_query_tile(self, cuda, s_q, d):
        q, k, v = (t.to(torch.bfloat16).to(cuda)
                   for t in random_qkv(2, 3, s_q, 200, d, s_q))
        do = random_qkv(2, 3, s_q, 200, d, s_q + 1)[0].to(torch.bfloat16)
        self.check(q, k, v, do.to(cuda), causal=False)

    @pytest.mark.parametrize("s_k", [127, 129, 200])
    def test_keys_around_the_key_tile(self, cuda, s_k):
        """S_k one off the 128-key tile, and a second tile's worth of
        keys past it: the tile's last keys are TMA's zero rows."""
        q, k, v = (t.to(torch.bfloat16).to(cuda)
                   for t in random_qkv(2, 2, 130, s_k, 128, s_k))
        do = random_qkv(2, 2, 130, s_k, 128, s_k + 1)[0].to(torch.bfloat16)
        self.check(q, k, v, do.to(cuda), causal=False)

    def test_one_key(self, cuda):
        """S_k = 1: the other 127 keys of the CTA's tile are masked, P = 1
        for the one key, so dv = do; the softmax over one key is constant,
        so dq and dk are zero but for rounding (dP and Delta cancel), on
        both sides, and are held below the bf16 tolerance's share of dv's
        largest magnitude instead of against the plain version's noise."""
        q, k, v = (t.to(torch.bfloat16).to(cuda)
                   for t in random_qkv(2, 2, 130, 1, 128, 1))
        do = random_qkv(2, 2, 130, 1, 128, 2)[0].to(torch.bfloat16).to(cuda)
        out, lse = flash_attention(q, k, v, return_lse=True)
        before = flash_module.bwd_launches
        dq, dk, dv = flash_module.flash_attention_bwd(q, k, v, out, lse, do)
        assert flash_module.bwd_launches == before + 1
        want = flash_module.flash_attention_bwd_plain(q, k, v, out, lse, do)[2]
        torch.cuda.synchronize()
        err = (dv.float() - want.float()).abs()
        assert bool((err <= flash_module.grad_tolerance(want)).all())
        top = float(dv.float().abs().max())
        for g in (dq, dk):
            assert float(g.float().abs().max()) <= (
                flash_module.GRAD_BFLOAT16_RTOL * top)

    @pytest.mark.parametrize("s", [129, 257])
    @pytest.mark.parametrize("d", [64, 128])
    def test_causal_one_row_past_the_tiles(self, cuda, s, d):
        q, k, v = (t.to(torch.bfloat16).to(cuda)
                   for t in random_qkv(2, 2, s, s, d, s))
        do = random_qkv(2, 2, s, s, d, s + 1)[0].to(torch.bfloat16)
        self.check(q, k, v, do.to(cuda), causal=True)

    def test_fused_qkv_view_at_the_training_length(self, cuda):
        """q/k/v as (B, H, S, D) views of a fused (B, S, 3, H, D)
        projection and dO as the (B, S, H, D)-ordered view, at S = 4096."""
        b, s, h, d = 2, 4096, 2, 128
        rng = np.random.default_rng(11)
        parts = torch.from_numpy(rng.standard_normal(
            (b, s, 3, h, d)).astype(np.float32)).to(torch.bfloat16).to(cuda)
        q, k, v = (parts[:, :, i].transpose(1, 2) for i in range(3))
        do = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
            np.float32)).to(torch.bfloat16).to(cuda).transpose(1, 2)
        assert q.stride(1) < q.stride(2) and not do.is_contiguous()
        self.check(q, k, v, do, causal=False)

    @pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
    def test_repeat_calls(self, cuda, causal):
        """dQ's float32 adds land in L2 in any order, so two calls on the
        same inputs agree within the tolerance; dK and dV are summed in
        registers and agree bit for bit."""
        q, k, v, do = (t.to(torch.bfloat16).to(cuda) for t in
                       random_qkv(2, 2, 1000, 1000, 128, 12)
                       + random_qkv(2, 2, 1000, 1000, 128, 13)[:1])
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        first = flash_module.flash_attention_bwd(q, k, v, out, lse, do, causal)
        second = flash_module.flash_attention_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        err = (first[0].float() - second[0].float()).abs()
        assert bool((err <= flash_module.grad_tolerance(second[0])).all())
        assert torch.equal(first[1], second[1])
        assert torch.equal(first[2], second[2])

    @pytest.mark.parametrize("shape", [
        (8, 2, 4096, 4096, 128),  # the training shape
        (2, 2, 1000, 1000, 16), (2, 2, 1000, 1000, 32),
        (2, 2, 1000, 1000, 64), (2, 2, 1000, 1000, 128),
    ], ids=["train", "d16", "d32", "d64", "d128"])
    @pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
    def test_deterministic_repeat_calls(self, cuda, deterministic, shape,
                                        causal):
        """Under ``torch.use_deterministic_algorithms(True)`` the fused
        kernel adds each dQ tile in one fixed order (key tiles ascending),
        so two calls give dq, dk and dv bit for bit, as the reference's
        one-program-a-tile dQ does; each within the tolerance of the plain
        version."""
        b, h, s_q, s_k, d = shape
        q, k, v, do = (t.to(torch.bfloat16).to(cuda) for t in
                       random_qkv(b, h, s_q, s_k, d, 14)
                       + random_qkv(b, h, s_q, s_k, d, 15)[:1])
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        first = flash_module.flash_attention_bwd(q, k, v, out, lse, do, causal)
        second = flash_module.flash_attention_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        for a, b2 in zip(first, second):
            assert torch.equal(a, b2)
        torch.use_deterministic_algorithms(False)  # cuBLAS in the plain version
        parts = [flash_module.flash_attention_bwd_plain(  # two sequences a call
            q[i:i + 2], k[i:i + 2], v[i:i + 2], out[i:i + 2], lse[i:i + 2],
            do[i:i + 2], causal) for i in range(0, b, 2)]
        for name, g, w in zip(("dq", "dk", "dv"), first,
                              (torch.cat(p) for p in zip(*parts))):
            err = (g.float() - w.float()).abs()
            assert bool((err <= flash_module.grad_tolerance(w)).all()), \
                (name, float(err.max()))


@pytest.mark.cuda
class TestMoELayerOnCard:
    def test_capacity_dispatch_captures_in_a_cuda_graph(self, cuda):
        """The capacity dispatch (router, slots, scatter, expert products,
        gather) at the deployed widths synchronises with no host, so it
        captures in a CUDA graph, whose replay equals eager bit for bit;
        and the routing reaches every expert."""
        from ai4e_tpu_torch.models.moe import MoEFFN

        torch.backends.cuda.matmul.allow_tf32 = False
        layer = MoEFFN(128, 8, dispatch="capacity").to(cuda)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        x = torch.randn((16, 1024, 128), generator=gen).to(cuda)
        stream = torch.cuda.Stream()
        with torch.inference_mode():
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                want_y, want_top = layer(x)
            torch.cuda.current_stream().wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got_y, got_top = layer(x)
            graph.replay()
            torch.cuda.synchronize()
        assert torch.equal(got_top, want_top)
        assert torch.equal(got_y, want_y)
        assert set(want_top.unique().tolist()) == set(range(8))
        assert bool((want_y == 0).all(-1).any())  # some tokens dropped


@pytest.mark.cuda
class TestWireDecodeOnCard:
    @pytest.mark.parametrize("wire,size", [("yuv420", 256), ("dct", 256),
                                           ("yuv420", 512), ("dct", 224)])
    def test_decode_in_a_cuda_graph_equals_eager(self, cuda, wire, size):
        """The compressed wires' decode (plain PyTorch ops, no kernel of
        its own) captured in a CUDA graph: the replay equals an eager run
        bit for bit, on the card's own tables."""
        from ai4e_tpu_torch.ops import dct, yuv

        torch.backends.cuda.matmul.allow_tf32 = False
        rng = np.random.default_rng(size)
        imgs = rng.integers(0, 256, (4, size, size, 3), np.uint8)
        encode, decode = {"yuv420": (yuv.rgb_to_yuv420, yuv.yuv420_to_rgb),
                          "dct": (dct.rgb_to_dct, dct.dct_to_rgb)}[wire]
        flat = torch.from_numpy(np.stack([encode(x) for x in imgs])).to(cuda)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            want = decode(flat, size, size)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = decode(flat, size, size)
        graph.replay()
        torch.cuda.synchronize()
        assert got.shape == (4, size, size, 3) and got.dtype == torch.float32
        assert torch.equal(got, want)
        # And against the same decode on the CPU: float32 throughout (no
        # TF32 in the inverse DCT's products).
        host = decode(flat.cpu(), size, size)
        assert float((got.cpu() - host).abs().max()) <= 1e-5

    @pytest.mark.parametrize("wire", ["yuv420", "dct"])
    def test_wire_servable_replay_counts_the_argmax_kernel(self, cuda, wire):
        """A land-cover wire servable on the runtime: the bucket's graph
        (decode, UNet, the argmax kernel) replays what an eager apply
        gives (each class within 1% of the tile's pixels, as
        ``chip_smoke.py`` phase 4 holds land cover: cuDNN may pick another
        algorithm under capture), and each replay adds the argmax kernel's
        launch."""
        from ai4e_tpu_torch import ops
        from ai4e_tpu_torch.ops import dct, yuv
        from ai4e_tpu_torch.runtime.families import build_servable
        from ai4e_tpu_torch.runtime.registry import ModelRuntime

        runtime = ModelRuntime(device="cuda")
        servable = runtime.register(build_servable(
            "unet", name="lc", tile=64, widths=[8, 16], num_classes=4,
            buckets=(2,), wire=wire))
        encode = {"yuv420": yuv.rgb_to_yuv420, "dct": dct.rgb_to_dct}[wire]
        imgs = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3),
                                                 np.uint8)
        batch = np.stack([encode(x) for x in imgs])
        runtime.warmup()
        before = ops.launch_counts()["fused_seg_postprocess"]
        got = runtime.run_batch("lc", batch)
        assert ops.launch_counts()["fused_seg_postprocess"] == before + 1
        with torch.inference_mode():
            want = servable.apply_fn(servable.module,
                                     torch.from_numpy(batch).to(cuda))
        diff = np.abs(got["counts"].astype(np.int64)
                      - want["counts"].cpu().numpy().astype(np.int64))
        assert diff.max() <= 0.01 * 64 * 64, diff
        assert (got["counts"].sum(-1) == 64 * 64).all()
        assert "normalize_image" not in runtime.graphs[("lc", 2)].launches
