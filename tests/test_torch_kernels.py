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
from ai4e_tpu_torch.ops import flash_attention as flash_module
from ai4e_tpu_torch.ops.flash_attention import flash_attention

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

    @pytest.mark.parametrize("d", [8, 48, 256])
    def test_rejects_unsupported_head_dim(self, d):
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(*random_qkv(1, 1, 8, 8, d, 0))

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
    @pytest.mark.parametrize("d", [16, 32, 64, 128])
    def test_ragged_matches_plain(self, cuda, dtype, causal, d):
        q, k, v = (t.to(dtype).to(cuda) for t in random_qkv(2, 3, 1000, 1000, d, d))
        self.check(q, k, v, causal)

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


class TestFlashBackwardWrapper:
    def test_cpu_tensors_never_launch_a_kernel(self):
        before = (flash_module.bwd_dkv_launches, flash_module.bwd_dq_launches)
        q, k, v = (t.requires_grad_(True) for t in random_qkv(1, 2, 40, 40, 16, 0))
        out = flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(out.sum(), (q, k, v))
        assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
        assert (flash_module.bwd_dkv_launches,
                flash_module.bwd_dq_launches) == before
        if not torch.cuda.is_available():
            assert before == (0, 0)

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
        before = (flash_module.bwd_dkv_launches, flash_module.bwd_dq_launches)
        got = flash_module.flash_attention_bwd(q, k, v, out, lse, do, causal)
        assert (flash_module.bwd_dkv_launches,
                flash_module.bwd_dq_launches) == (before[0] + 1, before[1] + 1)
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
    @pytest.mark.parametrize("d", [16, 32, 64, 128])
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
        for name in ("flash_bwd_dkv_cuda", "flash_bwd_dq_cuda"):
            real = getattr(flash_module, name)
            monkeypatch.setattr(flash_module, name, lambda *a, real=real: (
                seen.append([t.data_ptr() for t in a[:3] + a[5:6]]), real(*a))[1])
        out = flash_attention(q, k, v)
        (grad,) = torch.autograd.grad(out.transpose(1, 2).reshape(b, s, h * d),
                                      qkv, up)
        do = up.view(b, s, h, d).transpose(1, 2)
        assert not do.is_contiguous()
        assert seen == [[q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         do.data_ptr()]] * 2
        out2, lse = flash_attention(q.detach(), k.detach(), v.detach(),
                                    return_lse=True)
        want = flash_module.flash_attention_bwd_plain(
            q.detach(), k.detach(), v.detach(), out2, lse, do)
        got = grad.view(b, s, 3, h, d)
        for i, w in enumerate(want):
            err = (got[:, :, i].transpose(1, 2).float() - w.float()).abs()
            assert bool((err <= flash_module.grad_tolerance(w)).all()), i

    def test_unaligned_do_is_refused(self, cuda):
        q, k, v = (t.to(cuda) for t in random_qkv(1, 1, 8, 8, 16, 3))
        out, lse = flash_attention(q, k, v, return_lse=True)
        flat = torch.zeros(8 * 16 + 1, device=cuda)
        with pytest.raises(ValueError, match="aligned"):
            flash_module.flash_attention_bwd(q, k, v, out, lse,
                                             flat[1:].view(1, 1, 8, 16))
