"""The port's flash attention (``ai4e_tpu_torch.ops.flash_attention``) and
reference attention (``ai4e_tpu_torch.parallel.ring_attention``) against
the JAX package's, on the same inputs made with numpy from a seed.

The JAX kernel runs in interpret mode, as ``tests/test_pallas_ops.py`` runs
it; on the CPU the port's wrapper takes ``flash_attention_plain``. The CUDA
kernel is held against that plain version on the card in
``test_torch_kernels.py``. The same holds for the gradients: ``jax.vjp``
through the Pallas backward kernels against ``torch.autograd.grad`` through
the port's autograd Function, whose CPU backward is
``flash_attention_bwd_plain``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai4e_tpu.ops.pallas import flash_attention as jax_flash
from ai4e_tpu.ops.pallas.flash_attention import (
    _dividing_block,
    _forward_call,
    default_blocks,
)
from ai4e_tpu.parallel.ring_attention import (
    reference_attention as jax_reference,
)
from ai4e_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from ai4e_tpu_torch.parallel.ring_attention import (
    reference_attention,
    ring_attention,
    ulysses_attention,
)

torch.set_num_threads(2)

# Output tolerance: float32 agrees to a few ulps (measured <= 5e-7); the
# bfloat16 output is the float32 result rounded once on each side, so a
# rounding boundary may split them by one bfloat16 ulp (measured <= 4.9e-4
# at |o| < 0.5). The logsumexp is float32 on both sides (measured <= 5e-7).
ATOL = {"float32": 1e-5, "bfloat16": 2e-3}
LSE_ATOL = 1e-5


# Head dims between and past the kernels' instantiations (16, 32, 64, 128,
# 256), causal and not: D = 8 (JAX's own SeqFormer test, dim 32 over 4
# heads), 48, 80 (a ragged S), 96, and 256 (the longcontext width at one
# head).
HEAD_DIM_CASES = [(s, s, d, causal) for s, d in ((64, 8), (128, 48),
                                                 (100, 80), (128, 96),
                                                 (128, 256))
                  for causal in (False, True)]
HEAD_DIM_IDS = [f"s{s}-d{d}{'-causal' if causal else ''}"
                for s, _, d, causal in HEAD_DIM_CASES]


def qkv(b, h, s_q, s_k, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s_q, d)).astype(np.float32),
            rng.standard_normal((b, h, s_k, d)).astype(np.float32),
            rng.standard_normal((b, h, s_k, d)).astype(np.float32))


def jax_lse(q, k, v, causal, dtype):
    """The logsumexp ``_flash3_fwd`` saves: ``_forward_call(...,
    save_lse=True)`` on the collapsed (B*H, S, D) operands, one lane."""
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    block_q, block_k = default_blocks(d)
    _, lse = _forward_call(
        *(jnp.asarray(a, dtype).reshape(b * h, -1, d) for a in (q, k, v)),
        causal, _dividing_block(s_q, block_q), _dividing_block(s_k, block_k),
        True, True)
    return np.asarray(lse)[..., 0].reshape(b, h, s_q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_q,s_k,d,causal", [
    (37, 37, 16, False),  # prime S: the TPU blocks shrink to 1, the port masks
    (37, 37, 16, True),
    (256, 256, 32, False),
    (256, 256, 32, True),
    (128, 128, 64, False),
    (128, 128, 64, True),
    (64, 192, 32, False),  # cross attention, S_q != S_k (never causal)
    *HEAD_DIM_CASES,
], ids=["prime-d16", "prime-d16-causal", "s256-d32", "s256-d32-causal",
        "s128-d64", "s128-d64-causal", "cross-d32", *HEAD_DIM_IDS])
def test_flash_matches_jax(dtype, s_q, s_k, d, causal):
    q, k, v = qkv(2, 3, s_q, s_k, d, seed=s_q + d)
    want = np.asarray(jax_flash(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                causal=causal), np.float32)
    tdt = getattr(torch, dtype)
    got, lse = flash_attention(*(torch.from_numpy(a).to(tdt)
                                 for a in (q, k, v)),
                               causal=causal, return_lse=True)
    assert got.dtype == tdt and got.shape == (2, 3, s_q, d)
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, s_q)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=ATOL[dtype])
    np.testing.assert_allclose(lse.numpy(), jax_lse(q, k, v, causal, dtype),
                               rtol=0, atol=LSE_ATOL)


def test_wrapper_is_the_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 2, 40, 40, 16, seed=9))
    assert torch.equal(flash_attention(q, k, v, causal=True),
                       flash_attention_plain(q, k, v, causal=True))


def test_causal_needs_equal_lengths():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 1, 16, 32, 16, seed=0))
    with pytest.raises(ValueError, match="S_q == S_k"):
        flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="S_q == S_k"):
        jax_flash(q.numpy(), k.numpy(), v.numpy(), causal=True)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_reference_attention_matches_jax(causal):
    """The ``full`` strategy: float32, a few ulps."""
    q, k, v = qkv(2, 2, 48, 48, 16, seed=5)
    want = np.asarray(jax_reference(q, k, v, causal=causal))
    got = reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_reference_agrees_with_flash():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 2, 64, 64, 32, seed=6))
    np.testing.assert_allclose(
        reference_attention(q, k, v, causal=True).numpy(),
        flash_attention(q, k, v, causal=True).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fn", [ring_attention, ulysses_attention])
def test_sequence_parallel_strategies_name_their_roadmap_item(fn):
    """Ported with the parallel plane (ROADMAP A15): they shard over a
    device mesh, and without one they refuse (tests/test_torch_parallel.py
    holds them against JAX's over gloo ranks)."""
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="needs a device mesh"):
        fn(q, q, q, None)


# Gradient tolerance: float32 within 1e-5 (measured <= 2.2e-6 against
# gradients of scale 1 to 4); bfloat16 within one bfloat16 ulp of JAX's
# gradient, rtol 2**-7 plus atol 1e-3 (measured <= 3.9e-3 at |g| up to 4.1).
GRAD_TOL = {"float32": dict(rtol=0, atol=1e-5),
            "bfloat16": dict(rtol=2 ** -7, atol=1e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_q,s_k,d,causal", [
    (37, 37, 16, False),  # ragged S
    (37, 37, 16, True),
    (256, 256, 32, True),
    (128, 128, 64, False),
    (64, 192, 32, False),  # cross attention
    *HEAD_DIM_CASES,
], ids=["prime-d16", "prime-d16-causal", "s256-d32-causal", "s128-d64",
        "cross-d32", *HEAD_DIM_IDS])
def test_flash_gradients_match_jax(dtype, s_q, s_k, d, causal):
    """``jax.vjp`` through the TPU package's flash attention (its Pallas
    backward kernels in interpret mode) against ``torch.autograd.grad``
    through the port's (its plain backward on the CPU), with a fixed random
    cotangent."""
    q, k, v = qkv(2, 3, s_q, s_k, d, seed=s_q + d)
    do = np.random.default_rng(d).standard_normal(
        (2, 3, s_q, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal=causal),
                     *(jnp.asarray(a, dtype) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, dtype))
    tdt = getattr(torch, dtype)
    inputs = tuple(torch.from_numpy(a).to(tdt).requires_grad_(True)
                   for a in (q, k, v))
    got = torch.autograd.grad(flash_attention(*inputs, causal=causal),
                              inputs, torch.from_numpy(do).to(tdt))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tdt and g.shape == inputs["qkv".index(name)].shape
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   err_msg=f"d{name}", **GRAD_TOL[dtype])


def test_backward_wrapper_is_the_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 2, 40, 40, 16, seed=3))
    do = torch.from_numpy(qkv(1, 2, 40, 40, 16, seed=4)[0])
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, do, True, "q")
    assert torch.equal(dq, want[0]) and dk is None and dv is None


def test_autograd_only_where_it_records(monkeypatch):
    """Under inference_mode/no_grad the served path neither computes an
    lse nor saves tensors: the autograd Function is not entered."""
    import ai4e_tpu_torch.ops.flash_attention as fa

    q, k, v = (torch.from_numpy(a) for a in qkv(1, 2, 40, 40, 16, seed=8))
    want = flash_attention(q, k, v)
    calls = []
    real = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a: calls.append(a[-1]) or real(*a))
    with torch.inference_mode():
        assert torch.equal(flash_attention(q.requires_grad_(True), k, v),
                           want)
    with torch.no_grad():
        flash_attention(q, k, v)
    assert calls == [False, False]  # return_lse
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None and calls[-1] is True


@pytest.mark.parametrize("edit,match", [
    (lambda t: dict(t, lse=t["lse"].double()), "lse must be float32"),
    (lambda t: dict(t, lse=t["lse"][:, :, :-1]), "lse must be float32"),
    (lambda t: dict(t, do=t["do"][:, :, :-1]), "must have q's shape"),
], ids=["lse-dtype", "lse-shape", "do-shape"])
def test_backward_rejects_bad_operands(edit, match):
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 2, 16, 16, 16, seed=1))
    out, lse = flash_attention(q, k, v, return_lse=True)
    t = edit({"out": out, "lse": lse, "do": out.clone()})
    with pytest.raises(ValueError, match=match):
        flash_attention_bwd(q, k, v, t["out"], t["lse"], t["do"])
