"""The port's flash attention (``ai4e_tpu_torch.ops.flash_attention``) and
reference attention (``ai4e_tpu_torch.parallel.ring_attention``) against
the JAX package's, on the same inputs made with numpy from a seed.

The JAX kernel runs in interpret mode, as ``tests/test_pallas_ops.py`` runs
it; on the CPU the port's wrapper takes ``flash_attention_plain``. The CUDA
kernel is held against that plain version on the card in
``test_torch_kernels.py``."""

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
], ids=["prime-d16", "prime-d16-causal", "s256-d32", "s256-d32-causal",
        "s128-d64", "s128-d64-causal", "cross-d32"])
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
    with pytest.raises(NotImplementedError, match="A15"):
        fn(None, None, None)
