"""The port's kernel harness (``ai4e_tpu_torch.ops.validate``) against the
JAX package's (``ai4e_tpu.ops.pallas.validate``).

On the CPU the port's ``validate_kernels(device="cpu")`` runs the plain
versions, JAX's ``validate_kernels(interpret=True)`` its Pallas kernels in
the interpreter: both harnesses' own logic, at the same shapes, against
their oracles. Tolerances are JAX's: flash float32 within 1e-4 of the
float64 oracle, the argmax equal on more than 0.9999 of the pixels,
normalize within 1e-5; the port's bfloat16 flash and its backward within
``ops.flash_attention.tolerance`` and ``grad_tolerance``. The shared-memory
mirrors stay under the H100's opt-in 232,448 B a block at every head dim
the flash kernels take; that each equals what its kernel reports is
checked on the card (``chip_smoke.py`` phase 3)."""

import numpy as np
import pytest
import torch

from ai4e_tpu.ops.pallas.validate import validate_kernels as jax_validate
from ai4e_tpu_torch.ops import validate
from ai4e_tpu_torch.ops.flash_attention import HEAD_DIMS

JAX_KERNELS = ("flash_attention", "segmentation_argmax", "normalize_image")
PORT_ONLY = ("flash_attention_bf16", "flash_attention_bwd",
             "flash_attention_bwd_bf16", "flash_attention_bf16_d256",
             "flash_attention_bwd_bf16_d256")


@pytest.fixture(scope="module")
def port() -> dict:
    return validate.validate_kernels(device="cpu")


@pytest.fixture(scope="module")
def jax_results() -> dict:
    return jax_validate(interpret=True)


def kernel_keys(results: dict) -> set:
    return {k for k, v in results.items() if isinstance(v, dict) and "ok" in v}


def test_the_port_holds_jax_s_kernels_and_the_backward(port, jax_results):
    assert kernel_keys(jax_results) == set(JAX_KERNELS)
    assert kernel_keys(port) == set(JAX_KERNELS) | set(PORT_ONLY)


def test_both_harnesses_pass(port, jax_results):
    assert jax_results["all_ok"] is True
    assert port["all_ok"] is True
    assert port["device"] == "cpu"


@pytest.mark.parametrize("name,bound", [
    ("flash_attention", validate.FLASH_F32_TOL),
    ("normalize_image", validate.NORMALIZE_TOL),
    ("segmentation_argmax", 1 - validate.ARGMAX_MIN_SHARE)])
def test_each_error_is_within_jax_s_tolerance(port, jax_results, name, bound):
    for results in (port, jax_results):
        assert results[name]["ok"] is True
        assert results[name]["max_err"] < bound


@pytest.mark.parametrize("name", PORT_ONLY)
def test_the_port_s_extra_kernels_pass(port, name):
    assert port[name]["ok"] is True
    assert 0 <= port[name]["max_err"] < 0.05


def test_plain_versions_report_no_registers(port):
    for name in kernel_keys(port):
        assert port[name]["registers"] is None
        assert 0 < port[name]["smem_bytes"] <= validate.SMEM_LIMIT_BYTES


def test_the_flash_rows_report_the_mirrors(port):
    d = validate.FLASH_SHAPE[-1]
    assert port["flash_attention"]["smem_bytes"] == \
        validate.flash_attention_smem_bytes(d, torch.float32)
    assert port["flash_attention_bf16"]["smem_bytes"] == \
        validate.flash_attention_smem_bytes(d)
    assert port["flash_attention_bwd_bf16"]["smem_bytes"] == \
        validate.flash_attention_bwd_smem_bytes(d)
    wide = validate.FLASH_WIDE_SHAPE[-1]
    assert port["flash_attention_bf16_d256"]["smem_bytes"] == \
        validate.flash_attention_smem_bytes(wide)
    assert port["flash_attention_bwd_bf16_d256"]["smem_bytes"] == \
        validate.flash_attention_bwd_smem_bytes(wide)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_smem_mirrors_fit_an_h100_block(d, dtype):
    for mirror in (validate.flash_attention_smem_bytes,
                   validate.flash_attention_bwd_smem_bytes):
        assert 0 < mirror(d, dtype) <= validate.SMEM_LIMIT_BYTES


def test_the_fused_backward_s_mirror_is_the_kernel_s_layout():
    """csrc/flash_attention.cu states the fused backward's bytes a CTA
    (``-Xptxas -v``): 59,432 / 84,008 / 133,160 / 198,696 at D = 16 / 32 /
    64 / 128, and the wide kernel's 215,080 at D = 256."""
    assert [validate.flash_attention_bwd_smem_bytes(d) for d in HEAD_DIMS] \
        == [59_432, 84_008, 133_160, 198_696, 215_080]


def test_the_mirrors_on_the_cpu_have_no_kernel_report(port):
    mirrors = port["smem_mirrors"]
    assert len(mirrors) == 4 * len(HEAD_DIMS)
    for entry in mirrors.values():
        assert entry["kernel"] is None and entry["ok"] is True


@pytest.mark.parametrize("c", [1, 4, 255])
def test_argmax_and_normalize_mirrors(c):
    assert validate.segmentation_argmax_smem_bytes(c) == 4 * c
    assert validate.normalize_image_smem_bytes() == 64


@pytest.mark.parametrize("c,smem", [(1, 64), (8, 64), (13, 104), (256, 2048)])
def test_normalize_mirror_past_eight_channels(c, smem):
    """Up to 8 channels the static 2 x 8 floats; past them the wide
    kernel's 2 x C floats of dynamic shared memory."""
    assert validate.normalize_image_smem_bytes(c) == smem


def test_launch_ok_refuses_a_register_file_overrun():
    fits = {"smem_bytes": 1024, "registers": 168, "threads": 384}
    assert validate.launch_ok(fits)
    assert not validate.launch_ok(dict(fits, registers=171))
    assert not validate.launch_ok(dict(fits, smem_bytes=232_449))


def test_a_cuda_device_without_a_card_raises():
    """The default device is the card, with no fallback to the CPU (this
    file runs where JAX is, with no card)."""
    with pytest.raises(RuntimeError):
        validate.validate_kernels()


def test_float32_flash_error_is_jax_s_order(port, jax_results):
    """Both harnesses' float32 flash errors are float32 rounding against
    the float64 oracle: within a factor of 100 of each other."""
    ratio = port["flash_attention"]["max_err"] / max(
        jax_results["flash_attention"]["max_err"], 1e-12)
    assert 1e-2 < ratio < 1e2, ratio
    assert np.isfinite(ratio)
