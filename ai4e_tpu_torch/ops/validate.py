"""Kernel validation on the card — counterpart of
``ai4e_tpu/ops/pallas/validate.py``.

``validate_kernels()`` runs each hand-written kernel against a float64
oracle at the JAX harness's shapes and checks that its launch fits an
H100 SM: the counterpart of JAX's proof that its Pallas kernels compile
for the TPU and fit its VMEM. JAX's VMEM budget becomes a Hopper budget:

- ``*_smem_bytes`` mirror each kernel's shared-memory layout in Python
  (the counterparts of JAX's ``*_vmem_bytes``), and each must stay under
  the H100's opt-in limit of ``SMEM_LIMIT_BYTES`` a block;
- on the card each mirror must equal what the kernel itself reports
  (``ai4e_flash_attention_attrs``, ``ai4e_normalize_u8_attrs``,
  ``ai4e_seg_postprocess_attrs``: ``cudaFuncGetAttributes`` beside the
  dynamic shared memory each launch asks for), for every head dim the
  flash kernels take;
- a kernel whose registers a thread times its threads exceed the SM's
  ``REGISTERS_PER_SM`` fails: not even one CTA would fit.

Beyond JAX's harness it holds the flash attention in bfloat16, as the port
serves it, and the flash backward (dq, dk, dv), each also at one head of
256 (``FLASH_WIDE_SHAPE``, the D = 256 instantiation). On the CPU the same checks
run the plain versions (the counterpart of JAX's ``interpret=True``): that
covers the harness's own logic, and the launch attributes are ``None``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from . import flash_attention as fa

#: The H100's opt-in shared memory a block may take (227 KiB).
SMEM_LIMIT_BYTES = 232_448
#: 32-bit registers an SM holds.
REGISTERS_PER_SM = 65_536
#: The harness's shapes, JAX's (``validate.py:44-113``), and beyond JAX's
#: the port's widest flash instantiation, one head of 256 (bfloat16 only).
FLASH_SHAPE = (2, 4, 512, 64)
FLASH_WIDE_SHAPE = (2, 1, 512, 256)
ARGMAX_SHAPE = (2, 256, 256, 4)
NORMALIZE_SHAPE = (2, 256, 256, 3)
MEAN, STD = (0.45, 0.45, 0.4), (0.22, 0.22, 0.25)
#: JAX's tolerances (its CPU bounds): flash float32 max abs error, the
#: argmax's share of equal pixels, normalize max abs error.
FLASH_F32_TOL, ARGMAX_MIN_SHARE, NORMALIZE_TOL = 1e-4, 0.9999, 1e-5

# Each kernel's geometry, as csrc/flash_attention.cu sets it: above D = 128
# the forward's K/V tiles hold 64 keys and its O is staged in Q's buffer,
# and the backward's wide kernel owns 64 keys a CTA.
_FWD_BLOCK, _FWD_STAGES = 128, 2
_BWD_BLOCK_M, _BWD_BLOCK_N, _BWD_STAGES = 64, 128, 2
_WIDE_D, _WIDE_BLOCK_N = 128, 64  # D above _WIDE_D: the wide tiles
_F32_BLOCK = 32
_MAX_CHANNELS = 8  # csrc/image_preprocess.cu's kMaxChannels
_ALIGN = 1024      # the dynamic buffer's base is aligned up to 1024 B

#: ``ai4e_flash_attention_attrs``' ``which`` of each flash kernel.
FLASH_KERNELS = {"flash_fwd_wgmma": 0, "flash_fwd_f32": 1,
                 "flash_bwd_wgmma": 2, "flash_bwd_wgmma_ordered": 3,
                 "flash_bwd_prep_bf16": 4, "flash_bwd_prep_f32": 5,
                 "flash_bwd_dq_convert": 6, "flash_bwd_dkv_f32": 7,
                 "flash_bwd_dq_f32": 8}


def flash_attention_smem_bytes(d: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory a CTA of the flash forward takes at the
    instantiation ``d``. bfloat16 (``FwdSmem``): Q, two stages of K and of V
    (128 keys a tile; 64 above D = 128), up to D = 128 two 64-row output
    staging tiles of D + 8 columns (above it O is staged in Q's buffer),
    nine mbarriers, 1 KiB of alignment. float32 (``F32Tiles``): K and V
    tiles of D + 1 columns, a Q tile and a 32 x 33 score tile."""
    if dtype == torch.float32:
        return (2 * _F32_BLOCK * (d + 1) + _F32_BLOCK * d
                + _F32_BLOCK * (_F32_BLOCK + 1)) * 4
    wide = d > _WIDE_D
    q = _FWD_BLOCK * d * 2
    kv = (_WIDE_BLOCK_N if wide else _FWD_BLOCK) * d * 2
    o = 0 if wide else 64 * (d + 8) * 2
    bars = 1 + 4 * _FWD_STAGES
    return q + 2 * _FWD_STAGES * kv + 2 * o + bars * 8 + _ALIGN


def flash_attention_bwd_smem_bytes(d: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory a CTA of the flash backward's main kernel
    takes at the instantiation ``d``. bfloat16, the fused kernel
    (``BwdSmem``): K and V (128 keys), two stages of Q and of dO (64 rows),
    two dS^T tiles, two float32 dQ tiles, two stages of lse and of Delta,
    five mbarriers, 1 KiB of alignment; above D = 128 the wide kernel
    (``BwdWideSmem``): K and V of 64 keys, the same Q and dO ring, one
    64 x 64 dS^T tile a consumer, no dQ tile (its adds go from registers),
    lse, Delta, mbarriers and alignment. float32, the dK/dV and dQ kernels
    (``F32BwdTiles``): four 32-row tiles of D + 1 columns, lse and Delta,
    two 32 x 33 tiles."""
    if dtype == torch.float32:
        return (4 * _F32_BLOCK * (d + 1) + 2 * _F32_BLOCK
                + 2 * _F32_BLOCK * (_F32_BLOCK + 1)) * 4
    rows = _BWD_BLOCK_M * 4
    bars = 1 + 2 * _BWD_STAGES
    qdo = _BWD_BLOCK_M * d * 2
    if d > _WIDE_D:
        kv = _WIDE_BLOCK_N * d * 2
        ds = _WIDE_BLOCK_N * _BWD_BLOCK_M * 2
        return (2 * kv + 2 * _BWD_STAGES * qdo + 2 * ds
                + 2 * _BWD_STAGES * rows + bars * 8 + _ALIGN)
    split = 2 if d == 128 else 1  # dQ's columns split between consumers
    kv = _BWD_BLOCK_N * d * 2
    ds = _BWD_BLOCK_N * _BWD_BLOCK_M * 2
    dq = _BWD_BLOCK_M * (d // split) * 4
    return (2 * kv + 2 * _BWD_STAGES * qdo + 2 * ds + 2 * dq
            + 2 * _BWD_STAGES * rows + bars * 8 + _ALIGN)


def segmentation_argmax_smem_bytes(c: int) -> int:
    """Shared memory a CTA of the argmax takes for ``c`` classes: the
    block's int32 histogram (dynamic)."""
    return c * 4


def normalize_image_smem_bytes(c: int = 3) -> int:
    """Shared memory a CTA of the normalize takes for ``c`` channels: the
    per-channel scale and bias, ``kMaxChannels`` floats each (static), or
    above ``kMaxChannels`` channels ``c`` floats each (dynamic, the wide
    kernel)."""
    return 2 * max(c, _MAX_CHANNELS) * 4


# -- the kernels' own reports (on the card) -----------------------------------

_ATTR_KEYS = ("dynamic_smem_bytes", "static_smem_bytes", "registers",
              "local_bytes", "threads")


def _attrs(fn, *args) -> dict:
    out = (ctypes.c_int * 5)()
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    from . import _native
    _native.check(fn(*args, out), "cudaFuncGetAttributes")
    attrs = dict(zip(_ATTR_KEYS, out))
    attrs["smem_bytes"] = attrs["dynamic_smem_bytes"] + attrs["static_smem_bytes"]
    return attrs


def flash_attrs(kernel: str, d: int, device: int = 0) -> dict:
    """What the flash kernel ``kernel`` (a key of ``FLASH_KERNELS``)
    reports at head dim ``d``."""
    from . import _native
    lib = _native.load("flash_attention")
    return _attrs(lib.ai4e_flash_attention_attrs, FLASH_KERNELS[kernel], d,
                  device)


def normalize_attrs(device: int = 0) -> dict:
    from . import _native
    return _attrs(_native.load("image_preprocess").ai4e_normalize_u8_attrs,
                  device)


def argmax_attrs(c: int, bf16: bool = False, device: int = 0) -> dict:
    from . import _native
    return _attrs(_native.load("seg_postprocess").ai4e_seg_postprocess_attrs,
                  c, int(bf16), device)


def launch_ok(attrs: dict) -> bool:
    """One CTA fits an SM: its shared memory under the opt-in limit and
    its registers within the register file."""
    return (attrs["smem_bytes"] <= SMEM_LIMIT_BYTES
            and attrs["registers"] * attrs["threads"] <= REGISTERS_PER_SM)


def smem_mirrors(device: int | None) -> dict:
    """Each flash mirror against the kernel's own report at every head dim
    (``device`` None: the mirrors alone, against the limit)."""
    out = {}
    for kernel, mirror, dtype in (
            ("flash_fwd_wgmma", flash_attention_smem_bytes, torch.bfloat16),
            ("flash_fwd_f32", flash_attention_smem_bytes, torch.float32),
            ("flash_bwd_wgmma", flash_attention_bwd_smem_bytes,
             torch.bfloat16),
            ("flash_bwd_dkv_f32", flash_attention_bwd_smem_bytes,
             torch.float32)):
        for d in fa.HEAD_DIMS:
            want = mirror(d, dtype)
            got = (None if device is None
                   else flash_attrs(kernel, d, device)["dynamic_smem_bytes"])
            out[f"{kernel}/{d}"] = {
                "mirror": want, "kernel": got,
                "ok": want <= SMEM_LIMIT_BYTES and got in (None, want)}
    return out


# -- the harness --------------------------------------------------------------

def _attention64(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """softmax(QK^T / sqrt(D))V in float64, on the inputs' device."""
    q, k, v = (t.double() for t in (q, k, v))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1), v)


def _attention_grads64(q, k, v, do) -> tuple[torch.Tensor, ...]:
    """dq, dk, dv of full attention in float64 (autograd), on the inputs'
    device."""
    q, k, v = (t.detach().double().requires_grad_() for t in (q, k, v))
    _attention64(q, k, v).backward(do.double())
    return q.grad, k.grad, v.grad


def _entry(ok: bool, err: float, attrs: dict | None, smem: int,
           kernels: dict | None = None,
           mirrored: str = "dynamic_smem_bytes") -> dict:
    """One kernel's result: its check, and where it ran on the card its
    launch (``smem_bytes`` and ``registers`` from the kernel's own report,
    which must fit an SM and whose ``mirrored`` part must equal the
    mirror's ``smem``; else the mirror's bytes and None)."""
    fits = attrs is None or (launch_ok(attrs) and attrs[mirrored] == smem)
    result = {"ok": bool(ok and fits and smem <= SMEM_LIMIT_BYTES),
              "max_err": float(err),
              "smem_bytes": smem if attrs is None else attrs["smem_bytes"],
              "registers": None if attrs is None else attrs["registers"]}
    if attrs is not None:
        result["local_bytes"] = attrs["local_bytes"]
        result["threads"] = attrs["threads"]
    if kernels is not None:
        result["kernels"] = kernels
        result["ok"] = result["ok"] and all(launch_ok(a)
                                            for a in kernels.values())
    return result


def _flash_rows(rng, shape, dtypes, device, card, suffix: str) -> dict:
    """The flash forward and backward rows at ``shape`` for each of
    ``dtypes``: ``flash_attention``, ``flash_attention_bwd``, with
    ``_bf16`` for bfloat16 and then ``suffix``."""
    rows: dict = {}
    on_card = card is not None
    b, h, s, d = shape
    q, k, v, do = (rng.standard_normal((b, h, s, d)).astype(np.float32)
                   for _ in range(4))
    tag = {torch.float32: "", torch.bfloat16: "_bf16"}
    for dtype in dtypes:
        qt, kt, vt = (torch.from_numpy(a).to(dtype).to(device)
                      for a in (q, k, v))
        with torch.no_grad():
            got = fa.flash_attention(qt, kt, vt)
            want = _attention64(qt, kt, vt)
        err = (got.double() - want).abs()
        if dtype == torch.float32:
            ok = float(err.max()) < FLASH_F32_TOL
        else:
            ok = bool((err <= fa.tolerance(want.to(dtype))).all())
        err = float(err.max())
        kernel = "flash_fwd_f32" if dtype == torch.float32 else \
            "flash_fwd_wgmma"
        rows[f"flash_attention{tag[dtype]}{suffix}"] = _entry(
            ok, err, flash_attrs(kernel, d, card) if on_card else None,
            flash_attention_smem_bytes(d, dtype))

    # The backward against float64 autograd of full attention, from the
    # forward's own output and logsumexp.
    kernels = {torch.float32: ("flash_bwd_prep_f32", "flash_bwd_dkv_f32",
                               "flash_bwd_dq_f32"),
               torch.bfloat16: ("flash_bwd_prep_bf16", "flash_bwd_wgmma",
                                "flash_bwd_wgmma_ordered",
                                "flash_bwd_dq_convert")}
    for dtype in dtypes:
        qt, kt, vt, dot = (torch.from_numpy(a).to(dtype).to(device)
                           for a in (q, k, v, do))
        with torch.no_grad():
            out, lse = fa.flash_attention(qt, kt, vt, return_lse=True)
            grads = fa.flash_attention_bwd(qt, kt, vt, out, lse, dot)
        want = _attention_grads64(qt, kt, vt, dot)
        ok, err = True, 0.0
        for got, w in zip(grads, want):
            diff = (got.double() - w).abs()
            ok = ok and bool((diff <= fa.grad_tolerance(w.to(dtype))).all())
            err = max(err, float(diff.max()))
        reports = ({n: flash_attrs(n, d, card) for n in kernels[dtype]}
                   if on_card else None)
        main = "flash_bwd_dkv_f32" if dtype == torch.float32 else \
            "flash_bwd_wgmma"
        rows[f"flash_attention_bwd{tag[dtype]}{suffix}"] = _entry(
            ok, err, reports[main] if reports else None,
            flash_attention_bwd_smem_bytes(d, dtype), reports)
    return rows


def validate_kernels(device=None) -> dict:
    """Run each kernel against its float64 oracle on ``device`` (default
    ``cuda``; ``"cpu"`` runs the plain versions); returns one dict per
    kernel, ``{ok, max_err, smem_bytes, registers}`` (on the card also
    ``local_bytes`` and ``threads``, and for the backward each of its
    kernels' reports), plus ``smem_mirrors``, ``all_ok`` and ``device``."""
    from .image_preprocess import normalize_image
    from .seg_postprocess import segmentation_argmax

    device = resolve_device(device)
    card = (device.index or 0) if device.type == "cuda" else None
    on_card = card is not None
    results: dict = {}
    rng = np.random.default_rng(0)

    # Flash attention against softmax(QK^T)V in float64: float32 as JAX
    # runs it, bfloat16 as the port serves it; then bfloat16 at D = 256,
    # drawn from a generator of its own.
    results.update(_flash_rows(rng, FLASH_SHAPE,
                               (torch.float32, torch.bfloat16), device,
                               card, ""))
    results.update(_flash_rows(np.random.default_rng(1), FLASH_WIDE_SHAPE,
                               (torch.bfloat16,), device, card, "_d256"))

    # The argmax against numpy's on the land-cover shape (float ties may
    # differ: a share of equal pixels, as JAX's).
    logits = rng.standard_normal(ARGMAX_SHAPE).astype(np.float32)
    got_map = segmentation_argmax(torch.from_numpy(logits).to(device)).cpu()
    differ = float((got_map.numpy() != np.argmax(
        logits.astype(np.float64), -1)).mean())
    c = ARGMAX_SHAPE[-1]
    results["segmentation_argmax"] = _entry(
        1.0 - differ > ARGMAX_MIN_SHARE, differ,
        argmax_attrs(c, False, card) if on_card else None,
        segmentation_argmax_smem_bytes(c))

    # uint8 normalize against the float64 arithmetic, the tile shape.
    img = rng.integers(0, 256, NORMALIZE_SHAPE, dtype=np.uint8)
    got_n = normalize_image(torch.from_numpy(img).to(device), mean=MEAN,
                            std=STD).cpu().double().numpy()
    want_n = (img / 255.0 - np.asarray(MEAN)) / np.asarray(STD)
    err = float(np.abs(got_n - want_n).max())
    results["normalize_image"] = _entry(
        err < NORMALIZE_TOL, err, normalize_attrs(card) if on_card else None,
        normalize_image_smem_bytes(), mirrored="static_smem_bytes")

    mirrors = smem_mirrors(card)
    results["smem_mirrors"] = mirrors
    results["all_ok"] = (all(r["ok"] for r in results.values()
                             if isinstance(r, dict) and "ok" in r)
                         and all(m["ok"] for m in mirrors.values()))
    results["device"] = str(device)
    return results
