"""Model-family factories — config-driven servable construction.

Counterpart of ``ai4e_tpu/runtime/families.py`` for the families this port
serves so far: ``echo`` (the transport smoke API), ``unet`` (land-cover
segmentation), ``resnet`` (species classification), ``detector`` (the
camera-trap MegaDetector slot), each image family on the uint8 ``rgb8``
wire or a compressed one (``yuv420``, ``dct``: ``ops/yuv.py``,
``ops/dct.py``), ``vit`` (image classification on float32 pixels), and
``seqformer`` and ``moe`` (sequence classification, on the token-id or
feature wire). The response contracts are the JAX package's, byte for
byte. The streaming LM (``seqformer-lm``) is not a batch family: ``cli.build_worker``
serves it through ``runtime/kvcache.py`` and ``runtime/decode.py``.
"""

from __future__ import annotations

import io

import numpy as np
import torch
from torch import nn

from .ladder import DETECTOR_BUCKETS, IMAGE_BUCKETS
from .registry import ServableModel


def _finite_narrow_cast(arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Cast a float payload to a narrower float wire dtype, failing loudly:
    a bare astype maps |x| > dtype-max to inf, which would surface
    downstream as NaN scores instead of an error for this one task."""
    with np.errstate(over="ignore", invalid="ignore"):
        out = arr.astype(dtype, copy=False)
    if (np.issubdtype(dtype, np.floating)
            and np.issubdtype(arr.dtype, np.floating)
            and np.dtype(dtype).itemsize < arr.dtype.itemsize
            and not np.isfinite(out).all()):
        if np.isnan(arr).any():
            raise ValueError("payload contains NaN")
        raise ValueError(
            f"payload exceeds {np.dtype(dtype)} range (max |x| "
            f"{float(np.nanmax(np.abs(arr)))})")
    return out


def _npy_preprocess(shape: tuple, dtype=np.float32):
    dtype = np.dtype(dtype)

    def preprocess(body: bytes, content_type: str):
        arr = np.load(io.BytesIO(body))
        if arr.shape != shape:
            raise ValueError(f"expected {shape}, got {arr.shape}")
        return _finite_narrow_cast(arr, dtype)
    return preprocess


def _image_preprocess(shape: tuple, dtype=np.float32):
    """Payload decoder for (H, W, 3) models: ``image/*`` content types are
    decoded + resized with PIL; anything else is treated as a raw npy array
    of the exact input shape. A broken image raises ValueError -> fails
    that one task, never a batch."""
    h, w, _ = shape

    def preprocess(body: bytes, content_type: str):
        if content_type and content_type.startswith("image/"):
            try:
                from PIL import Image
            except ImportError as exc:  # pragma: no cover - PIL is baked in
                raise ValueError("image payloads need Pillow") from exc
            try:
                img = Image.open(io.BytesIO(body))
                img = img.convert("RGB").resize((w, h), Image.BILINEAR)
            except Exception as exc:  # noqa: BLE001 — bad image fails one task
                raise ValueError(f"undecodable image: {exc}") from exc
            arr = np.asarray(img, np.uint8)
            if np.dtype(dtype) == np.uint8:
                return arr
            return arr.astype(np.float32) / 255.0
        arr = np.load(io.BytesIO(body))
        if arr.shape != shape:
            raise ValueError(f"expected {shape}, got {arr.shape}")
        return cast_image_payload(arr, dtype)

    return preprocess


def cast_image_payload(arr: np.ndarray, dtype) -> np.ndarray:
    """Cast a decoded payload to the servable's input dtype. Float [0,1]
    arrays headed for a uint8-ingesting model are SCALED, not truncated;
    float->narrower-float goes through the finite-cast guard."""
    if np.dtype(dtype) == np.uint8 and arr.dtype != np.uint8:
        return np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
    return _finite_narrow_cast(arr, np.dtype(dtype))


def encode_classmap_png(classmap: np.ndarray) -> str:
    """(H, W) uint8 class ids -> base64 PNG string (grayscale, lossless;
    pixel value == class id)."""
    import base64

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(classmap.astype(np.uint8), mode="L").save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


class _Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("scale", torch.ones(()))


def _echo_state_dict(params: dict) -> dict[str, torch.Tensor]:
    return {"scale": torch.from_numpy(
        np.asarray(params["scale"], np.float32).copy())}


def _echo_params(sd: dict[str, torch.Tensor]) -> dict:
    return {"scale": np.float32(sd["scale"].item())}


def build_echo(name: str = "echo", size: int = 16, buckets=(8,),
               **_) -> ServableModel:
    """Identity model: proves the full transport without model weight. Its
    one weight, ``{"scale": 1.0}``, is a params tree like the JAX
    package's echo, so it reloads as that one does."""

    def apply_fn(module, batch):
        return batch * module.scale

    return ServableModel(
        name=name, apply_fn=apply_fn, module=_Scale(),
        input_shape=(size,), preprocess=_npy_preprocess((size,)),
        postprocess=lambda out: {"echo": np.asarray(out).tolist()},
        batch_buckets=tuple(buckets),
        state_dict_from_flax=_echo_state_dict,
        flax_from_state_dict=_echo_params)


def build_unet(name: str = "landcover", tile: int = 256,
               widths=(32, 64, 128), num_classes: int = 8,
               buckets=IMAGE_BUCKETS, fused_postprocess: bool = True,
               return_classmap: bool = False, wire: str = "rgb8",
               **_) -> ServableModel:
    """Land-cover segmentation on the fused path: clients ship uint8
    pixels, the card normalises them and reduces the logits to per-class
    counts (``ops.normalize_image`` -> ``UNet`` ->
    ``ops.fused_seg_postprocess``), so only B*C int32 counts come back.
    ``fused_postprocess=False`` is JAX's unfused path: float32 tiles go
    straight to the UNet, its logits come back, and the host computes the
    class map and the histogram (no kernel runs).
    ``return_classmap`` adds the class map as a base64 PNG (then the uint8
    map comes back too). ``wire`` is the host->device encoding: ``rgb8``
    (raw uint8 pixels, 3 B/px), ``yuv420`` (1.5 B/px) or ``dct`` (0.375
    B/px), decoded on the card before the UNet in place of the normalise;
    clients ship the same payloads on every wire. The weights are random,
    drawn from seed 0, until a checkpoint is restored
    (``cli.restore_checkpoint``)."""
    from ..convert import unet_flax_from_state_dict, unet_state_dict_from_flax
    from ..models import create_unet
    from ..ops import fused_seg_postprocess, normalize_image

    _check_wire(wire, fused_postprocess, "fused_postprocess")
    model = create_unet(generator=torch.Generator().manual_seed(0),
                        num_classes=num_classes, widths=tuple(widths),
                        device="cpu")
    converters = dict(state_dict_from_flax=unet_state_dict_from_flax,
                      flax_from_state_dict=unet_flax_from_state_dict)

    def postprocess(out):
        counts = np.asarray(out["counts"])
        result = {"class_histogram":
                  {int(c): int(n) for c, n in enumerate(counts) if n}}
        if return_classmap:
            result["classmap_png"] = encode_classmap_png(
                np.asarray(out["classmap"]))
        return result

    def on_normalized(module, x):
        return fused_seg_postprocess(module(x), with_classmap=return_classmap)

    if wire != "rgb8":
        return _WIRES[wire](name, model, on_normalized, tile, tile,
                            postprocess, buckets, converters)

    if not fused_postprocess:
        # JAX's unfused path: float32 tiles in, the logits to the host, the
        # class map and its histogram computed there.
        from ..models import segment_logits_to_classes

        def logits_postprocess(logits):
            classes = segment_logits_to_classes(
                torch.from_numpy(np.ascontiguousarray(logits))).numpy()
            values, counts = np.unique(classes, return_counts=True)
            result = {"class_histogram":
                      {int(v): int(c) for v, c in zip(values, counts)}}
            if return_classmap:
                result["classmap_png"] = encode_classmap_png(classes)
            return result

        return ServableModel(
            name=name, apply_fn=lambda module, batch: module(batch),
            module=model, input_shape=(tile, tile, 3),
            input_dtype=np.float32,
            preprocess=_image_preprocess((tile, tile, 3)),
            postprocess=logits_postprocess, batch_buckets=tuple(buckets),
            **converters)

    return ServableModel(
        name=name,
        apply_fn=lambda module, batch: on_normalized(module,
                                                     normalize_image(batch)),
        module=model, input_shape=(tile, tile, 3), input_dtype=np.uint8,
        preprocess=_image_preprocess((tile, tile, 3), np.uint8),
        postprocess=postprocess, batch_buckets=tuple(buckets), **converters)


def _check_wire(wire: str, fused: bool, fused_flag: str) -> None:
    """The JAX package's wire validation for the image families: an
    unknown wire, or a compressed wire without the fused ingestion it
    replaces (the wire's decode IS the fused ingestion), fails at build
    time."""
    if wire not in ("rgb8", "yuv420", "dct"):
        raise ValueError(f"wire must be rgb8|yuv420|dct, got {wire!r}")
    if wire in ("yuv420", "dct") and not fused:
        raise ValueError(f"wire={wire!r} requires {fused_flag}=True")


def _yuv_servable(name: str, module, apply_on_normalized, h: int, w: int,
                  postprocess, buckets, converters: dict) -> ServableModel:
    """YUV 4:2:0 wire servable for an (H, W, 3) model whose
    ``apply_on_normalized(module, x)`` takes [0, 1] float32 RGB: clients
    ship the usual image/npy payloads, the host converts them to planar
    4:2:0 (half the bytes of raw uint8 RGB), the card decodes them inside
    the bucket's CUDA graph before the model (``ops/yuv.py``)."""
    from ..ops.yuv import (rgb_to_yuv420, yuv420_nbytes, yuv420_to_rgb,
                           yuv420_to_rgb_numpy)

    if h % 2 or w % 2:
        # At build time: an odd size would build and then fail every
        # request in preprocess.
        raise ValueError(f"wire='yuv420' needs even dims, got {h}x{w}")
    rgb_pre = _image_preprocess((h, w, 3), np.uint8)

    def preprocess(body: bytes, content_type: str):
        return rgb_to_yuv420(rgb_pre(body, content_type))

    def apply_fn(module, batch):
        return apply_on_normalized(module, yuv420_to_rgb(batch, h, w))

    return ServableModel(
        name=name, apply_fn=apply_fn, module=module,
        input_shape=(yuv420_nbytes(h, w),), input_dtype=np.uint8,
        preprocess=preprocess, postprocess=postprocess,
        batch_buckets=tuple(buckets),
        # Batch stacks keep shipping (N, H, W, 3); each item becomes planes
        # at ingestion (serve_batch).
        stack_item_shape=(h, w, 3), stack_item_dtype=np.uint8,
        stack_adapter=rgb_to_yuv420,
        # Host consumers of the preprocessed example (a crops handoff
        # cropping this stage's input) get the RGB image back.
        example_decoder=lambda flat: yuv420_to_rgb_numpy(flat, h, w),
        **converters)


def _dct_servable(name: str, module, apply_on_normalized, h: int, w: int,
                  postprocess, buckets, converters: dict) -> ServableModel:
    """DCT-truncation wire servable (``ops/dct.py``): the host packs
    quantised KxK DCT coefficients (int8, 0.375 B/px), the card
    dequantises and inverts them inside the bucket's CUDA graph before the
    model. Its products are float32 because ``ModelRuntime`` switches TF32
    off on the card; in TF32 (about three decimal digits) the decoded
    pixels would drift by whole levels. Same construction contract as
    ``_yuv_servable``."""
    from ..ops.dct import dct_nbytes, dct_to_rgb, dct_to_rgb_numpy, rgb_to_dct

    if h % 16 or w % 16:
        # At build time (8-px luma blocks x 2x chroma subsampling).
        raise ValueError(f"wire='dct' needs dims divisible by 16, "
                         f"got {h}x{w}")
    rgb_pre = _image_preprocess((h, w, 3), np.uint8)

    def preprocess(body: bytes, content_type: str):
        return rgb_to_dct(rgb_pre(body, content_type))

    def apply_fn(module, batch):
        return apply_on_normalized(module, dct_to_rgb(batch, h, w))

    return ServableModel(
        name=name, apply_fn=apply_fn, module=module,
        input_shape=(dct_nbytes(h, w),), input_dtype=np.int8,
        preprocess=preprocess, postprocess=postprocess,
        batch_buckets=tuple(buckets),
        stack_item_shape=(h, w, 3), stack_item_dtype=np.uint8,
        stack_adapter=rgb_to_dct,
        example_decoder=lambda flat: dct_to_rgb_numpy(flat, h, w),
        **converters)


_WIRES = {"yuv420": _yuv_servable, "dct": _dct_servable}


def _maybe_fused_uint8(apply_fn, fused: bool):
    """uint8 ingestion: the card normalises the batch to [0, 1]
    (``ops.normalize_image``, the hand-written kernel) before the model.
    Returns ``(apply_fn, input_dtype)``; without ``fused`` the model takes
    float32 [0, 1] pixels as they come."""
    if not fused:
        return apply_fn, np.float32
    from ..ops import normalize_image

    def fused_apply(module, batch):
        return apply_fn(module, normalize_image(batch))

    return fused_apply, np.uint8


def build_resnet(name: str = "classifier", image_size: int = 224,
                 num_classes: int = 1000, stage_sizes=(3, 4, 6, 3),
                 width: int = 64, labels: list | None = None,
                 buckets=IMAGE_BUCKETS, fused_normalize: bool = True,
                 wire: str = "rgb8", **_) -> ServableModel:
    """Batched species classification. With ``fused_normalize`` (the
    default) clients ship uint8 pixels and the card scales them to [0, 1]
    before the ResNet; a compressed ``wire`` (``yuv420``, ``dct``) decodes
    to [0, 1] on the card instead, and batch stacks and crops handoffs
    keep shipping (N, H, W, 3), each item encoded at ingestion. The response is ``{"class_id", "label",
    "confidence"}``, the label ``str(class_id)`` without ``labels``. The
    weights are random, drawn from seed 0, until a checkpoint is
    restored."""
    from ..convert import resnet_flax_from_state_dict, \
        resnet_state_dict_from_flax
    from ..models import create_resnet

    _check_wire(wire, fused_normalize, "fused_normalize")
    model = create_resnet(generator=torch.Generator().manual_seed(0),
                          stage_sizes=tuple(stage_sizes),
                          num_classes=num_classes, width=width, device="cpu")

    def postprocess(logits):
        logits = np.asarray(logits, np.float64)
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        top = int(np.argmax(probs))
        return {"class_id": top,
                "label": labels[top] if labels else str(top),
                "confidence": float(probs[top])}

    converters = dict(state_dict_from_flax=resnet_state_dict_from_flax,
                      flax_from_state_dict=resnet_flax_from_state_dict)
    if wire != "rgb8":
        return _WIRES[wire](name, model, lambda module, x: module(x),
                            image_size, image_size, postprocess, buckets,
                            converters)

    apply_fn, input_dtype = _maybe_fused_uint8(
        lambda module, batch: module(batch), fused_normalize)
    return ServableModel(
        name=name, apply_fn=apply_fn, module=model,
        input_shape=(image_size, image_size, 3), input_dtype=input_dtype,
        preprocess=_image_preprocess((image_size, image_size, 3),
                                     input_dtype),
        postprocess=postprocess, batch_buckets=tuple(buckets), **converters)


def build_detector(name: str = "megadetector", image_size: int = 512,
                   widths=(64, 128, 256), max_detections: int = 64,
                   score_threshold: float = 0.2, buckets=DETECTOR_BUCKETS,
                   fused_normalize: bool = True, wire: str = "rgb8",
                   **_) -> ServableModel:
    """Camera-trap detection. The card runs normalize (with
    ``fused_normalize``; a compressed ``wire``'s decode in its place), the
    CenterNet and its decode to ``max_detections`` rows; the response lists the rows scoring at least
    ``score_threshold``, best first: ``{"detections": [{"box": [y0, x0,
    y1, x1], "score", "class_id"}, ...]}``. The weights are random, drawn
    from seed 0, until a checkpoint is restored."""
    from ..convert import detector_flax_from_state_dict, \
        detector_state_dict_from_flax
    from ..models import create_detector, decode_detections

    _check_wire(wire, fused_normalize, "fused_normalize")
    model = create_detector(generator=torch.Generator().manual_seed(0),
                            widths=tuple(widths), device="cpu")

    def raw_apply(module, batch):
        return decode_detections(module(batch), max_detections=max_detections)

    def postprocess(out):
        scores = np.asarray(out["scores"])
        keep = scores >= score_threshold
        return {"detections": [
            {"box": np.asarray(out["boxes"])[i].tolist(),
             "score": float(scores[i]),
             "class_id": int(np.asarray(out["classes"])[i])}
            for i in np.nonzero(keep)[0]]}

    converters = dict(state_dict_from_flax=detector_state_dict_from_flax,
                      flax_from_state_dict=detector_flax_from_state_dict)
    if wire != "rgb8":
        return _WIRES[wire](name, model, raw_apply, image_size, image_size,
                            postprocess, buckets, converters)

    apply_fn, input_dtype = _maybe_fused_uint8(raw_apply, fused_normalize)
    return ServableModel(
        name=name, apply_fn=apply_fn, module=model,
        input_shape=(image_size, image_size, 3), input_dtype=input_dtype,
        preprocess=_image_preprocess((image_size, image_size, 3),
                                     input_dtype),
        postprocess=postprocess, batch_buckets=tuple(buckets), **converters)


def _classification_postprocess():
    """Softmax and argmax -> ``{"class_id", "confidence"}``, in float64 on
    the host."""
    def postprocess(logits):
        logits = np.asarray(logits, np.float64)
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        top = int(np.argmax(probs))
        return {"class_id": top, "confidence": float(probs[top])}
    return postprocess


def _check_token_ids(arr: np.ndarray, vocab_size: int) -> None:
    """THE token-id validation: integer dtype (floats would silently
    truncate fractional ids) and range (an out-of-range id must fail its
    task, not score silently wrong). Must run on the RAW payload, before
    any cast: an int64 id >= 2**32 wraps into range under int32."""
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"token payload must be integer, got {arr.dtype}")
    if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= vocab_size):
        raise ValueError(
            f"token ids must be in [0, {vocab_size}); got "
            f"[{int(arr.min())}, {int(arr.max())}]")


def _token_preprocess(seq_len: int, vocab_size: int):
    """Payload decoder for token-id sequences: any integer npy of shape
    (S,) in ``[0, vocab_size)``. Clients ship the narrowest integer dtype
    they like (uint16 for vocabs up to 64k: 2 bytes/token on the HTTP
    wire); the device batch is int32 either way. Out-of-range ids fail that
    one task at preprocess, never the batch."""

    def preprocess(body: bytes, content_type: str):
        arr = np.load(io.BytesIO(body))
        if arr.shape != (seq_len,):
            raise ValueError(f"expected ({seq_len},), got {arr.shape}")
        _check_token_ids(arr, vocab_size)
        return arr.astype(np.int32)
    return preprocess


def _sequence_input_contract(seq_len: int, input_dim: int,
                             vocab_size: int | None,
                             feature_dtype=np.float32):
    """``(input_shape, input_dtype, preprocess, stack_kwargs)`` of the
    sequence families' wire: token ids when ``vocab_size`` is set, float
    feature sequences otherwise. Token mode's ``stack_kwargs`` install
    ``_check_token_ids`` as the batch API's stack validator, which runs on
    the RAW stack before the cast to the device type (a check after it
    would pass ids that wrapped into range)."""
    if vocab_size is not None:
        return ((seq_len,), np.dtype(np.int32),
                _token_preprocess(seq_len, vocab_size),
                {"stack_validator":
                 lambda arr: _check_token_ids(arr, vocab_size)})
    fdt = np.dtype(feature_dtype)
    return ((seq_len, input_dim), fdt,
            _npy_preprocess((seq_len, input_dim), fdt), {})


def build_seqformer(name: str = "longcontext", seq_len: int = 4096,
                    input_dim: int = 64, dim: int = 128, depth: int = 2,
                    heads: int = 8, num_classes: int = 16,
                    attention: str = "auto", causal: bool = False,
                    buckets=(1, 8), mesh=None, wire_dtype: str = "float16",
                    vocab_size: int | None = None, **_) -> ServableModel:
    """Long-context sequence classification through the hand-written flash
    attention kernel (``attention`` ``auto``/``flash``; ``full`` serves
    plain attention). Two input contracts:

    - ``vocab_size=N``, token mode, the production wire: an (S,) integer
      npy of ids, embedded on the card;
    - ``vocab_size=None``, feature mode: (S, input_dim) float sequences on
      a ``wire_dtype`` (float16 default, float32 accepted) wire; the model
      computes in bfloat16 either way. Payloads outside float16's range
      fail that task at preprocess.

    The response is ``{"class_id", "confidence"}``. The weights are random,
    drawn from seed 0, until a checkpoint is restored. Over a device
    ``mesh`` whose sp axis is larger than one, ``auto`` (and ``ring`` or
    ``ulysses``) shards the sequence over sp."""
    from ..convert import (seqformer_flax_from_state_dict,
                           seqformer_state_dict_from_flax)
    from ..models import create_seqformer

    wdt = np.dtype(wire_dtype)
    if wdt not in (np.dtype(np.float16), np.dtype(np.float32)):
        raise ValueError(f"wire_dtype must be float16/float32, got {wire_dtype}")

    model = create_seqformer(
        generator=torch.Generator().manual_seed(0), seq_len=seq_len,
        input_dim=input_dim, dim=dim, depth=depth, heads=heads,
        num_classes=num_classes, mesh=mesh, attention=attention,
        causal=causal, vocab_size=vocab_size, device="cpu")

    input_shape, input_dtype, preprocess, stack_kwargs = \
        _sequence_input_contract(seq_len, input_dim, vocab_size,
                                 feature_dtype=wdt)
    return ServableModel(
        name=name, apply_fn=lambda module, batch: module(batch), module=model,
        input_shape=input_shape, input_dtype=input_dtype,
        preprocess=preprocess, postprocess=_classification_postprocess(),
        batch_buckets=tuple(buckets),
        state_dict_from_flax=seqformer_state_dict_from_flax,
        flax_from_state_dict=seqformer_flax_from_state_dict,
        **stack_kwargs)


def build_moe(name: str = "moe", seq_len: int = 1024, input_dim: int = 64,
              dim: int = 128, depth: int = 2, heads: int = 8,
              num_experts: int = 8, num_classes: int = 16,
              attention: str = "flash", dispatch: str = "dense",
              capacity_factor: float = 1.25, buckets=(1, 8), mesh=None,
              vocab_size: int | None = None, **_) -> ServableModel:
    """Mixture-of-Experts sequence classification through the hand-written
    flash attention kernel, on the seqformer family's wire (``vocab_size``:
    (S,) integer token ids; else (S, input_dim) float32 features).
    ``dispatch="capacity"`` serves the GShard-style static-capacity path.
    The response is ``{"class_id", "confidence"}``. The weights are random,
    drawn from seed 0, until a checkpoint is restored. Over a device
    ``mesh`` the runtime shards the experts over ep by ``MOE_EP_RULES``."""
    from ..convert import moe_flax_from_state_dict, moe_state_dict_from_flax
    from ..models import create_moe
    from ..models.moe import MOE_EP_RULES

    model = create_moe(
        generator=torch.Generator().manual_seed(0), seq_len=seq_len,
        input_dim=input_dim, dim=dim, depth=depth, heads=heads,
        num_experts=num_experts, num_classes=num_classes, mesh=mesh,
        attention=attention, dispatch=dispatch,
        capacity_factor=capacity_factor, vocab_size=vocab_size, device="cpu")

    input_shape, input_dtype, preprocess, stack_kwargs = \
        _sequence_input_contract(seq_len, input_dim, vocab_size)
    return ServableModel(
        name=name, apply_fn=lambda module, batch: module(batch), module=model,
        input_shape=input_shape, input_dtype=input_dtype,
        preprocess=preprocess, postprocess=_classification_postprocess(),
        batch_buckets=tuple(buckets),
        state_dict_from_flax=moe_state_dict_from_flax,
        flax_from_state_dict=moe_flax_from_state_dict,
        param_sharding_rules=MOE_EP_RULES, **stack_kwargs)


def build_vit(name: str = "vit", image_size: int = 224, patch: int = 16,
              dim: int = 384, depth: int = 12, heads: int = 6,
              num_classes: int = 1000, buckets=IMAGE_BUCKETS, mesh=None, **_
              ) -> ServableModel:
    """Image classification with a ViT on float32 (H, W, 3) npy images in
    [0, 1] (or ``image/*`` bodies, decoded and resized): the JAX package
    builds no uint8 path for this family. The response is ``{"class_id"}``.
    The weights are random, drawn from seed 0, until a checkpoint is
    restored. Over a device ``mesh`` with tp > 1 the runtime splits the
    blocks by ``TP_RULES`` (the megatron split)."""
    from ..convert import vit_flax_from_state_dict, vit_state_dict_from_flax
    from ..models import create_vit
    from ..models.vit import TP_RULES

    model = create_vit(generator=torch.Generator().manual_seed(0),
                       num_classes=num_classes, image_size=image_size,
                       patch=patch, dim=dim, depth=depth, heads=heads,
                       device="cpu", mesh=mesh)

    def postprocess(logits):
        return {"class_id": int(np.argmax(np.asarray(logits)))}

    return ServableModel(
        name=name, apply_fn=lambda module, batch: module(batch), module=model,
        input_shape=(image_size, image_size, 3),
        preprocess=_image_preprocess((image_size, image_size, 3)),
        postprocess=postprocess, batch_buckets=tuple(buckets),
        state_dict_from_flax=vit_state_dict_from_flax,
        flax_from_state_dict=vit_flax_from_state_dict,
        param_sharding_rules=TP_RULES)


FAMILIES = {
    "echo": build_echo,
    "unet": build_unet,
    "resnet": build_resnet,
    "detector": build_detector,
    "vit": build_vit,
    "seqformer": build_seqformer,
    "moe": build_moe,
}
#: Families of the JAX package this port does not serve yet, with their
#: ROADMAP items: none. (``seqformer-lm`` is served by the decode engine,
#: ``cli.build_worker``, never by ``build_servable``.)
UNPORTED_FAMILIES: dict[str, str] = {}


def build_servable(family: str, **kwargs) -> ServableModel:
    if family in UNPORTED_FAMILIES:
        raise ValueError(f"model family {family!r} is not ported yet (ROADMAP "
                         f"{UNPORTED_FAMILIES[family]}); ported: "
                         f"{sorted(FAMILIES)}")
    if family not in FAMILIES:
        raise ValueError(
            f"unknown model family {family!r}; valid: {sorted(FAMILIES)}")
    return FAMILIES[family](**kwargs)
