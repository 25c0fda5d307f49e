"""Deterministic checkpoint factory — counterpart of
``ai4e_tpu/train/make_checkpoints.py``: every recipe of the JAX package,
each on its seeded numpy task (the same generators, so a seed gives the
same arrays), with float32 master weights and optax's ``adamw(lr,
weight_decay=1e-5)``:

- ``landcover`` (UNet) on Voronoi land-class scenes, per-pixel cross
  entropy; ``landcover128`` the same, evaluated at the 128 px tile;
- ``megadetector`` (CenterNet) on coloured shapes, the CenterNet focal and
  L1 objective (``centernet_loss``), scored by ``detection_accuracy``
  through the serving decode;
- ``species`` and ``species_fine`` (ResNet) on coat patterns and on DCT
  textures; the BatchNorm running statistics are buffers and never train;
- ``longcontext`` (SeqFormer) and ``moe`` (MoEClassifier, trained dense,
  evaluated with the capacity dispatch it serves) on the marker task at the
  serving geometry.

``make_checkpoint`` refuses weights below the gate and saves the rest,
through the family's converter, as the ``.npz`` flax tree the port's worker
restores (``cli.restore_checkpoint``), with a ``MANIFEST.json`` entry in
the JAX package's shape. The image models are fully convolutional or
pooled, so they train at a reduced size; species and megadetector serve at
their trained size only (``FULL_OVERRIDES``: the deployed sizes).

CLI: ``python -m ai4e_tpu_torch.train.make_checkpoints --out DIR [--only
NAME ...] [--fast] [--device cpu]`` (default: every recipe, at
``FULL_OVERRIDES`` on ``cuda``; ``--fast``: the JAX package's CI table).
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from ..convert import (detector_flax_from_state_dict,
                       moe_flax_from_state_dict, resnet_flax_from_state_dict,
                       save_npz, seqformer_flax_from_state_dict,
                       seqformer_lm_flax_from_state_dict,
                       unet_flax_from_state_dict)
from ..device import resolve_device

log = logging.getLogger("ai4e_tpu_torch.make_checkpoints")

STRIDE = 8  # CenterNet backbone stride (models/detector.py)

LANDCOVER_COLORS = np.array([  # water, forest, field, impervious
    [0.15, 0.25, 0.70], [0.10, 0.50, 0.15],
    [0.75, 0.70, 0.30], [0.50, 0.50, 0.55]], np.float32)

DETECTOR_COLORS = np.array([  # animal, person, vehicle
    [0.20, 0.70, 0.20], [0.80, 0.20, 0.20], [0.20, 0.30, 0.90]], np.float32)

SPECIES_LABELS = ["lion", "zebra", "elephant", "giraffe",
                  "leopard", "okapi", "rhino", "buffalo"]
SPECIES_COLORS = np.array([
    [0.80, 0.60, 0.20], [0.90, 0.90, 0.90],
    [0.45, 0.45, 0.50], [0.85, 0.70, 0.35]], np.float32)
SPECIES_FINE_LABELS = ["serval", "genet", "civet", "caracal",
                       "duiker", "dikdik", "suni", "grysbok"]


# -- synthetic tasks (seeded, pure numpy; the JAX package's draws in its
# order) --------------------------------------------------------------------

def landcover_batch(rng: np.random.Generator, batch: int, tile: int):
    """Voronoi land-class patches; image = class colour + noise."""
    k = 5
    cy = rng.uniform(0, tile, (batch, k)).astype(np.float32)
    cx = rng.uniform(0, tile, (batch, k)).astype(np.float32)
    cls = rng.integers(0, len(LANDCOVER_COLORS), (batch, k))
    yy, xx = np.mgrid[0:tile, 0:tile].astype(np.float32)
    d = ((yy[None, :, :, None] - cy[:, None, None, :]) ** 2
         + (xx[None, :, :, None] - cx[:, None, None, :]) ** 2)
    nearest = np.argmin(d, axis=-1)                      # (B, H, W)
    labels = cls[np.arange(batch)[:, None, None], nearest]
    img = LANDCOVER_COLORS[labels] + rng.normal(0, 0.08,
                                                (batch, tile, tile, 3))
    return (np.clip(img, 0, 1).astype(np.float32),
            labels.astype(np.int32))


def detector_batch(rng: np.random.Generator, batch: int, size: int):
    """1-2 coloured boxes per scene with CenterNet training targets
    (``heatmap``, ``wh``, ``offset``, ``mask`` at stride 8). Object sizes
    are absolute (anchored at a 128 px frame), so a larger scene holds
    more background around same-sized objects."""
    h = size // STRIDE
    base = 128
    img = rng.normal(0.25, 0.05, (batch, size, size, 3)).astype(np.float32)
    heat = np.zeros((batch, h, h, 3), np.float32)
    wh = np.zeros((batch, h, h, 2), np.float32)
    off = np.zeros((batch, h, h, 2), np.float32)
    mask = np.zeros((batch, h, h, 1), np.float32)
    yy, xx = np.mgrid[0:h, 0:h].astype(np.float32)
    for b in range(batch):
        for _ in range(int(rng.integers(1, 3))):
            c = int(rng.integers(0, 3))
            if c == 0:    # animal: squarish
                bh = bw = int(rng.integers(base // 6, base // 3))
            elif c == 1:  # person: tall
                bh = int(rng.integers(base // 4, base // 2))
                bw = int(rng.integers(base // 12, base // 6))
            else:         # vehicle: wide
                bh = int(rng.integers(base // 12, base // 6))
                bw = int(rng.integers(base // 4, base // 2))
            cyp = rng.uniform(bh / 2, size - bh / 2)
            cxp = rng.uniform(bw / 2, size - bw / 2)
            y0, x0 = int(cyp - bh / 2), int(cxp - bw / 2)
            img[b, y0:y0 + bh, x0:x0 + bw] = (
                DETECTOR_COLORS[c]
                + rng.normal(0, 0.05, (bh, bw, 3)).astype(np.float32))
            gy, gx = cyp / STRIDE, cxp / STRIDE
            iy, ix = int(gy), int(gx)
            sigma = max(1.0, (bh + bw) / (6 * STRIDE))
            g = np.exp(-((yy - gy) ** 2 + (xx - gx) ** 2) / (2 * sigma ** 2))
            heat[b, :, :, c] = np.maximum(heat[b, :, :, c], g)
            heat[b, iy, ix, c] = 1.0
            wh[b, iy, ix] = (bh / STRIDE, bw / STRIDE)
            off[b, iy, ix] = (gy - iy, gx - ix)
            mask[b, iy, ix, 0] = 1.0
    targets = {"heatmap": heat, "wh": wh, "offset": off, "mask": mask}
    return np.clip(img, 0, 1), targets


def detector_batches(seed: int, batch: int, size: int, steps: int):
    """``train_megadetector``'s training batches, in order: ``steps`` draws
    of ``detector_batch`` from one generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield detector_batch(rng, batch, size)


def species_batch(rng: np.random.Generator, batch: int, size: int):
    """8 classes = 4 coat colours x 2 stripe orientations."""
    cls = rng.integers(0, 8, batch)
    color = SPECIES_COLORS[cls % 4]                      # (B, 3)
    vertical = (cls // 4).astype(bool)
    period = max(4, size // 8)
    ramp = (np.arange(size) // period) % 2               # (S,)
    img = np.empty((batch, size, size, 3), np.float32)
    for b in range(batch):
        stripes = ramp[:, None] if vertical[b] else ramp[None, :]
        m = np.broadcast_to(stripes, (size, size))[..., None]
        img[b] = m * color[b] + (1 - m) * 0.12
    img += rng.normal(0, 0.05, img.shape).astype(np.float32)
    return np.clip(img, 0, 1), cls.astype(np.int32)


def species_fine_batch(rng: np.random.Generator, batch: int, size: int):
    """Fine-grained texture classification: 8 classes = DCT frequency
    u in {2, 3} x orientation x amplitude {high, faint}, gratings that are
    exact DCT-II basis functions of each 8 px block on a grey base with
    noise, so the class lives in the u = 2/3 bands only."""
    cls = rng.integers(0, 8, batch)
    u = 2 + (cls % 2)                      # DCT frequency index per block
    vertical = ((cls // 2) % 2).astype(bool)
    amp = np.where(cls < 4, 0.15, 0.018).astype(np.float32)
    x = np.arange(size, dtype=np.float32)
    img = np.empty((batch, size, size, 3), np.float32)
    for b in range(batch):
        wave = amp[b] * np.cos(np.pi * u[b] * (2 * x + 1) / 16.0)
        field = wave[:, None] if vertical[b] else wave[None, :]
        base = 0.45 + rng.uniform(-0.04, 0.04)
        img[b] = (base + np.broadcast_to(field, (size, size)))[..., None]
    img += rng.normal(0, 0.03, img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32), cls.astype(np.int32)


def detection_accuracy(out, targets, score_floor: float = 0.15,
                       wh_rel_tolerance: float | None = None
                       ) -> tuple[int, int]:
    """Per-object detection accuracy against ``detector_batch`` targets,
    the megadetector gate's criterion: a true object is hit when a decoded
    detection above ``score_floor`` lands within 1.5 strides of its centre
    with the right class (the best-scoring such detection), and, with
    ``wh_rel_tolerance``, its box extent within that relative error.
    Returns ``(hits, total_objects)``."""
    hits = total = 0
    for b in range(len(targets["mask"])):
        centers = np.argwhere(targets["mask"][b, :, :, 0] > 0)
        boxes = np.asarray(out["boxes"][b])
        classes = np.asarray(out["classes"][b])
        scores = np.asarray(out["scores"][b])
        for iy, ix in centers:
            total += 1
            true_cls = int(np.argmax(targets["heatmap"][b, iy, ix]))
            cy, cx = (iy + 0.5) * STRIDE, (ix + 0.5) * STRIDE
            det_cy = (boxes[:, 0] + boxes[:, 2]) / 2
            det_cx = (boxes[:, 1] + boxes[:, 3]) / 2
            near = ((np.abs(det_cy - cy) < 1.5 * STRIDE)
                    & (np.abs(det_cx - cx) < 1.5 * STRIDE)
                    & (scores > score_floor))
            if not near.any():
                continue
            best = np.flatnonzero(near)[np.argmax(scores[near])]
            if int(classes[best]) != true_cls:
                continue
            if wh_rel_tolerance is not None:
                true_h, true_w = targets["wh"][b, iy, ix] * STRIDE
                det_h = boxes[best, 2] - boxes[best, 0]
                det_w = boxes[best, 3] - boxes[best, 1]
                if (abs(det_h - true_h) > wh_rel_tolerance * true_h
                        or abs(det_w - true_w) > wh_rel_tolerance * true_w):
                    continue
            hits += 1
    return hits, total


def centernet_loss(outputs: dict, t: dict) -> torch.Tensor:
    """CenterNet objective: penalty-reduced focal loss on the heatmap plus
    masked L1 on size and offset at object centres, in float32."""
    heat = torch.sigmoid(outputs["heatmap"].float())
    pos = (t["heatmap"] >= 0.999).float()
    neg_w = torch.pow(1.0 - t["heatmap"], 4.0)
    eps = 1e-6
    pos_l = -torch.log(heat + eps) * torch.pow(1.0 - heat, 2.0) * pos
    neg_l = (-torch.log(1.0 - heat + eps) * torch.pow(heat, 2.0)
             * neg_w * (1.0 - pos))
    n_pos = torch.clamp(pos.sum(), min=1.0)
    l_heat = (pos_l.sum() + neg_l.sum()) / n_pos
    l_wh = ((outputs["wh"] - t["wh"]).abs() * t["mask"]).sum() / n_pos
    l_off = ((outputs["offset"] - t["offset"]).abs() * t["mask"]).sum() / n_pos
    return l_heat + 0.1 * l_wh + l_off


def longcontext_batch(rng: np.random.Generator, batch: int, seq_len: int,
                      vocab_size: int, num_classes: int = 16):
    """Marker-token classification: sequences of uniform-random background
    ids with ~3% of positions overwritten by the label class's marker id
    (the top ``num_classes`` ids of the vocab). The JAX package's draws, in
    its order, so a seed gives the same arrays."""
    markers = max(4, seq_len // 32)
    toks = rng.integers(0, vocab_size - num_classes, (batch, seq_len))
    labels = rng.integers(0, num_classes, (batch,))
    for i in range(batch):
        pos = rng.choice(seq_len, size=markers, replace=False)
        toks[i, pos] = vocab_size - num_classes + labels[i]
    return toks.astype(np.int32), labels.astype(np.int32)


def _eval_marker_task(model, seq_len: int, vocab_size: int,
                      num_classes: int, seed: int, rounds: int = 4,
                      batch: int = 16) -> float:
    """Held-out accuracy on the marker task: ``rounds`` batches drawn from
    seed + 1, as the JAX package draws them (64 sequences by default), on
    the model's device."""
    device = next(model.parameters()).device
    eval_rng = np.random.default_rng(seed + 1)
    hits = total = 0
    with torch.inference_mode():
        for _ in range(rounds):
            toks, lab = longcontext_batch(eval_rng, batch, seq_len,
                                          vocab_size, num_classes)
            logits = model(torch.from_numpy(toks).to(device))
            hits += int((logits.argmax(-1).cpu().numpy() == lab).sum())
            total += len(lab)
    return hits / total


def resolve_train_attention(attention: str, device=None) -> str:
    """``train-auto`` -> the training attention for the device: the
    differentiable flash kernels on ``cuda`` (no S x S score matrix in
    either pass), plain materialised ``full`` attention on the CPU. Any
    explicit strategy passes through."""
    if attention != "train-auto":
        return attention
    resolved = "flash" if resolve_device(device).type == "cuda" else "full"
    log.info("train-auto attention resolved to %r", resolved)
    return resolved


def _train(model, name: str, steps: int, next_batch, loss_fn, lr: float,
           device, log_every: int = 25) -> dict:
    """``steps`` AdamW steps of ``model`` on ``next_batch()``'s (inputs,
    targets), the model left in eval mode; returns the run's record:
    ``losses`` and ``phases_ms`` per step (forward, backward, optimizer),
    ``loop_seconds`` of the step loop and ``data_seconds`` of it spent
    drawing batches, on the host clock, and ``peak_bytes`` of device
    memory (0 on the CPU)."""
    from .step import Trainer, adamw

    tr = Trainer(model, loss_fn,
                 optimizer=lambda p: adamw(p, lr, weight_decay=1e-5),
                 device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, phases, data_seconds = [], [], 0.0
    t0 = time.perf_counter()
    for step in range(steps):
        t = time.perf_counter()
        inputs, targets = next_batch()
        data_seconds += time.perf_counter() - t
        loss, ms = tr.train_step_phases(inputs, targets)
        losses.append(loss)
        phases.append(ms)
        if step % log_every == 0:
            log.info("%s step %d loss %.4f", name, step, loss)
    loop_seconds = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    model.eval()
    return {"losses": losses, "phases_ms": phases,
            "loop_seconds": loop_seconds, "data_seconds": data_seconds,
            "peak_bytes": peak}


def _train_marker_task(model, name: str, steps: int, batch: int,
                       seq_len: int, vocab_size: int, num_classes: int,
                       seed: int, lr: float, device) -> dict:
    """``_train`` on marker batches drawn from ``seed``."""
    from .step import cross_entropy_loss

    rng = np.random.default_rng(seed)
    return _train(model, name, steps,
                  lambda: longcontext_batch(rng, batch, seq_len, vocab_size,
                                            num_classes),
                  cross_entropy_loss, lr, device)


def _predict(model, images: np.ndarray) -> torch.Tensor:
    """``model`` on float32 NHWC ``images``, on the model's device."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        return model(torch.from_numpy(np.ascontiguousarray(images)).to(
            device))


def _state_dict(model) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _train_landcover(steps: int = 120, tile: int = 64, batch: int = 8,
                     seed: int = 0, widths=(64, 128, 256, 512),
                     lr: float = 1e-3, device=None) -> tuple:
    """The trained UNet and ``train_landcover``'s result."""
    from ..models import create_unet
    from ..models.unet import NUM_CLASSES
    from .step import segmentation_loss

    device = resolve_device(device)
    model = create_unet(generator=torch.Generator().manual_seed(seed),
                        widths=tuple(widths), param_dtype=torch.float32,
                        device=device)
    rng = np.random.default_rng(seed)
    record = _train(model, "landcover", steps,
                    lambda: landcover_batch(rng, batch, tile),
                    segmentation_loss, lr, device, log_every=20)
    img, lab = landcover_batch(np.random.default_rng(seed + 1), batch, tile)
    pred = _predict(model, img).argmax(-1).cpu().numpy()
    acc = float((pred == lab).mean())
    log.info("landcover eval pixel-acc %.3f", acc)
    return model, {"state_dict": _state_dict(model),
                   "eval": {"pixel_accuracy": round(acc, 4)},
                   "family": "unet",
                   "kwargs": {"widths": list(widths),
                              "num_classes": NUM_CLASSES},
                   "batch": batch, **record}


def train_landcover(steps: int = 120, tile: int = 64, batch: int = 8,
                    seed: int = 0, widths=(64, 128, 256, 512),
                    lr: float = 1e-3, device=None) -> dict:
    """UNet on the Voronoi land-class task, per-pixel cross entropy, eval
    on ``seed + 1``'s batch. ``kwargs`` records the servable kwargs the
    checkpoint restores into (widths, num_classes)."""
    return _train_landcover(steps, tile, batch, seed, widths, lr, device)[1]


def train_landcover128(steps: int = 120, **kw) -> dict:
    """``train_landcover``, evaluated at the 128 px tile it is served at
    (the UNet is fully convolutional), on the JAX package's eval batch."""
    model, result = _train_landcover(steps, **kw)
    img, lab = landcover_batch(np.random.default_rng(1), 8, 128)
    pred = _predict(model, img).argmax(-1).cpu().numpy()
    acc = float((pred == lab).mean())
    log.info("landcover128 eval pixel-acc %.3f (at the 128 serving tile)",
             acc)
    result["eval"] = {"pixel_accuracy_128": round(acc, 4)}
    result["kwargs"]["tile"] = 128
    return result


def train_megadetector(steps: int = 150, image_size: int = 128,
                       batch: int = 8, seed: int = 0,
                       widths=(64, 128, 256), device=None) -> dict:
    """CenterNet on the coloured-shapes task (AdamW 5e-4); eval =
    ``detection_accuracy`` of the serving decode over 4 batches from
    ``seed + 1`` (about 48 objects: one batch's dozen swings the gate on
    numerics alone). ``kwargs`` carries ``image_size``: the detector serves
    at the size it trained at."""
    return train_megadetector_on(
        detector_batches(seed, batch, image_size, steps), steps,
        image_size, batch, seed, widths, device)


def train_megadetector_on(batches, steps: int = 150, image_size: int = 128,
                          batch: int = 8, seed: int = 0,
                          widths=(64, 128, 256), device=None) -> dict:
    """``train_megadetector`` on the training batches ``batches`` (an
    iterator): its own are ``detector_batches(seed, batch, image_size,
    steps)``, which a caller may draw ahead elsewhere, so that the host's
    512 px scenes need not hold up the steps."""
    from ..models import create_detector, decode_detections

    device = resolve_device(device)
    model = create_detector(generator=torch.Generator().manual_seed(seed),
                            widths=tuple(widths), param_dtype=torch.float32,
                            device=device)
    record = _train(model, "megadetector", steps, lambda: next(batches),
                    centernet_loss, 5e-4, device)
    eval_rng = np.random.default_rng(seed + 1)
    hits = total = 0
    for _ in range(4):
        img, targets = detector_batch(eval_rng, batch, image_size)
        with torch.inference_mode():
            out = decode_detections(_predict(model, img))
        h, t = detection_accuracy({k: v.cpu().numpy()
                                   for k, v in out.items()}, targets)
        hits += h
        total += t
    acc = hits / max(total, 1)
    log.info("megadetector eval detection-acc %.3f (%d/%d)", acc, hits,
             total)
    return {"state_dict": _state_dict(model),
            "eval": {"detection_accuracy": round(acc, 4)},
            "eval_objects": {"hits": hits, "total": total},
            "family": "detector",
            "kwargs": {"widths": list(widths), "image_size": image_size},
            "batch": batch, **record}


def _train_resnet(name: str, next_batch, steps: int, image_size: int,
                  seed: int, stage_sizes, width: int, num_classes: int,
                  device) -> tuple:
    from ..models import create_resnet
    from .step import cross_entropy_loss

    device = resolve_device(device)
    model = create_resnet(generator=torch.Generator().manual_seed(seed),
                          stage_sizes=tuple(stage_sizes),
                          num_classes=num_classes, width=width,
                          param_dtype=torch.float32, device=device)
    record = _train(model, name, steps, next_batch, cross_entropy_loss,
                    1e-3, device, log_every=20)
    return model, record


def train_species(steps: int = 80, image_size: int = 64, batch: int = 16,
                  seed: int = 0, stage_sizes=(2, 2, 2), width: int = 32,
                  num_classes: int = 8, device=None) -> dict:
    """ResNet on the coat-pattern task (AdamW 1e-3; the running statistics
    stay as initialised), eval on 32 images from ``seed + 1``. ``kwargs``
    carries ``image_size``: BatchNorm statistics and the receptive field do
    not transfer across sizes, so the model serves at its trained size."""
    rng = np.random.default_rng(seed)
    model, record = _train_resnet(
        "species", lambda: species_batch(rng, batch, image_size), steps,
        image_size, seed, stage_sizes, width, num_classes, device)
    img, lab = species_batch(np.random.default_rng(seed + 1), 32, image_size)
    acc = float((_predict(model, img).argmax(-1).cpu().numpy()
                 == lab).mean())
    log.info("species eval acc %.3f", acc)
    return {"state_dict": _state_dict(model),
            "eval": {"accuracy": round(acc, 4)},
            "family": "resnet",
            "kwargs": {"stage_sizes": list(stage_sizes), "width": width,
                       "num_classes": num_classes, "image_size": image_size,
                       "labels": SPECIES_LABELS},
            "batch": batch, **record}


def train_species_fine(steps: int = 250, image_size: int = 64,
                       batch: int = 16, seed: int = 0,
                       stage_sizes=(2, 2, 2), width: int = 32,
                       device=None) -> dict:
    """``train_species``'s ResNet and recipe on the fine-texture task; eval
    on 128 images from ``seed + 1`` (4 batches of 32), expected below
    1.0."""
    rng = np.random.default_rng(seed)
    model, record = _train_resnet(
        "species_fine", lambda: species_fine_batch(rng, batch, image_size),
        steps, image_size, seed, stage_sizes, width, 8, device)
    eval_rng = np.random.default_rng(seed + 1)
    hits = total = 0
    for _ in range(4):
        img, lab = species_fine_batch(eval_rng, 32, image_size)
        hits += int((_predict(model, img).argmax(-1).cpu().numpy()
                     == lab).sum())
        total += len(lab)
    acc = hits / total
    log.info("species_fine eval acc %.3f", acc)
    return {"state_dict": _state_dict(model),
            "eval": {"accuracy": round(acc, 4)},
            "family": "resnet",
            "kwargs": {"stage_sizes": list(stage_sizes), "width": width,
                       "num_classes": 8, "image_size": image_size,
                       "labels": SPECIES_FINE_LABELS},
            "batch": batch, **record}


def train_longcontext(steps: int = 200, seq_len: int = 4096, batch: int = 8,
                      seed: int = 0, dim: int = 256, depth: int = 4,
                      heads: int = 2, vocab_size: int = 32768,
                      num_classes: int = 16, attention: str = "train-auto",
                      serve_attention: str = "flash", lr: float = 1e-3,
                      device=None) -> dict:
    """SeqFormer (token mode) on the marker task at the serving geometry:
    seq_len and vocab are baked into the parameter tree (pos_emb, Embed),
    so the trained shape is the serving shape. The body computes in
    bfloat16 on float32 masters. Returns the float32 ``state_dict``, the
    ``eval`` accuracy, ``family``/``kwargs`` for the manifest, and the run's
    record: ``losses`` and ``phases_ms`` per step (forward, backward,
    optimizer), ``loop_seconds`` of the step loop on the host clock and
    ``peak_bytes`` of device memory (0 on the CPU)."""
    from ..models import create_seqformer

    device = resolve_device(device)
    attention = resolve_train_attention(attention, device)
    model = create_seqformer(
        generator=torch.Generator().manual_seed(seed), seq_len=seq_len,
        input_dim=64, dim=dim, depth=depth, heads=heads,
        num_classes=num_classes, attention=attention, vocab_size=vocab_size,
        param_dtype=torch.float32, device=device)
    record = _train_marker_task(model, "longcontext", steps, batch,
                                seq_len, vocab_size, num_classes, seed, lr,
                                device)
    acc = _eval_marker_task(model, seq_len, vocab_size, num_classes, seed)
    log.info("longcontext eval acc %.3f", acc)
    return {"state_dict": _state_dict(model),
            "eval": {"accuracy": round(acc, 4)},
            "family": "seqformer",
            # Everything serving needs to rebuild the exact tree.
            "kwargs": {"seq_len": seq_len, "input_dim": 64, "dim": dim,
                       "depth": depth, "heads": heads,
                       "num_classes": num_classes, "vocab_size": vocab_size,
                       "attention": serve_attention},
            "batch": batch, **record}


def train_moe(steps: int = 200, seq_len: int = 1024, batch: int = 16,
              seed: int = 0, dim: int = 128, depth: int = 2, heads: int = 1,
              num_experts: int = 8, vocab_size: int = 8192,
              num_classes: int = 16, capacity_factor: float = 1.25,
              attention: str = "train-auto", serve_attention: str = "flash",
              lr: float = 1e-3, device=None) -> dict:
    """MoEClassifier (token mode) on the longcontext marker task. It
    trains with dense dispatch (every expert on every token) and evaluates
    with the capacity dispatch it will serve, on the same modules (their
    ``dispatch`` switched, no re-init): overflow drops make capacity the
    stricter eval. float32 masters, optax's ``adamw(lr,
    weight_decay=1e-5)``. Returns what ``train_longcontext`` returns, with
    JAX's ``kwargs`` (capacity dispatch)."""
    from ..models import create_moe

    device = resolve_device(device)
    attention = resolve_train_attention(attention, device)
    model = create_moe(
        generator=torch.Generator().manual_seed(seed), seq_len=seq_len,
        input_dim=64, dim=dim, depth=depth, heads=heads,
        num_experts=num_experts, num_classes=num_classes,
        attention=attention, dispatch="dense", vocab_size=vocab_size,
        param_dtype=torch.float32, device=device)
    record = _train_marker_task(model, "moe", steps, batch, seq_len,
                                vocab_size, num_classes, seed, lr, device)
    model.set_dispatch("capacity", capacity_factor)
    acc = _eval_marker_task(model, seq_len, vocab_size, num_classes, seed)
    log.info("moe eval (capacity dispatch) acc %.3f", acc)
    return {"state_dict": _state_dict(model),
            "eval": {"accuracy": round(acc, 4)},
            "family": "moe",
            "kwargs": {"seq_len": seq_len, "input_dim": 64, "dim": dim,
                       "depth": depth, "heads": heads,
                       "num_experts": num_experts,
                       "num_classes": num_classes, "vocab_size": vocab_size,
                       "dispatch": "capacity",
                       "capacity_factor": capacity_factor,
                       "attention": serve_attention},
            "batch": batch, **record}


RECIPES = {
    "landcover": train_landcover,
    "landcover128": train_landcover128,
    "megadetector": train_megadetector,
    "species": train_species,
    "species_fine": train_species_fine,
    "longcontext": train_longcontext,
    "moe": train_moe,
}

# Eval floor every produced checkpoint must clear (chance: landcover 0.25,
# megadetector about 0.33, species 0.125, the marker task 1/16).
MIN_EVAL = 0.85


#: Each family's state_dict -> its flax tree (what ``save_npz`` writes and
#: JAX's ``load_params`` and the port's ``reload_params`` read). The
#: streaming LM has no training recipe, as in JAX; its entry saves seed or
#: converted weights.
TO_FLAX = {"unet": unet_flax_from_state_dict,
           "detector": detector_flax_from_state_dict,
           "resnet": resnet_flax_from_state_dict,
           "seqformer": seqformer_flax_from_state_dict,
           "moe": moe_flax_from_state_dict,
           "seqformer-lm": seqformer_lm_flax_from_state_dict}


def make_checkpoint(name: str, out_dir: str, min_eval: float = MIN_EVAL,
                    result: dict | None = None, **overrides) -> dict:
    """Train one recipe (or take its already trained ``result``), refuse it
    below ``min_eval``, save ``out_dir/<name>.npz`` and record it in
    ``out_dir/MANIFEST.json``; returns the manifest entry (family, kwargs,
    eval, path)."""
    if result is None:
        result = RECIPES[name](**overrides)
    (metric_name, value), = result["eval"].items()
    if value < min_eval:
        raise AssertionError(
            f"{name}: {metric_name}={value} below {min_eval} — training did "
            "not converge; refusing to ship untrained weights")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(out_dir, f"{name}.npz"))
    save_npz(TO_FLAX[result["family"]](result["state_dict"]), path)
    entry = {"family": result["family"], "kwargs": result["kwargs"],
             "eval": result["eval"], "path": path}
    manifest_path = os.path.join(out_dir, "MANIFEST.json")
    manifest = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
    manifest[name] = entry
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)
    log.info("saved %s -> %s (%s=%.3f)", name, path, metric_name, value)
    return entry


#: Full (not --fast) runs: the JAX package's table, the deployed serving
#: sizes of deploy/specs/models.json, since species and megadetector serve
#: at their trained size only (300 detector steps at 512: 150 land at the
#: gate's edge); and, beyond JAX's table, species_fine at 500 steps: its
#: 250-step default lands on both sides of the gate with the numerics
#: (the JAX package's records: 0.883 on a TPU, 0.773 on the CPU; the
#: port: 0.703 on an H100, 0.63-0.73 on the CPU); 500 steps: JAX 0.914
#: on the CPU, the port 0.99-1.0 on the CPU.
FULL_OVERRIDES = {"megadetector": {"image_size": 512, "steps": 300},
                  "species": {"image_size": 224, "steps": 120},
                  "species_fine": {"steps": 500}}

#: --fast: the JAX package's small CI table.
FAST = {"landcover": {"steps": 60}, "landcover128": {"steps": 60},
        "megadetector": {"steps": 80},
        "species": {"steps": 65}, "species_fine": {"steps": 90},
        "longcontext": {"steps": 160, "seq_len": 256, "dim": 32, "depth": 2,
                        "heads": 2, "vocab_size": 512, "batch": 16},
        "moe": {"steps": 160, "seq_len": 128, "dim": 32, "heads": 1,
                "num_experts": 4, "vocab_size": 256, "batch": 16}}


def train_full(name: str, out_dir: str, **overrides) -> dict:
    """Train ``name`` at its deployed size (``FULL_OVERRIDES``) and record
    it in ``out_dir/MANIFEST.json``, the one entry point for a servable
    checkpoint outside CI (the serving side reads ``image_size`` from the
    manifest). ``overrides`` (``device``, ``steps``, ``min_eval``, ...) go
    over the table's; returns the manifest entry."""
    return make_checkpoint(name, out_dir,
                           **{**FULL_OVERRIDES.get(name, {}), **overrides})


def main(argv=None) -> None:
    import argparse

    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="checkpoints")
    parser.add_argument("--only", nargs="+", choices=sorted(RECIPES),
                        default=sorted(RECIPES))
    parser.add_argument("--fast", action="store_true",
                        help="the small CI geometry (default: the serving "
                             "sizes)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    evals = {}
    table = FAST if args.fast else FULL_OVERRIDES
    for name in args.only:
        overrides = table.get(name, {})
        evals[name] = make_checkpoint(name, args.out, device=args.device,
                                      **overrides)["eval"]
    print(json.dumps(evals))


if __name__ == "__main__":
    main()
