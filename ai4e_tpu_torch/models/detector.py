"""Camera-trap animal detector (the MegaDetector slot) — counterpart of
``ai4e_tpu/models/detector.py``: an anchor-free center-point model
(CenterNet-style), a conv backbone of stride 8 feeding three dense heads
(center heatmap, box size, center offset), and a decode with static shapes
(``max_detections`` rows, a score mask instead of a variable count), so the
whole apply, decode included, is captured in the bucket's CUDA graph with
no host synchronisation.

The arithmetic is the JAX package's:

- each ``_Stage`` is the UNet's ``ConvBlock`` with its first conv at stride
  2 and flax's asymmetric ``SAME`` padding: conv -> GroupNorm(min(32, C),
  eps 1e-6, float32 statistics) -> bfloat16 ``gelu``, twice;
- the 3x3 feature conv runs in bfloat16 with its bias added after the
  product, in bfloat16, as flax adds it; then ``gelu``;
- the heads run in float32 over the features widened to float32; the
  heatmap's bias starts at -2.19;
- decode flattens the (B, h, w, c) heatmap in the reference's NHWC order,
  so ``index % c`` is the class: sigmoid, then the 3x3 stride-1 max-pool
  peak NMS (padding -inf, a peak where ``|pooled - heat| < 1e-6``), then
  the top ``max_detections``, then ``wh``/``offset`` gathered at each
  peak; non-finite scores become 0.

``torch.topk`` does not promise ``lax.top_k``'s order among equal scores,
so the picks are re-sorted by (score descending, flat index ascending),
``lax.top_k``'s order. Rows can then differ from the reference only where
equal scores straddle the cut: the -inf fill rows of a heatmap with fewer
than ``max_detections`` peaks, whose scores become 0 and which
postprocess drops.

A training build (``param_dtype=torch.float32``) keeps float32 masters
for the bfloat16 body, cast on every call, as the UNet's does.

Classes follow MegaDetector: animal / person / vehicle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import Conv2d, gelu
from .unet import ConvBlock, init_flax_like_

NUM_CLASSES = 3  # animal, person, vehicle
MAX_DETECTIONS = 64
HEATMAP_BIAS = -2.19
FEATURES = 256


class CenterNetDetector(nn.Module):
    """(B, H, W, 3) float in [0, 1] -> ``{"heatmap": (B, H/8, W/8, C),
    "wh": (..., 2), "offset": (..., 2)}`` float32, NHWC. The body's conv
    weights are held in ``param_dtype`` (default: ``dtype``)."""

    def __init__(self, num_classes: int = NUM_CLASSES,
                 widths: tuple = (64, 128, 256),
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        stages, cin = [], in_channels
        for w in widths:
            stages.append(ConvBlock(cin, w, stride=2))
            cin = w
        self.stages = nn.ModuleList(stages)
        self.feat = Conv2d(cin, FEATURES, 3, padding=1)
        self.heatmap = Conv2d(FEATURES, num_classes, 1)
        self.wh = Conv2d(FEATURES, 2, 1)
        self.offset = Conv2d(FEATURES, 2, 1)
        for m in (self.stages, self.feat):
            for conv in m.modules():
                if isinstance(conv, nn.Conv2d):
                    conv.to(param_dtype or dtype)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for stage in self.stages:
            x = stage(x)
        feat = F.conv2d(x, self.feat.weight.to(self.dtype), padding=1)
        feat = gelu(feat + self.feat.bias.to(self.dtype)[:, None, None])
        feat = feat.float()
        return {name: head(feat).permute(0, 2, 3, 1)
                for name, head in (("heatmap", self.heatmap), ("wh", self.wh),
                                   ("offset", self.offset))}


def _nms_heatmap(heat: torch.Tensor) -> torch.Tensor:
    """3x3 max-pool peak NMS on an NHWC heatmap: keep only local maxima
    (within 1e-6 of the window's max), -inf elsewhere."""
    nchw = F.pad(heat.permute(0, 3, 1, 2), (1, 1, 1, 1), value=float("-inf"))
    pooled = F.max_pool2d(nchw, 3, 1).permute(0, 2, 3, 1)
    return torch.where((pooled - heat).abs() < 1e-6, heat,
                       torch.full_like(heat, float("-inf")))


def decode_detections(outputs: dict, stride: int = 8,
                      max_detections: int = MAX_DETECTIONS) -> dict:
    """Heatmap -> a fixed-size detection set: ``max_detections`` rows
    always, invalid rows with score 0. Returns (B, K, 4) boxes ``[y0, x0,
    y1, x1]`` in input pixels, (B, K) scores and (B, K) int32 classes."""
    heat = _nms_heatmap(torch.sigmoid(outputs["heatmap"]))
    b, h, w, c = heat.shape
    flat = heat.reshape(b, h * w * c)
    scores, idx = torch.topk(flat, max_detections, dim=1)
    # lax.top_k's order among equal scores: the lower flat index first.
    idx, order = torch.sort(idx, dim=1)
    scores = torch.gather(scores, 1, order)
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    idx = torch.gather(idx, 1, order)
    cls = (idx % c).to(torch.int32)
    pix = idx // c
    row, col = pix // w, pix % w
    batch_ix = torch.arange(b, device=heat.device)[:, None]
    wh = outputs["wh"][batch_ix, row, col]          # (B, K, 2)
    offset = outputs["offset"][batch_ix, row, col]  # (B, K, 2)
    cy = (row.float() + offset[..., 0]) * stride
    cx = (col.float() + offset[..., 1]) * stride
    bh = wh[..., 0].abs() * stride
    bw = wh[..., 1].abs() * stride
    boxes = torch.stack([cy - bh / 2, cx - bw / 2, cy + bh / 2, cx + bw / 2],
                        dim=-1)
    scores = torch.where(torch.isfinite(scores), scores,
                         torch.zeros_like(scores))
    return {"boxes": boxes, "scores": scores, "classes": cls}


def create_detector(generator: torch.Generator | None = None,
                    num_classes: int = NUM_CLASSES,
                    widths: tuple = (64, 128, 256),
                    dtype: torch.dtype = torch.bfloat16,
                    device=None, param_dtype: torch.dtype | None = None
                    ) -> CenterNetDetector:
    """A detector with flax-like random weights drawn on the CPU from
    ``generator`` (default: seed 0; the heatmap's bias at -2.19), then
    moved to ``device`` (default ``cuda``). Train with
    ``param_dtype=torch.float32``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = CenterNetDetector(num_classes=num_classes, widths=tuple(widths),
                              dtype=dtype, param_dtype=param_dtype)
    init_flax_like_(model, generator)
    with torch.no_grad():
        model.heatmap.bias.fill_(HEATMAP_BIAS)
    return model.to(device=device, memory_format=torch.channels_last).eval()
