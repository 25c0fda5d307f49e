"""Land-cover semantic segmentation UNet — counterpart of
``ai4e_tpu/models/unet.py``, with the same arithmetic:

- stride-2 downsampling convs pad like flax's ``SAME``, which is asymmetric:
  an even input pads (0, 1), not (1, 1), on each spatial axis;
- ``GroupNorm(num_groups=min(32, features))`` with flax's ``epsilon=1e-6``
  (torch's default is 1e-5), statistics and normalisation in float32, the
  result cast back to the body dtype;
- ``gelu`` is the tanh approximation (flax's ``nn.gelu`` default):
  ``F.gelu(approximate="tanh")`` in float32, JAX's own op chain in
  bfloat16 (``layers.gelu``, shared with the SeqFormer);
- the body runs in bfloat16 and the head 1x1 conv in float32 with a bias;
- the decoder upsamples with nearest-neighbour on half-pixel centres, as
  ``jax.image.resize(..., "nearest")`` does (``"nearest-exact"``; at exactly
  2x it equals plain ``"nearest"``), then a 1x1 conv, then concatenates
  ``[up, skip]`` on channels.

The public functions keep the JAX package's NHWC layout. Inside,
``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is a ``channels_last``
NCHW tensor with no copy, and the head's output permuted back is NHWC in
memory, so the argmax kernel reads it as it lies (``.contiguous()`` there
copies only if a layer handed back another layout).

Flax keeps float32 params and casts them to bfloat16 on every call. The
served build (``param_dtype`` None) casts the body convs' weights once when
the model is built, which gives the same values; a training build
(``param_dtype=torch.float32``) keeps float32 masters, which each
``layers.Conv2d`` casts on every call, so AdamW's small steps are not
rounded away. GroupNorm params and the head stay float32 either way, and
GroupNorm's float32 statistics and the bf16 gelu's VJP (``layers.gelu``)
carry JAX's rounding under autograd too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import Conv2d, gelu

NUM_CLASSES = 4
TILE = 256  # default tile edge (the land-cover API's unit of work)
GROUPNORM_EPS = 1e-6  # flax's default


def same_pads(size: int, kernel: int = 3, stride: int = 2) -> tuple[int, int]:
    """(low, high) padding of flax/XLA ``SAME`` on one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def same_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (built with ``padding=0``) with flax's ``SAME`` padding of
    its kernel and stride on ``x``'s spatial axes."""
    (k, _), (s, _) = conv.kernel_size, conv.stride
    (top, bottom), (left, right) = (same_pads(x.shape[2], k, s),
                                    same_pads(x.shape[3], k, s))
    return conv(F.pad(x, (left, right, top, bottom)))


class ConvBlock(nn.Module):
    """Two (3x3 conv -> GroupNorm -> gelu) stages; the first conv takes
    ``stride`` with flax's ``SAME`` padding (the detector's stages
    downsample there)."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.convs = nn.ModuleList([
            Conv2d(in_features, features, 3, stride=stride,
                   padding=1 if stride == 1 else 0, bias=False),
            Conv2d(features, features, 3, padding=1, bias=False)])
        self.norms = nn.ModuleList([
            nn.GroupNorm(min(32, features), features, eps=GROUPNORM_EPS)
            for _ in range(2)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in zip(self.convs, self.norms):
            x = conv(x) if conv.stride == (1, 1) else same_conv(conv, x)
            # Statistics and affine in float32, as flax's GroupNorm does, on
            # an NCHW-contiguous copy: ATen's CPU GroupNorm on a
            # channels_last input splits its reduction by batch and thread,
            # so a row's answer would depend on the batch it rides in
            # (ROADMAP C8). The result goes back to channels_last for gelu
            # and the next convolution.
            y = F.group_norm(
                x.to(torch.float32, memory_format=torch.contiguous_format),
                norm.num_groups, norm.weight, norm.bias, norm.eps)
            x = gelu(y.to(x.dtype, memory_format=torch.channels_last))
        return x


class UNet(nn.Module):
    """Encoder-decoder with skip connections: (B, H, W, 3) float32 in,
    (B, H, W, num_classes) float32 logits out. The body computes in
    ``dtype``; its conv weights are held in ``param_dtype`` (default:
    ``dtype``)."""

    def __init__(self, num_classes: int = NUM_CLASSES,
                 widths: tuple = (64, 128, 256, 512),
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        widths = tuple(widths)
        self.dtype = dtype
        self.encoder = nn.ModuleList()
        cin = in_channels
        for w in widths:
            self.encoder.append(ConvBlock(cin, w))
            cin = w
        self.down = nn.ModuleList(
            Conv2d(w, w, 3, stride=2, padding=0, bias=False)
            for w in widths[:-1])
        self.up = nn.ModuleList()
        self.decoder = nn.ModuleList()
        for w in reversed(widths[:-1]):
            self.up.append(Conv2d(cin, w, 1, bias=False))
            self.decoder.append(ConvBlock(2 * w, w))
            cin = w
        self.head = Conv2d(widths[0], num_classes, 1, bias=True)
        for body in (self.encoder, self.down, self.up, self.decoder):
            for m in body.modules():
                if isinstance(m, nn.Conv2d):
                    m.to(param_dtype or dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        skips = []
        for i, block in enumerate(self.encoder):
            x = block(x)
            if i < len(self.down):
                skips.append(x)
                x = same_conv(self.down[i], x)
        for up, block, skip in zip(self.up, self.decoder, reversed(skips)):
            x = F.interpolate(x, size=skip.shape[2:], mode="nearest-exact")
            x = torch.cat([up(x), skip], dim=1)
            x = block(x)
        logits = self.head(x.float())
        return logits.permute(0, 2, 3, 1).contiguous()  # NHWC


def init_flax_like_(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's default init: convs ``lecun_normal`` (truncated normal, fan-in
    scaled), biases zero, GroupNorm scale one and bias zero."""
    stddev_fix = 0.87962566103423978  # std of a unit normal cut at +-2
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / stddev_fix
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def create_unet(generator: torch.Generator | None = None,
                num_classes: int = NUM_CLASSES,
                widths: tuple = (64, 128, 256, 512),
                dtype: torch.dtype = torch.bfloat16, device=None,
                param_dtype: torch.dtype | None = None) -> UNet:
    """A UNet with flax-like random weights drawn on the CPU from
    ``generator`` (default: seed 0), then moved to ``device`` (default
    ``cuda``), so a seed gives the same weights on every device. Train
    with ``param_dtype=torch.float32``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = UNet(num_classes=num_classes, widths=widths, dtype=dtype,
                 param_dtype=param_dtype)
    init_flax_like_(model, generator)
    return model.to(device=device, memory_format=torch.channels_last).eval()


def segment_logits_to_classes(logits: torch.Tensor) -> torch.Tensor:
    """Per-pixel argmax -> uint8 class map."""
    return torch.argmax(logits, dim=-1).to(torch.uint8)
