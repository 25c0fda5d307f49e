"""Bottleneck ResNet species classifier — counterpart of
``ai4e_tpu/models/resnet.py``, with the same arithmetic:

- the body runs in bfloat16, NHWC outside and ``channels_last`` NCHW
  inside (as the UNet does);
- the 7x7 stem conv pads an explicit (3, 3), which is symmetric;
- the stem's 3x3 stride-2 max-pool and each bottleneck's 3x3 stride-2 conv
  pad like flax's ``SAME``, which is asymmetric: an even input pads (0, 1),
  the pool with -inf;
- ``BatchNorm`` in inference mode (running statistics) follows flax's
  ``_normalize`` in float32, ``(x - mean) * (rsqrt(var + 1e-5) * scale) +
  bias``, then casts to bfloat16; its running statistics are float32
  buffers;
- each bottleneck's third BatchNorm starts with a zero scale, so a freshly
  initialised bottleneck is the identity on its shortcut;
- the pooled features are ``jnp.mean`` of a bfloat16 tensor: a float32
  mean rounded to bfloat16; the classifier ``Dense`` runs in float32 on
  them and returns float32 logits.

As the UNet, the served build casts the conv weights to bfloat16 once and a
training build (``param_dtype=torch.float32``) keeps float32 masters, cast
on every call. Training never updates the running statistics: they are
buffers, outside the optimizer and its weight decay, as the JAX package's
``freeze_batch_stats`` (``optax.set_to_zero`` on ``batch_stats``) leaves
them, and BatchNorm reads them in training as in serving.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import Conv2d
from .unet import same_conv, same_pads

BATCHNORM_EPS = 1e-5  # flax's default


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True)`` over the channel axis
    of an NCHW tensor: float32 params and running statistics, the result
    cast back to the input's type."""

    def __init__(self, features: int, eps: float = BATCHNORM_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = x.float() - self.running_mean[:, None, None]
        return (y * mul[:, None, None] + self.bias[:, None, None]).to(x.dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (``stride``) -> 1x1 (x4) with BatchNorm and relu; a
    projection (1x1 conv with ``stride`` + BatchNorm) on the shortcut when
    the shapes differ. ``convs``/``norms`` 0..2 are the body and 3 the
    projection, flax's ``Conv_k``/``BatchNorm_k``."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        convs = [Conv2d(in_features, features, 1, bias=False),
                 Conv2d(features, features, 3, stride=stride,
                        padding=1 if stride == 1 else 0, bias=False),
                 Conv2d(features, 4 * features, 1, bias=False)]
        if stride != 1 or in_features != 4 * features:
            convs.append(Conv2d(in_features, 4 * features, 1,
                                stride=stride, bias=False))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(
            BatchNorm(c.out_channels) for c in convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norms[0](self.convs[0](x)))
        conv = self.convs[1]
        y = conv(y) if conv.stride == (1, 1) else same_conv(conv, y)
        y = F.relu(self.norms[1](y))
        y = self.norms[2](self.convs[2](y))
        if len(self.convs) == 4:
            x = self.norms[3](self.convs[3](x))
        return F.relu(y + x)


def max_pool_same(x: torch.Tensor, kernel: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (s, s), "SAME")`` on an NCHW tensor: flax's
    asymmetric pads, filled with -inf."""
    (top, bottom), (left, right) = (same_pads(x.shape[2], kernel, stride),
                                    same_pads(x.shape[3], kernel, stride))
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


class ResNet(nn.Module):
    """(B, H, W, 3) float in, (B, num_classes) float32 logits out. The body
    computes in ``dtype``; its conv weights are held in ``param_dtype``
    (default: ``dtype``)."""

    def __init__(self, stage_sizes: tuple = (3, 4, 6, 3),
                 num_classes: int = 1000, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv2d(in_channels, width, 7, stride=2, padding=3,
                           bias=False)
        self.stem_norm = BatchNorm(width)
        blocks, cin = [], width
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                features = width * 2 ** i
                blocks.append(Bottleneck(cin, features,
                                         2 if i > 0 and j == 0 else 1))
                cin = 4 * features
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(param_dtype or dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.stem_norm(self.stem(x)))
        x = max_pool_same(x)
        for block in self.blocks:
            x = block(x)
        pooled = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.head(pooled.float())


def init_flax_like_(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's default init: conv and dense kernels ``lecun_normal``
    (truncated normal, fan-in scaled), biases zero, BatchNorm scale one
    (zero for each bottleneck's third) and bias zero, running mean zero and
    variance one."""
    stddev_fix = 0.87962566103423978  # std of a unit normal cut at +-2
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / stddev_fix
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        for m in model.modules():
            if isinstance(m, Bottleneck):
                m.norms[2].weight.zero_()


def create_resnet(generator: torch.Generator | None = None,
                  stage_sizes: tuple = (3, 4, 6, 3), num_classes: int = 1000,
                  width: int = 64, dtype: torch.dtype = torch.bfloat16,
                  device=None, param_dtype: torch.dtype | None = None
                  ) -> ResNet:
    """A ResNet with flax-like random weights drawn on the CPU from
    ``generator`` (default: seed 0), then moved to ``device`` (default
    ``cuda``), so a seed gives the same weights on every device. Train
    with ``param_dtype=torch.float32``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = ResNet(stage_sizes=tuple(stage_sizes), num_classes=num_classes,
                   width=width, dtype=dtype, param_dtype=param_dtype)
    init_flax_like_(model, generator)
    return model.to(device=device, memory_format=torch.channels_last).eval()
