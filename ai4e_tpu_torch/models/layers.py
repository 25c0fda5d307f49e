"""Layers shared by the port's models, each with flax's arithmetic:

- ``gelu``: ``nn.gelu``, the tanh approximation, rounded as JAX rounds it;
- ``LayerNorm``: ``nn.LayerNorm()`` with its defaults: epsilon 1e-6 (torch's
  default is 1e-5), statistics in float32 with the variance taken as
  E[x^2] - E[x]^2, and a float32 result whatever the input's type;
- ``Dense``: ``nn.Dense(dtype=...)``: the input and the weight in the
  layer's type, the product rounded to it, then the bias added in it
  (``F.linear(x, w, b)`` would add the bias before rounding on cuBLAS).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LAYERNORM_EPS = 1e-6  # flax's default


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation.

    In float32 that is ``F.gelu(approximate="tanh")``. In bfloat16,
    ``jax.nn.gelu`` rounds its constants sqrt(2/pi) and 0.044715 to
    bfloat16 and rounds after every op; ``F.gelu`` rounds once with exact
    constants, which moves the served argmax on about 0.3% more pixels.
    The chain below repeats JAX's ops in its order, in place on one fresh
    tensor, and gives its values bit for bit (ten elementwise passes where
    ``F.gelu`` takes one: a fused kernel is later work)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    k = float(torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype))
    a = float(torch.tensor(0.044715, dtype=x.dtype))
    y = x * x
    return (y.mul_(x).mul_(a).add_(x).mul_(k).tanh_().add_(1.0).mul_(0.5)
            .mul_(x))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm()`` over the last axis; float32 params and a
    float32 result."""

    def __init__(self, features: int, eps: float = LAYERNORM_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min_(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class Dense(nn.Linear):
    """flax ``nn.Dense`` computing in the dtype its weight is built in."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.weight.dtype), self.weight)
        return y if self.bias is None else y + self.bias
