"""Layers shared by the port's models, each with flax's arithmetic:

- ``gelu``: ``nn.gelu``, the tanh approximation, rounded as JAX rounds it;
- ``LayerNorm``: ``nn.LayerNorm()`` with its defaults: epsilon 1e-6 (torch's
  default is 1e-5), statistics in float32 with the variance taken as
  E[x^2] - E[x]^2, and a float32 result whatever the input's type;
  ``LayerNorm(dtype=...)`` is ``nn.LayerNorm(dtype=...)``: the same
  float32 arithmetic, the result cast to ``dtype`` once;
- ``Dense``: ``nn.Dense(dtype=...)``: the input and the weight in the
  layer's type, the product rounded to it, then the bias added in it
  (``F.linear(x, w, b)`` would add the bias before rounding on cuBLAS);
- ``Embed``: ``nn.Embed(dtype=...)``: the table cast to the layer's type
  before the gather;
- ``Conv2d``: ``nn.Conv(dtype=...)`` for the image models: the weight and
  bias cast to the input's type on each call (the models cast their input
  to the body type first).

``Dense`` and ``Embed`` take a ``param_dtype``, as flax's modules do (the
image models take one for their ``Conv2d`` layers). By
default it is the compute ``dtype``: a served bfloat16 layer holds bfloat16
weights, rounded once when loaded, which gives the values of flax's cast on
every call. For training, ``param_dtype=torch.float32`` keeps float32
masters and casts them on every call, so the optimizer updates float32
values (an AdamW step of 1e-3 on a bfloat16 weight would round away). The
state_dict keys are the same either way.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LAYERNORM_EPS = 1e-6  # flax's default
TRUNCATED_STD = 0.87962566103423978  # std of a unit normal cut at +-2


def flax_normal_(param: torch.Tensor, std: float,
                 generator: torch.Generator, truncated: bool) -> None:
    """Fill ``param`` from ``generator`` as flax's initializers draw: a
    normal of ``std``, cut at +-2 std when ``truncated`` (flax's
    ``lecun_normal`` passes std / ``TRUNCATED_STD``). Drawn in float32 on
    the CPU, then copied into ``param`` whatever its type and device."""
    w = torch.empty(param.shape, dtype=torch.float32)
    if truncated:
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
    else:
        nn.init.normal_(w, std=std, generator=generator)
    with torch.no_grad():
        param.copy_(w)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation.

    In float32 that is ``F.gelu(approximate="tanh")``. In bfloat16,
    ``jax.nn.gelu`` rounds its constants sqrt(2/pi) and 0.044715 to
    bfloat16 and rounds after every op; ``F.gelu`` rounds once with exact
    constants, which moves the served argmax on about 0.3% more pixels.
    The chain below repeats JAX's ops in its order, in place on one fresh
    tensor, and gives its values bit for bit (ten elementwise passes where
    ``F.gelu`` takes one: a fused kernel is later work). Where autograd
    records, ``_GeluBF16`` runs the same chain and JAX's own VJP of it."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    if torch.is_grad_enabled() and x.requires_grad:
        return _GeluBF16.apply(x)
    k, a = _gelu_constants(x.dtype)
    y = x * x
    return (y.mul_(x).mul_(a).add_(x).mul_(k).tanh_().add_(1.0).mul_(0.5)
            .mul_(x))


def _gelu_constants(dtype: torch.dtype) -> tuple[float, float]:
    """sqrt(2/pi) and 0.044715 rounded to ``dtype``, as ``jax.nn.gelu``
    rounds them."""
    return (float(torch.tensor(math.sqrt(2 / math.pi), dtype=dtype)),
            float(torch.tensor(0.044715, dtype=dtype)))


class _GeluBF16(torch.autograd.Function):
    """``gelu`` on a low-precision input under autograd. The forward is the
    in-place chain, keeping x and t = tanh(k * (x + a * x^3)); the backward
    is the VJP ``jax.vjp(jax.nn.gelu, x)`` traces, op for op, each rounded
    to the input's type:

        g * 0.5 * (1 + t) + s + (s * a) * (3 * x^2),
        s = k * (p + p * t),  p = 0.5 * (x * g) * (1 - t),

    which gives ``jax.grad``'s values bit for bit (a backward through the
    chain's own ops would not: it adds x*x's two halves and differentiates
    tanh as torch does). It saves two tensors where the out-of-place chain
    would save nine."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        k, a = _gelu_constants(x.dtype)
        t = x * x
        t.mul_(x).mul_(a).add_(x).mul_(k).tanh_()
        ctx.save_for_backward(x, t)
        return (t + 1.0).mul_(0.5).mul_(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        x, t = ctx.saved_tensors
        k, a = _gelu_constants(x.dtype)
        e = (x * x).mul_(3.0)
        n = (t + 1.0).mul_(0.5).mul_(g)
        p = (x * g).mul_(0.5).mul_(1.0 - t)
        s = (p * t).add_(p).mul_(k)
        return n.add_(s).add_(s.mul_(a).mul_(e))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype)`` over the last axis: float32 params
    and arithmetic, the result in ``dtype`` (default float32, flax's
    result for ``nn.LayerNorm()`` on any input)."""

    def __init__(self, features: int, eps: float = LAYERNORM_EPS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min_(0.0)
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


class Dense(nn.Linear):
    """flax ``nn.Dense``: computes in ``dtype`` (default: the weight's
    type), with parameters held in ``param_dtype`` (default: ``dtype``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=param_dtype or dtype)
        self.dtype = dtype or self.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's type: the weight and bias are
    cast to it on each call, as flax casts ``param_dtype`` params to
    ``dtype``. A served model holds its weights in the body type, where the
    casts return the same tensors; a training build holds float32
    masters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Embed(nn.Embedding):
    """flax ``nn.Embed``: the table cast to ``dtype`` before the gather,
    held in ``param_dtype`` (default: ``dtype``)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 device=None, dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype | None = None):
        super().__init__(num_embeddings, embedding_dim, device=device,
                         dtype=param_dtype or dtype)
        self.dtype = dtype or self.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.embedding(x, self.weight.to(self.dtype))
