"""Vision Transformer species classifier — counterpart of
``ai4e_tpu/models/vit.py``, with the same arithmetic:

- the input is cast to bfloat16; the patch embedding is flax's ``nn.Conv``
  with kernel and stride ``patch`` and its default ``SAME`` padding
  (``unet.same_pads``: none at 224/16, asymmetric at other sizes). With the
  stride equal to the kernel, the padded image splits into non-overlapping
  patches, so the conv is one bfloat16 product of the flattened patches
  with the (patch, patch, 3) kernel, the bias added after it in bfloat16.
  cuDNN is not asked, so a CUDA graph's replay runs the same product as
  eager;
- ``pos_embed`` is float32 and cast to bfloat16 before the add;
- ``nn.LayerNorm(dtype=bf16)`` (``layers.LayerNorm(dtype=torch.bfloat16)``)
  normalises in float32 and returns bfloat16;
- attention: ``qkv`` without a bias, ``out`` with one; the scores are the
  bfloat16 product q.k^T, then scaled by D**-0.5 (rounded to bfloat16,
  as JAX casts a python scalar) in bfloat16, then
  ``jax.nn.softmax`` op by op in bfloat16 (``softmax_bf16``: max, the
  rounded difference, its rounded exp, the sum taken in float32 and
  rounded, the rounded quotient). It is plain attention, as in JAX: the
  flash kernel is not on this path;
- the MLP is Dense, ``layers.gelu`` (JAX's bfloat16 chain), Dense;
- pooling sums in float32 and returns bfloat16; the head is a float32
  Dense with a bias.

Tensor parallelism (``tp``), the megatron split that ``TP_RULES`` (data,
the JAX package's) declares: ``qkv`` and ``mlp/up`` split their output
columns over tp, ``out`` and ``mlp/down`` their input rows
(``parallel.sharding.shard_module_``; the fused qkv splits q, k and v
alike, ``SPLIT_GROUPS``, so tp rank r holds heads [r H/tp, (r+1) H/tp) of
each, and ``mlp/up``'s replicated bias is sliced to the rank's columns in
``forward``). A tp rank attends over its heads and runs its quarter of the
MLP; each row-split product is taken in float32 (the rounding to bfloat16
waits for the sum, as on one device), added over tp
(``comm.reduce_from``, one (B, N, dim) activation) and then rounded and
given its bias: one all-reduce on the residual after attention and one
after the MLP, each block. Under autograd (``train.Trainer`` over a mesh)
the column-split ``qkv`` and ``mlp/up`` take their input through
``comm.copy_to``, whose backward adds the ranks' input gradients over tp,
and so does ``mlp/up``'s bias before it is sliced (each rank's gradient
of it is nonzero on its own columns only): every replicated parameter
then gets the same gradient on every tp rank, one device's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..parallel import comm
from ..parallel.sharding import axis_group, axis_index, axis_size
from .layers import TRUNCATED_STD, Dense, LayerNorm, flax_normal_, gelu
from .unet import same_pads

#: Param-path rules of the JAX package's tensor parallelism.
TP_RULES = {
    "attn/qkv/kernel": (None, "tp"),
    "attn/out/kernel": ("tp", None),
    "mlp/up/kernel": (None, "tp"),
    "mlp/down/kernel": ("tp", None),
}


def softmax_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis of a low-precision ``x``, each
    op rounded to its type as JAX rounds it (``jnp.sum`` adds in float32);
    ``torch.softmax`` would round once. In float32 it is
    ``torch.softmax``."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=-1)
    e = (x - x.amax(dim=-1, keepdim=True)).exp_()
    return e.div_(e.float().sum(dim=-1, keepdim=True).to(x.dtype))


def row_parallel(dense: Dense, x: torch.Tensor, tp_mesh) -> torch.Tensor:
    """A Dense whose input rows are split over tp: this rank's product in
    float32, summed over the axis, then rounded to the layer's type and
    given its (replicated) bias."""
    part = torch.matmul(x.float(), dense.weight.float().t())
    y = comm.reduce_from(part, axis_group(tp_mesh, "tp")).to(dense.dtype)
    return y if dense.bias is None else y + dense.bias.to(dense.dtype)


def _check_split(full: int, local: int, tp_mesh) -> None:
    if tp_mesh is not None and full == local:
        raise RuntimeError("a tp-meshed ViT holds whole weights: shard the "
                           "module first (parallel.sharding.shard_module_)")


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int,
                 dtype: torch.dtype = torch.bfloat16, tp_mesh=None):
        super().__init__()
        self.dim, self.heads, self.tp_mesh = dim, heads, tp_mesh
        self.qkv = Dense(dim, 3 * dim, bias=False, dtype=dtype)
        self.qkv.SPLIT_GROUPS = {"weight": 3}  # q, k and v split alike
        self.out = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        hd = self.dim // self.heads
        heads = self.qkv.weight.shape[0] // (3 * hd)  # this rank's
        _check_split(self.heads, heads, self.tp_mesh)
        if self.tp_mesh is not None:
            x = comm.copy_to(x, axis_group(self.tp_mesh, "tp"))
        qkv = self.qkv(x).view(b, n, 3, heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        # JAX casts the weak-typed python scale to the scores' type.
        scale = float(torch.tensor(hd ** -0.5, dtype=q.dtype))
        attn = softmax_bf16((q @ k.transpose(-1, -2)) * scale)
        out = (attn @ v).transpose(1, 2).reshape(b, n, heads * hd)
        if self.tp_mesh is None:
            return self.out(out)
        return row_parallel(self.out, out, self.tp_mesh)


class Mlp(nn.Module):
    def __init__(self, dim: int, expansion: int = 4,
                 dtype: torch.dtype = torch.bfloat16, tp_mesh=None):
        super().__init__()
        self.tp_mesh = tp_mesh
        self.up = Dense(dim, dim * expansion, dtype=dtype)
        self.down = Dense(dim * expansion, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_mesh is None:
            return self.down(gelu(self.up(x)))
        up = self.up
        cols = up.weight.shape[0]
        _check_split(up.bias.shape[0], cols, self.tp_mesh)
        group = axis_group(self.tp_mesh, "tp")
        x, bias = comm.copy_to(x, group), comm.copy_to(up.bias, group)
        bias = bias.narrow(0, axis_index(self.tp_mesh, "tp") * cols, cols)
        h = F.linear(x.to(up.dtype), up.weight.to(up.dtype)) + bias.to(up.dtype)
        return row_parallel(self.down, gelu(h), self.tp_mesh)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int,
                 dtype: torch.dtype = torch.bfloat16, tp_mesh=None):
        super().__init__()
        self.ln1 = LayerNorm(dim, dtype=dtype)
        self.attn = Attention(dim, heads, dtype, tp_mesh)
        self.ln2 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, dtype=dtype, tp_mesh=tp_mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ViT(nn.Module):
    """(B, H, W, 3) float images to (B, num_classes) float32 logits. The
    patch grid (and so ``pos_embed``'s length) follows ``image_size``."""

    def __init__(self, num_classes: int = 1000, patch: int = 16,
                 dim: int = 384, depth: int = 6, heads: int = 6,
                 image_size: int = 224, dtype: torch.dtype = torch.bfloat16,
                 tp_mesh=None):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        grid = -(-image_size // patch)
        self.embed = nn.Conv2d(3, dim, patch, stride=patch, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros((1, grid * grid, dim)))
        self.blocks = nn.ModuleList(Block(dim, heads, dtype, tp_mesh)
                                    for _ in range(depth))
        self.norm = LayerNorm(dim, dtype=dtype)
        self.head = Dense(dim, num_classes, dtype=torch.float32)

    def patch_embed(self, x: torch.Tensor) -> torch.Tensor:
        """flax's ``SAME`` strided conv on (B, H, W, 3): pad, cut into
        (patch, patch, 3) patches in the kernel's (H, W, I) order, one
        product with the kernel, the bias after. Returns (B, h*w, dim)."""
        p = self.patch
        (top, bottom), (left, right) = (same_pads(x.shape[1], p, p),
                                        same_pads(x.shape[2], p, p))
        x = F.pad(x, (0, 0, left, right, top, bottom))
        b, hp, wp, c = x.shape
        h, w = hp // p, wp // p
        patches = (x.reshape(b, h, p, w, p, c).permute(0, 1, 3, 2, 4, 5)
                   .reshape(b, h * w, p * p * c))
        kernel = self.embed.weight.to(self.dtype).permute(0, 2, 3, 1)
        y = F.linear(patches, kernel.reshape(kernel.shape[0], -1))
        return y + self.embed.bias.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x.to(self.dtype))
        x = x + self.pos_embed.to(self.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        pooled = x.float().mean(dim=1).to(x.dtype)  # float32 sum, as jnp.mean
        return self.head(pooled)


def init_vit_flax_like_(model: ViT, generator: torch.Generator) -> None:
    """Flax's default init: Dense and conv kernels ``lecun_normal`` (the
    conv's fan-in patch x patch x 3), zero biases, ``pos_embed``
    normal(0.02), LayerNorm scale one and bias zero."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Dense, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                flax_normal_(m.weight, math.sqrt(1.0 / fan_in) / TRUNCATED_STD,
                             generator, truncated=True)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        flax_normal_(model.pos_embed, 0.02, generator, truncated=False)


def create_vit(generator: torch.Generator | None = None,
               num_classes: int = 1000, image_size: int = 224,
               patch: int = 16, dim: int = 384, depth: int = 6,
               heads: int = 6, dtype: torch.dtype = torch.bfloat16,
               device=None, mesh=None) -> ViT:
    """A ViT with flax-like random weights drawn on the CPU from
    ``generator`` (default: seed 0), then moved to ``device`` (default
    ``cuda``). Over a ``mesh`` with tp > 1 the blocks split by heads and
    MLP columns: the model is built whole and ``shard_module_(model, mesh,
    TP_RULES)`` (the runtime's ``register``) keeps this rank's shards;
    ``heads`` must divide by tp."""
    tp = axis_size(mesh, "tp")
    if heads % tp:
        raise ValueError(f"heads {heads} not divisible by tp={tp}")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = ViT(num_classes=num_classes, patch=patch, dim=dim, depth=depth,
                heads=heads, image_size=image_size, dtype=dtype,
                tp_mesh=mesh if tp > 1 else None)
    init_vit_flax_like_(model, generator)
    return model.to(device).eval()
