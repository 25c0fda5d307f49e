"""SeqFormer — the long-context transformer encoder classifier, counterpart
of ``ai4e_tpu/models/seqformer.py`` with the same arithmetic:

- the body runs in bfloat16: ``nn.Embed(dtype=bf16)`` casts its table to
  bfloat16 before the gather, and ``pos_emb`` (shape ``(1, S, dim)``) is
  cast to bfloat16 before the add;
- ``nn.LayerNorm()`` (``layers.LayerNorm``) returns float32 on a bfloat16
  input, with epsilon 1e-6 and the variance as E[x^2] - E[x]^2; the next
  Dense casts it back to bfloat16;
- each Dense rounds its product to bfloat16 and then adds its bias in
  bfloat16 (``layers.Dense``); the MLP's gelu is JAX's bfloat16 op chain
  (``layers.gelu``);
- pooling ``h.mean(axis=1)`` sums in float32 and returns bfloat16;
- the head is a float32 Dense with a bias.

Flax keeps float32 params and casts them to bfloat16 on every call. Served,
the bfloat16 layers are built in bfloat16 (``param_dtype`` defaults to the
compute ``dtype``), so loading float32 weights rounds them once, to the same
values. For training, ``param_dtype=torch.float32`` keeps float32 masters of
the bfloat16 layers (``Dense``, ``Embed``, ``pos_emb``) and casts them on
every call, as flax does; the state_dict keys are the same, so a trained
float32 state_dict loads into the served model with one rounding.

Attention is injected as a plain function of (q, k, v), each (B, H, S, D):
``attention_for`` gives the hand-written flash kernel (``ops.flash_attention``),
plain full attention, or, over a mesh whose ``sp`` axis is larger than one,
ring or Ulysses attention (``parallel/ring_attention.py``). q/k/v are strided
views of the fused qkv projection and the kernel writes its output in (B, S,
H, D) order, so neither side of the attention call copies.

Sequence parallelism: with ring or Ulysses attention (``seq_mesh``) each sp
rank embeds and runs only its contiguous chunk of the sequence (its slice
of ``pos_emb`` too); every layer but attention is per token, and the mean
pool sums the rank's tokens in float32, adds the chunks' sums over the sp
axis (``comm.reduce_from``) and divides by S, so every rank of the axis
ends with the same logits. JAX reaches the same function by XLA's
resharding around its shard_map. In training a rank's gradients of the
layers before the pool hold only its chunk's part (``partial_grad_axes``),
and the trainer sums them over sp.

``SeqFormerLM`` is the causal token LM of the streaming path
(``runtime/kvcache.py``), in float32 as in JAX, with two entry points:
``prefill`` (full causal attention over a padded prompt, returning the K/V
it computed) and ``decode_step`` (one token per slot of a pooled K/V
cache). Its attention over the cache is a masked product and softmax, as
JAX's (no kernel of ``ops``), and the step writes the new token's K/V into
the cache in place at ``position``, where JAX blends a one-hot over the
whole cache: for finite values the two give the same cache bit for bit
(``k * 1 + k_new * 0 = k``, ``k * 0 + k_new * 1 = k_new``).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable

import torch
from torch import nn

from ..device import resolve_device
from ..ops.flash_attention import flash_attention
from ..parallel import comm
from ..parallel.ring_attention import (reference_attention, ring_attention,
                                       ulysses_attention)
from ..parallel.sharding import axis_group, axis_index, axis_size
from .layers import (TRUNCATED_STD, Dense, Embed, LayerNorm, flax_normal_,
                     gelu)

STRATEGIES = ("auto", "ring", "ulysses", "flash", "full")
#: Strategies that shard the sequence over the mesh's sp axis.
SEQUENCE_PARALLEL = ("ring", "ulysses")


def sequence_chunk(x: torch.Tensor, pos: torch.Tensor, seq_mesh):
    """This sp rank's chunk of the (B, S, ...) input and of the (1, S, dim)
    positions (both whole without ``seq_mesh``)."""
    if seq_mesh is None:
        return x, pos
    n = axis_size(seq_mesh, "sp")
    chunk = x.shape[1] // n
    start = axis_index(seq_mesh, "sp") * chunk
    return x[:, start:start + chunk], pos[:, start:start + chunk]


def mean_pool(h: torch.Tensor, seq_mesh, seq_len: int) -> torch.Tensor:
    """``h.mean(axis=1)`` as jnp takes it (a float32 sum, the result in
    h's type); over ``seq_mesh`` the chunks' float32 sums are added over the
    sp axis first (``comm.reduce_from``: under autograd each rank's chunk
    gets the whole gradient of the sum)."""
    if seq_mesh is None:
        return h.float().mean(dim=1).to(h.dtype)
    total = comm.reduce_from(h.float().sum(dim=1),
                             axis_group(seq_mesh, "sp"))
    return (total / seq_len).to(h.dtype)


class SeqAttention(nn.Module):
    def __init__(self, dim: int, heads: int, attn_fn: Callable,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.dim, self.heads, self.attn_fn = dim, heads, attn_fn
        self.qkv = Dense(dim, 3 * dim, bias=False, dtype=dtype,
                         param_dtype=param_dtype)
        self.out = Dense(dim, dim, bias=False, dtype=dtype,
                         param_dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        qkv = self.qkv(x).view(b, s, 3, self.heads, self.dim // self.heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = self.attn_fn(q, k, v)
        return self.out(o.transpose(1, 2).reshape(b, s, self.dim))


class SeqBlock(nn.Module):
    def __init__(self, dim: int, heads: int, attn_fn: Callable,
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = SeqAttention(dim, heads, attn_fn, dtype=dtype,
                                 param_dtype=param_dtype)
        self.ln2 = LayerNorm(dim)
        self.mlp_up = Dense(dim, dim * mlp_ratio, dtype=dtype,
                            param_dtype=param_dtype)
        self.mlp_down = Dense(dim * mlp_ratio, dim, dtype=dtype,
                              param_dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp_down(gelu(self.mlp_up(self.ln2(x))))


class SeqFormer(nn.Module):
    """Encoder over (B, S, input_dim) float features — or, with
    ``vocab_size`` set, over (B, S) integer token ids — to (B, num_classes)
    float32 logits. ``param_dtype`` (default: ``dtype``) is the type the
    bfloat16 layers hold their parameters in."""

    def __init__(self, seq_len: int, input_dim: int, dim: int = 128,
                 depth: int = 2, heads: int = 8, num_classes: int = 16,
                 attn_fn: Callable | None = None,
                 dtype: torch.dtype = torch.bfloat16,
                 vocab_size: int | None = None,
                 param_dtype: torch.dtype | None = None, seq_mesh=None):
        super().__init__()
        attn_fn = attn_fn or reference_attention
        self.dtype, self.seq_len, self.seq_mesh = dtype, seq_len, seq_mesh
        if vocab_size is not None:
            self.embed = Embed(vocab_size, dim, dtype=dtype,
                               param_dtype=param_dtype)
        else:
            self.embed = Dense(input_dim, dim, dtype=dtype,
                               param_dtype=param_dtype)
        self.pos_emb = nn.Parameter(torch.zeros((1, seq_len, dim),
                                                dtype=param_dtype or dtype))
        self.blocks = nn.ModuleList(
            SeqBlock(dim, heads, attn_fn, dtype=dtype,
                     param_dtype=param_dtype) for _ in range(depth))
        self.norm = LayerNorm(dim)
        self.head = Dense(dim, num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pos = sequence_chunk(x, self.pos_emb, self.seq_mesh)
        h = self.embed(x) + pos.to(self.dtype)
        for block in self.blocks:
            h = block(h)
        return self.head(self.norm(mean_pool(h, self.seq_mesh, self.seq_len)))

    def partial_grad_axes(self) -> dict[str, tuple[str, ...]]:
        """The mesh axes over which each parameter's gradient on a rank is
        only that rank's part (``Trainer`` sums it over them): under
        sequence parallelism every parameter before the pool, since a rank
        runs only its chunk of the sequence."""
        return sequence_partial(self)


def sequence_partial(model: nn.Module) -> dict[str, tuple[str, ...]]:
    """``partial_grad_axes`` of a sequence classifier whose ``norm`` and
    ``head`` follow the pool: ``("sp",)`` for every other parameter where
    the model shards its sequence, else nothing."""
    if model.seq_mesh is None:
        return {}
    return {name: ("sp",) for name, _ in model.named_parameters()
            if not name.startswith(("norm.", "head."))}


def init_flax_like_(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's default init: Dense kernels ``lecun_normal`` (truncated
    normal, fan-in scaled) and zero biases, ``nn.Embed`` normal with std
    sqrt(1/dim), ``pos_emb`` normal(0.02), LayerNorm scale one and bias
    zero."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Dense):
                flax_normal_(m.weight,
                             math.sqrt(1.0 / m.in_features) / TRUNCATED_STD,
                             generator, truncated=True)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                flax_normal_(m.weight, math.sqrt(1.0 / m.embedding_dim),
                             generator, truncated=False)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        flax_normal_(model.pos_emb, 0.02, generator, truncated=False)


def resolve_strategy(mesh=None, strategy: str = "auto") -> str:
    """The strategy ``attention_for`` runs: ``auto`` is ring where the
    mesh's sp axis is larger than one and flash otherwise; ``ring`` and
    ``ulysses`` need such a mesh."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown attention strategy {strategy!r}; "
                         f"valid: {STRATEGIES}")
    sp = axis_size(mesh, "sp")
    if strategy == "auto":
        return "ring" if sp > 1 else "flash"
    if strategy in SEQUENCE_PARALLEL and sp <= 1:
        raise ValueError(f"{strategy} attention needs a mesh with sp > 1")
    return strategy


def attention_for(mesh=None, strategy: str = "auto",
                  causal: bool = False) -> Callable:
    """The attention function for a strategy (``resolve_strategy``):
    ``flash`` the fused flash kernel and ``full`` plain materialised
    attention (the correctness oracle), both single-device; ``ring`` and
    ``ulysses`` the sequence-parallel paths over ``mesh``'s sp axis."""
    strategy = resolve_strategy(mesh, strategy)
    if strategy == "full":
        return partial(reference_attention, causal=causal)
    if strategy == "flash":
        return partial(flash_attention, causal=causal)
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[strategy]
    return partial(fn, mesh=mesh, causal=causal)


def sequence_mesh(mesh, strategy: str):
    """The mesh a model shards its sequence over: ``mesh`` under ring or
    Ulysses attention, else None. The sequence must divide the sp axis."""
    return mesh if resolve_strategy(mesh, strategy) in SEQUENCE_PARALLEL \
        else None


def create_seqformer(generator: torch.Generator | None = None,
                     seq_len: int = 4096, input_dim: int = 64,
                     dim: int = 128, depth: int = 2, heads: int = 8,
                     num_classes: int = 16, mesh=None,
                     attention: str = "auto", causal: bool = False,
                     vocab_size: int | None = None,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None,
                     param_dtype: torch.dtype | None = None) -> SeqFormer:
    """A SeqFormer with flax-like random weights drawn on the CPU from
    ``generator`` (default: seed 0), then moved to ``device`` (default
    ``cuda``). ``vocab_size`` switches the input to (B, S) token ids;
    ``param_dtype=torch.float32`` keeps float32 masters for training."""
    attn_fn = attention_for(mesh, attention, causal)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = SeqFormer(seq_len=seq_len, input_dim=input_dim, dim=dim,
                      depth=depth, heads=heads, num_classes=num_classes,
                      attn_fn=attn_fn, dtype=dtype, vocab_size=vocab_size,
                      param_dtype=param_dtype,
                      seq_mesh=sequence_mesh(mesh, attention))
    init_flax_like_(model, generator)
    return model.to(device).eval()


class _LMBlock(nn.Module):
    """One causal decoder block in float32, with the two attention entry
    points of the serving runtime over the same parameters: ``prefill``
    (causal attention over the prompt, returning its K/V) and ``step`` (one
    token a slot against the K/V cache, written in place)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.ln1 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim, bias=False, dtype=torch.float32)
        self.proj = Dense(dim, dim, bias=False, dtype=torch.float32)
        self.ln2 = LayerNorm(dim)
        self.mlp_up = Dense(dim, dim * 4, dtype=torch.float32)
        self.mlp_down = Dense(dim * 4, dim, dtype=torch.float32)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.mlp_down(gelu(self.mlp_up(self.ln2(x))))

    def prefill(self, x: torch.Tensor, mask: torch.Tensor):
        """x: (B, S, D); mask: (B, S), True on real tokens. Returns ``(y,
        k, v)``, k and v of shape (B, H, S, hd)."""
        b, s, _ = x.shape
        hd = self.dim // self.heads
        qkv = self.qkv(self.ln1(x)).view(b, s, 3, self.heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=x.device).tril_()
        keep = causal[None, None] & mask[:, None, None, :]
        scores = scores.masked_fill(~keep, -1e30)
        o = torch.matmul(torch.softmax(scores, dim=-1), v)
        x = x + self.proj(o.transpose(1, 2).reshape(b, s, self.dim))
        return self._mlp(x), k, v

    def step(self, x: torch.Tensor, k_cache: torch.Tensor,
             v_cache: torch.Tensor, position: torch.Tensor) -> torch.Tensor:
        """One decode step over the slot pool. x: (S, D), one new token a
        slot; k_cache/v_cache: (S, H, L, hd), written in place with the new
        token's K/V at ``position`` (S,). Attention spans all L keys,
        masked to those at or before ``position``."""
        s, _ = x.shape
        hd = self.dim // self.heads
        length = k_cache.shape[2]
        qkv = self.qkv(self.ln1(x)).view(s, 3, self.heads, hd)
        q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # (S, H, hd)
        rows = torch.arange(s, device=x.device)
        k_cache[rows, :, position] = k_new
        v_cache[rows, :, position] = v_new
        scores = torch.matmul(q.unsqueeze(2),
                              k_cache.transpose(-1, -2)).squeeze(2)
        scores = scores / math.sqrt(hd)  # (S, H, L)
        valid = (torch.arange(length, device=x.device)[None, :]
                 <= position[:, None])
        scores = scores.masked_fill(~valid[:, None, :], -1e30)
        o = torch.matmul(torch.softmax(scores, dim=-1).unsqueeze(2),
                         v_cache).squeeze(2)
        x = x + self.proj(o.reshape(s, self.dim))
        return self._mlp(x)


class SeqFormerLM(nn.Module):
    """Causal token LM over ``_LMBlock``s, float32 throughout:

    - ``prefill(tokens (B, P), length (B,))`` -> ``(next-token ids (B,),
      k, v)``, k/v of shape (depth, B, H, P, hd): the prompt's K/V block,
      inserted into a slot of the pooled cache by the decode runtime;
    - ``decode_step(tokens (S,), k (depth, S, H, L, hd), v, position
      (S,))`` -> ``(next-token ids (S,), k, v)``: one token for every slot
      of the pool, k and v the caches given, written in place.

    Greedy decoding happens on the device: the tied head (``ln_f(h)``
    against the embedding table, in float32) and an argmax that takes the
    first index on ties, as ``jnp.argmax``. ``pos_emb`` is (max_len,
    dim)."""

    def __init__(self, vocab_size: int, max_len: int, dim: int = 64,
                 depth: int = 2, heads: int = 4):
        super().__init__()
        self.vocab_size, self.max_len = vocab_size, max_len
        self.dim, self.depth, self.heads = dim, depth, heads
        self.embed = Embed(vocab_size, dim, dtype=torch.float32)
        self.pos_emb = nn.Parameter(torch.zeros((max_len, dim)))
        self.blocks = nn.ModuleList(_LMBlock(dim, heads)
                                    for _ in range(depth))
        self.ln_f = LayerNorm(dim)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """The tied head: ``ln_f(h)`` against the embedding table."""
        return torch.matmul(self.ln_f(h), self.embed.weight.t())

    def prefill(self, tokens: torch.Tensor, length: torch.Tensor):
        b, p = tokens.shape
        h = self.embed(tokens) + self.pos_emb[None, :p]
        mask = (torch.arange(p, device=tokens.device)[None, :]
                < length[:, None])
        ks, vs = [], []
        for block in self.blocks:
            h, k, v = block.prefill(h, mask)
            ks.append(k)
            vs.append(v)
        last = h[torch.arange(b, device=tokens.device), length - 1]
        next_token = torch.argmax(self.logits(last), dim=-1)
        return next_token, torch.stack(ks), torch.stack(vs)

    def decode_step(self, tokens: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, position: torch.Tensor):
        h = self.embed(tokens) + self.pos_emb[position]  # (S, D)
        for i, block in enumerate(self.blocks):
            h = block.step(h, k_cache[i], v_cache[i], position)
        return torch.argmax(self.logits(h), dim=-1), k_cache, v_cache


def create_seqformer_lm(generator: torch.Generator | None = None,
                        vocab_size: int = 512, max_len: int = 256,
                        dim: int = 64, depth: int = 2, heads: int = 4,
                        device=None) -> SeqFormerLM:
    """A ``SeqFormerLM`` with flax-like random weights drawn on the CPU from
    ``generator`` (default: seed 0), then moved to ``device`` (default
    ``cuda``). ``max_len`` is the K/V cache depth a slot holds: prompt and
    generated tokens must fit under it."""
    if dim % heads:
        raise ValueError(f"dim {dim} not divisible by heads {heads}")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = SeqFormerLM(vocab_size=vocab_size, max_len=max_len, dim=dim,
                        depth=depth, heads=heads)
    init_flax_like_(model, generator)
    return model.to(device).eval()
