"""Mixture-of-Experts sequence classifier — counterpart of
``ai4e_tpu/models/moe.py``, the expert-parallel (``ep``) family, with the
same arithmetic:

- the router is a float32 Dense with a bias on a float32 input; softmax in
  float32, ``argmax`` (the first index among ties, as ``jnp.argmax``) and
  the top gate;
- ``dense`` dispatch runs every expert on every token in bfloat16 (the
  expert FFN's gelu is ``layers.gelu``, JAX's bfloat16 op chain) and keeps
  the routed expert's output times its gate, in float32;
- ``capacity`` dispatch (GShard): tokens in groups of ``GROUP`` (or the
  largest divisor of S below it), ``cap = max(1, ceil(Sg / E * cf))``
  slots an expert a group, a token's slot its arrival order among the
  group's tokens routed to its expert (``capacity_slots``); a token past
  ``cap`` is dropped: its FFN output is exactly 0 and the residual carries
  it. JAX's dispatch and combine einsums have exactly one nonzero term an
  output, so the gather and scatter by (expert, group, slot) here give the
  same values;
- ``MoEFFN`` returns its output in its input's type: float32, since its
  input is ``nn.LayerNorm()``'s float32 output. So ``x + h`` in
  ``MoEBlock`` is bfloat16 + float32, and the residual stream is float32
  from the first block's output on (later LayerNorms, adds and the mean
  pool run on float32);
- ``up`` (E, D, 4D) and ``down`` (E, 4D, D) are raw parameters with flax's
  ``lecun_normal`` (fan-in over the expert axis too) and no bias.

Nothing on the served path synchronises with the host (no ``.item()``, no
boolean-mask indexing, no ``F.one_hot``, whose range check reads the
device), so a bucket captures in a CUDA graph.

Expert parallelism (``ep``): ``MOE_EP_RULES`` split ``up`` and ``down``
over the mesh's ``ep`` axis (``parallel.sharding.shard_module_``), so ep
rank r holds experts [r E/ep, (r+1) E/ep). The router and attention
replicate. Each rank computes only its experts' tokens and zeros for the
rest, and the combine adds the ranks' outputs over ep
(``comm.all_reduce_sum``, one (B, S, D) float32 activation a layer, as
XLA's psum): every token has exactly one nonzero term, so the sum is the
single device's value exactly. Under ring or Ulysses attention the
sequence shards over ``sp`` as the SeqFormer's does (``sequence_chunk``,
``mean_pool``).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from ..device import resolve_device
from ..parallel import comm
from ..parallel.ring_attention import reference_attention
from ..parallel.sharding import axis_group, axis_index, axis_size
from .layers import (TRUNCATED_STD, Dense, Embed, LayerNorm, flax_normal_,
                     gelu)
from .seqformer import (SeqAttention, attention_for, init_flax_like_,
                        mean_pool, sequence_chunk, sequence_mesh)

#: Param-path rules of the JAX package's expert sharding: expert-major
#: tensors over the mesh's ``ep`` axis.
MOE_EP_RULES = {"moe/up": ("ep", None, None), "moe/down": ("ep", None, None)}
DISPATCHES = ("dense", "capacity")


def group_size(seq_len: int, group: int) -> int:
    """The capacity dispatch's group: the largest divisor of ``seq_len``
    not above ``group``; raises where that collapses below 8."""
    sg = min(seq_len, group)
    while seq_len % sg:
        sg -= 1
    if seq_len > 8 and sg < 8:
        raise ValueError(
            f"seq_len {seq_len} has no group divisor >= 8; pad the sequence "
            "(e.g. to a multiple of 128) for capacity dispatch")
    return sg


def capacity_slots(top: torch.Tensor, num_experts: int,
                   cap: int) -> torch.Tensor:
    """Each token's slot in its expert, (G, Sg) int64 from the (G, Sg)
    routed experts: its arrival order among its group's tokens routed to
    the same expert, ``cap`` for a token past the capacity (dropped). The
    count is a float32 cumsum of the one-hot, exact, as JAX takes it."""
    experts = torch.arange(num_experts, device=top.device)
    onehot = (top[..., None] == experts).float()
    pos = onehot.cumsum(dim=1).gather(-1, top[..., None]).squeeze(-1) - 1.0
    return pos.clamp(max=cap).long()


class MoEFFN(nn.Module):
    """Top-1 token-choice MoE FFN; returns ``(y, top)``, ``y`` in the
    input's type. ``dispatch`` and ``capacity_factor`` are plain attributes:
    a model trained with ``dense`` evaluates with ``capacity`` on the same
    weights by setting them (``MoEClassifier.set_dispatch``)."""

    GROUP = 128  # GShard-style group: dispatch cost linear in the tokens

    def __init__(self, dim: int, num_experts: int, mlp_ratio: int = 4,
                 dispatch: str = "dense", capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None, ep_mesh=None):
        super().__init__()
        hidden = dim * mlp_ratio
        self.num_experts, self.dtype = num_experts, dtype
        self.ep_mesh = ep_mesh
        self.dispatch, self.capacity_factor = dispatch, capacity_factor
        self.router = Dense(dim, num_experts, dtype=torch.float32)
        pdt = param_dtype or dtype
        self.up = nn.Parameter(torch.zeros((num_experts, dim, hidden),
                                           dtype=pdt))
        self.down = nn.Parameter(torch.zeros((num_experts, hidden, dim),
                                             dtype=pdt))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        gates = torch.softmax(self.router(x.float()), dim=-1)  # (B, S, E)
        top_gate = gates.amax(dim=-1)
        top = gates.argmax(dim=-1)  # the first index among ties
        up, down = self.up.to(self.dtype), self.down.to(self.dtype)
        # This rank's experts [first, first + local): all of them off ep.
        local = up.shape[0]
        first = 0
        if self.ep_mesh is not None:
            if local == self.num_experts:
                raise RuntimeError("an ep-meshed MoE layer holds all its "
                                   "experts: shard the module first "
                                   "(parallel.sharding.shard_module_)")
            first = axis_index(self.ep_mesh, "ep") * local
        mine = (top >= first) & (top < first + local)
        expert = torch.where(mine, top - first, 0)
        if self.dispatch == "capacity":
            y = self._capacity_dispatch(x, top, top_gate, up, down, expert,
                                        mine)
        elif self.dispatch == "dense":
            h = gelu(torch.einsum("bsd,edh->bseh", x.to(self.dtype), up))
            out = torch.einsum("bseh,ehd->bsed", h, down)
            y = out.gather(2, expert[..., None, None].expand(
                *top.shape, 1, out.shape[-1])).squeeze(2).float()
            y = torch.where(mine[..., None], y * top_gate[..., None], 0.0)
        else:
            raise ValueError(f"unknown MoE dispatch {self.dispatch!r}; "
                             "expected 'dense' or 'capacity'")
        if self.ep_mesh is not None:
            y = comm.all_reduce_sum(y, axis_group(self.ep_mesh, "ep"))
        return y.to(x.dtype), top

    def capacity(self, seq_len: int) -> tuple[int, int]:
        """(group size, slots an expert a group) at ``seq_len``."""
        sg = group_size(seq_len, self.GROUP)
        return sg, max(1, math.ceil(sg / self.num_experts
                                    * self.capacity_factor))

    def _capacity_dispatch(self, x, top, top_gate, up, down, expert, mine):
        """``expert``: each token's expert among this rank's ``mine``."""
        b, s, d = x.shape
        e = self.num_experts
        local = up.shape[0]
        sg, cap = self.capacity(s)
        g = b * s // sg
        top, expert = top.reshape(g, sg), expert.reshape(g, sg)
        slot = capacity_slots(top, e, cap)
        # Another rank's token takes the extra slot too: no expert here
        # computes it.
        slot = torch.where(mine.reshape(g, sg), slot, cap)
        group = torch.arange(g, device=x.device)[:, None].expand(g, sg)
        # Scatter each token to (expert, group, slot); a dropped token
        # lands in the extra slot ``cap``, which no expert computes.
        xe = x.new_zeros((local, g, cap + 1, d), dtype=self.dtype)
        xe[expert, group, slot] = x.reshape(g, sg, d).to(self.dtype)
        xe = xe[:, :, :cap].reshape(local, g * cap, d)
        oe = torch.bmm(gelu(torch.bmm(xe, up)), down).view(local, g, cap, d)
        kept = slot < cap
        y = oe[expert, group, slot.clamp(max=cap - 1)].float()
        y = torch.where(kept[..., None], y * top_gate.reshape(g, sg, 1), 0.0)
        return y.reshape(b, s, d)


class MoEBlock(nn.Module):
    def __init__(self, dim: int, heads: int, num_experts: int,
                 attn_fn: Callable, dispatch: str = "dense",
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype | None = None, ep_mesh=None):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = SeqAttention(dim, heads, attn_fn, dtype=dtype,
                                 param_dtype=param_dtype)
        self.ln2 = LayerNorm(dim)
        self.moe = MoEFFN(dim, num_experts, dispatch=dispatch,
                          capacity_factor=capacity_factor, dtype=dtype,
                          param_dtype=param_dtype, ep_mesh=ep_mesh)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = x + self.attn(self.ln1(x))
        h, top = self.moe(self.ln2(x))
        return x + h, top  # float32: h is


class MoEClassifier(nn.Module):
    """(B, S, input_dim) float features — or, with ``vocab_size`` set,
    (B, S) integer token ids — to (B, num_classes) float32 logits through
    MoE FFNs. ``param_dtype`` (default: ``dtype``) is the type the
    bfloat16 layers and the experts hold their parameters in."""

    def __init__(self, seq_len: int, input_dim: int, dim: int = 128,
                 depth: int = 2, heads: int = 8, num_experts: int = 8,
                 num_classes: int = 16, attn_fn: Callable | None = None,
                 dispatch: str = "dense", capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 vocab_size: int | None = None,
                 param_dtype: torch.dtype | None = None, ep_mesh=None,
                 seq_mesh=None):
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
            MoEBlock(dim, heads, num_experts, attn_fn, dispatch=dispatch,
                     capacity_factor=capacity_factor, dtype=dtype,
                     param_dtype=param_dtype, ep_mesh=ep_mesh)
            for _ in range(depth))
        self.norm = LayerNorm(dim)
        self.head = Dense(dim, num_classes, dtype=torch.float32)

    def set_dispatch(self, dispatch: str,
                     capacity_factor: float | None = None) -> None:
        """Switch every MoE layer's dispatch (and capacity factor) on the
        same weights."""
        if dispatch not in DISPATCHES:
            raise ValueError(f"unknown dispatch {dispatch!r}")
        for block in self.blocks:
            block.moe.dispatch = dispatch
            if capacity_factor is not None:
                block.moe.capacity_factor = capacity_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pos = sequence_chunk(x, self.pos_emb, self.seq_mesh)
        h = self.embed(x) + pos.to(self.dtype)
        for block in self.blocks:
            h, _ = block(h)
        return self.head(self.norm(mean_pool(h, self.seq_mesh, self.seq_len)))


def init_moe_flax_like_(model: MoEClassifier,
                        generator: torch.Generator) -> None:
    """Flax's default init (``seqformer.init_flax_like_``), then the
    experts: ``lecun_normal`` over (E, in, out), whose fan-in flax counts
    as in x E."""
    init_flax_like_(model, generator)
    for block in model.blocks:
        for param in (block.moe.up, block.moe.down):
            e, fan_in, _ = param.shape
            flax_normal_(param, math.sqrt(1.0 / (fan_in * e)) / TRUNCATED_STD,
                         generator, truncated=True)


def create_moe(generator: torch.Generator | None = None,
               seq_len: int = 1024, input_dim: int = 64, dim: int = 128,
               depth: int = 2, heads: int = 8, num_experts: int = 8,
               num_classes: int = 16, mesh=None, attention: str = "flash",
               dispatch: str = "dense", capacity_factor: float = 1.25,
               vocab_size: int | None = None,
               dtype: torch.dtype = torch.bfloat16, device=None,
               param_dtype: torch.dtype | None = None) -> MoEClassifier:
    """A MoEClassifier with flax-like random weights drawn on the CPU from
    ``generator`` (default: seed 0), then moved to ``device`` (default
    ``cuda``). ``dispatch``: ``dense`` or ``capacity`` (see ``MoEFFN``);
    ``vocab_size`` switches the input to (B, S) token ids;
    ``param_dtype=torch.float32`` keeps float32 masters for training. Over
    a ``mesh`` with ep > 1 the experts shard over ep: the model is built
    whole and ``shard_module_(model, mesh, MOE_EP_RULES)`` (the runtime's
    ``register``) keeps this rank's experts; ``num_experts`` must divide
    by ep."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    ep = axis_size(mesh, "ep")
    if num_experts % ep:
        raise ValueError(f"num_experts {num_experts} not divisible by ep={ep}")
    attn_fn = attention_for(mesh, attention)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = MoEClassifier(
        seq_len=seq_len, input_dim=input_dim, dim=dim, depth=depth,
        heads=heads, num_experts=num_experts, num_classes=num_classes,
        attn_fn=attn_fn, dispatch=dispatch, capacity_factor=capacity_factor,
        dtype=dtype, vocab_size=vocab_size, param_dtype=param_dtype,
        ep_mesh=mesh if ep > 1 else None,
        seq_mesh=sequence_mesh(mesh, attention))
    init_moe_flax_like_(model, generator)
    return model.to(device).eval()
