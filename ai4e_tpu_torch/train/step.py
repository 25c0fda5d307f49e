"""Training step — counterpart of ``ai4e_tpu/train/step.py`` on one device.

``Trainer`` owns a model and its optimizer and runs one step per call: the
forward, the loss, autograd's backward (which, for the SeqFormer with flash
attention on the card, launches the hand-written dK/dV and dQ kernels) and
the optimizer's update. The JAX package can also shard params and the batch
over a device mesh; training over a mesh is not ported yet (ROADMAP
A15.1), and a ``mesh`` or ``tp_rules`` raises here.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device

#: Why a mesh raises here.
MESH_TRAINING = "is not ported yet (ROADMAP A15.1: training over a mesh)"


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean of -log softmax(logits) at the label, in float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def segmentation_loss(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel cross entropy for the UNet family: (B, H, W, C) logits,
    (B, H, W) labels; float32 log-softmax summed against a one-hot."""
    logp = F.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).float()
    return -(onehot * logp).sum(dim=-1).mean()


def adamw(params, lr: float = 1e-4, weight_decay: float = 1e-4
          ) -> torch.optim.AdamW:
    """optax's ``adamw(lr, weight_decay=...)``: betas (0.9, 0.999), eps 1e-8
    added outside the square root, the decay applied to every parameter
    (optax's default mask is none) and scaled by the learning rate."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


class Trainer:
    """Owns ``model`` on ``device`` (default ``cuda``) and one optimizer
    step. ``loss_fn(logits, labels)`` is scalar; ``labels`` is one array or
    a dict of arrays (the CenterNet's targets), each moved to the device.
    Only ``model.parameters()`` train: buffers, as the ResNet's BatchNorm
    running statistics, stay as they are, as the JAX package's
    ``freeze_batch_stats`` leaves ``batch_stats``. ``optimizer`` maps the
    parameters to a ``torch.optim`` optimizer (default: optax's
    ``adamw(1e-4, weight_decay=1e-4)``). ``remat`` recomputes the whole
    forward in the backward (``torch.utils.checkpoint``), as
    ``jax.checkpoint(apply_fn)`` does. On the card, float32 products run
    without TF32 and bfloat16 products reduce in float32, as the serving
    runtime sets them and as XLA computes."""

    def __init__(self, model: nn.Module, loss_fn: Callable = cross_entropy_loss,
                 optimizer: Callable | None = None, remat: bool = False,
                 device=None, mesh=None, tp_rules: dict | None = None):
        if mesh is not None or tp_rules is not None:
            raise NotImplementedError(
                f"training over a device mesh {MESH_TRAINING}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":  # as ModelRuntime: XLA's precision
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.model = model.to(self.device).train()
        self.model.requires_grad_(True)
        self.loss_fn = loss_fn
        self.remat = remat
        self.optimizer = (optimizer or adamw)(self.model.parameters())

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat:
            return checkpoint(self.model, x, use_reentrant=False)
        return self.model(x)

    def train_step(self, inputs, labels) -> float:
        """One optimizer step; returns the scalar loss."""
        return self.train_step_phases(inputs, labels)[0]

    def train_step_phases(self, inputs, labels
                          ) -> tuple[float, dict[str, float]]:
        """``train_step`` with its phases timed, in ms: ``forward`` (with
        the loss), ``backward`` and ``optimizer``; by CUDA events on the
        card, by the host clock on the CPU."""
        x = self._to_device(inputs)
        y = ({k: self._to_device(v) for k, v in labels.items()}
             if isinstance(labels, dict) else self._to_device(labels))
        marks = [self._mark()]
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self._apply(x), y)
        marks.append(self._mark())
        loss.backward()
        marks.append(self._mark())
        self.optimizer.step()
        marks.append(self._mark())
        value = float(loss.detach())  # waits for the step's device work
        return value, {name: self._elapsed_ms(a, b) for name, a, b in zip(
            ("forward", "backward", "optimizer"), marks, marks[1:])}

    def _to_device(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array)).to(self.device)

    def _mark(self):
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def _elapsed_ms(self, start, end) -> float:
        if self.device.type == "cuda":
            end.synchronize()
            return start.elapsed_time(end)
        return (end - start) * 1e3
