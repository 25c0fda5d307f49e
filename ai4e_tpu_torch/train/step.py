"""Training step — counterpart of ``ai4e_tpu/train/step.py``.

``Trainer`` owns a model and its optimizer and runs one step per call: the
forward, the loss, autograd's backward (which, for the SeqFormer with flash
attention on the card, launches the hand-written dK/dV and dQ kernels) and
the optimizer's update.

Over a device mesh (``mesh=``, one ``torch.distributed`` rank a device,
``parallel.sharding.make_mesh``) it is the JAX trainer's sharded step with
the collectives written out where XLA inserts them:

- ``tp_rules`` split the parameters (``shard_module_``): each rank keeps
  its shards, and the optimizer, built on them, keeps AdamW's moments
  sharded alike, as optax's are under ``jit``; the model's tp layers call
  their collectives (``models/vit.py``);
- every rank is given the whole batch and computes the rows of its data
  coordinate (dp x fsdp, ``row_range``); a batch that does not divide
  raises;
- the loss is each rank's mean over its rows, and the gradients are
  averaged over the data axes after the backward (one all-reduce of one
  flat buffer a step, the loss riding in it): for a loss that is a mean
  over equal per-row terms, as ``cross_entropy_loss`` and
  ``segmentation_loss`` are, that is the gradient of the mean over the
  global batch, and the returned loss is that mean on every rank.

sp and ep meshes do not train (ROADMAP A15.2).
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
from ..parallel import comm
from ..parallel.sharding import (data_axis_size, data_group, mesh_shape,
                                 rank_device, row_range, shard_module_,
                                 shard_tensors, unshard_tensors)

#: Why an sp or ep mesh raises here.
SP_EP_TRAINING = ("is not ported (ROADMAP A15.2: training under sp and ep; "
                  "JAX's tests cover neither)")


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
    ``jax.checkpoint(apply_fn)`` does; under a mesh the recomputed
    forward's collectives run again, on every rank alike. On the card,
    float32 products run without TF32 and bfloat16 products reduce in
    float32, as the serving runtime sets them and as XLA computes.

    ``mesh`` (a ``make_mesh`` mesh; this process one of its ranks) and
    ``tp_rules`` train over a mesh as the module docstring says; the model
    must be built for the mesh's tp (``create_vit(mesh=...)``). ``device``
    ``cuda`` is then this rank's card (``rank_device``). ``params`` and
    ``opt_state`` are this rank's; ``gather_state`` and ``load_state``
    move whole ones (the checkpoints')."""

    def __init__(self, model: nn.Module, loss_fn: Callable = cross_entropy_loss,
                 optimizer: Callable | None = None, remat: bool = False,
                 device=None, mesh=None, tp_rules: dict | None = None):
        shape = mesh_shape(mesh)
        if shape["sp"] > 1 or shape["ep"] > 1:
            raise NotImplementedError(
                f"training over a mesh with sp={shape['sp']}, "
                f"ep={shape['ep']} {SP_EP_TRAINING}")
        if tp_rules is not None and mesh is None:
            raise ValueError("tp_rules shard over a mesh: pass mesh=")
        self.mesh = mesh
        self.device = resolve_device(rank_device(device) if mesh is not None
                                     else device)
        if self.device.type == "cuda":  # as ModelRuntime: XLA's precision
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        #: ``{state_dict key: (spec, order, groups)}`` of the split params.
        self.split = (shard_module_(model, mesh, tp_rules)
                      if mesh is not None and tp_rules else {})
        self.model = model.to(self.device).train()
        self.model.requires_grad_(True)
        self.loss_fn = loss_fn
        self.remat = remat
        self.optimizer = (optimizer or adamw)(self.model.parameters())
        self._data_group = data_group(mesh) if mesh is not None else None
        self._data_size = data_axis_size(mesh)

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
        the loss), ``backward`` (with the gradients' average over the data
        axes) and ``optimizer``; by CUDA events on the card, by the host
        clock on the CPU. Over a mesh the report also counts this step's
        collectives: ``comm.counters()``'s deltas, each key prefixed
        ``comm_``."""
        x = self._to_device(inputs)
        y = ({k: self._to_device(v) for k, v in labels.items()}
             if isinstance(labels, dict) else self._to_device(labels))
        before = comm.counters()
        marks = [self._mark()]
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self._apply(x), y)
        marks.append(self._mark())
        loss.backward()
        loss = loss.detach()
        if self._data_group is not None:
            loss = self._average_gradients(loss)
        marks.append(self._mark())
        self.optimizer.step()
        marks.append(self._mark())
        value = float(loss)  # waits for the step's device work
        report = {name: self._elapsed_ms(a, b) for name, a, b in zip(
            ("forward", "backward", "optimizer"), marks, marks[1:])}
        if self.mesh is not None:
            after = comm.counters()
            report.update({f"comm_{k}": after[k] - before[k] for k in after})
        return value, report

    def _average_gradients(self, loss: torch.Tensor) -> torch.Tensor:
        """Average every gradient and ``loss`` over the data axes in one
        all-reduce a dtype; returns the global mean loss."""
        grads = []
        for p in self.model.parameters():
            if p.grad is None:  # unused here: a zero, as on every rank
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        loss = loss.float().reshape(1)
        comm.reduce_gradients_(grads + [loss], self._data_group,
                               1.0 / self._data_size)
        return loss[0]

    # -- state: this rank's, and whole ------------------------------------

    @property
    def params(self) -> dict[str, torch.Tensor]:
        """This rank's parameters by state_dict key (shards where split)."""
        return {k: p.detach() for k, p in self.model.named_parameters()}

    @property
    def opt_state(self) -> dict[str, dict[str, torch.Tensor]]:
        """This rank's optimizer state, ``{state key: {param key: tensor}}``
        (AdamW's ``step``, ``exp_avg``, ``exp_avg_sq``; moments shaped like
        their parameters' shards); empty before the first step."""
        state: dict[str, dict[str, torch.Tensor]] = {}
        for name, p in self.model.named_parameters():
            for key, value in self.optimizer.state.get(p, {}).items():
                if isinstance(value, torch.Tensor):
                    state.setdefault(key, {})[name] = value.detach()
        return state

    def gather_state(self) -> tuple[dict, dict]:
        """Whole ``(params, opt_state)``, as one device would hold them:
        every split parameter and moment gathered over its axes (the
        others are the live tensors, not copies). Over a mesh a
        collective: every rank calls it."""
        if not self.split:
            return self.params, self.opt_state
        state = {key: unshard_tensors(by_name, self.mesh,
                                      self._split_of(by_name))
                 for key, by_name in self.opt_state.items()}
        return unshard_tensors(self.params, self.mesh, self.split), state

    def _split_of(self, by_name: dict) -> dict:
        """``split`` for the entries of a state key shaped like their
        parameter (moments; not AdamW's scalar ``step``)."""
        return {k: self.split[k] for k, t in by_name.items()
                if k in self.split and t.dim() > 0}

    def load_state(self, params: dict, opt_state: dict | None = None
                   ) -> None:
        """Set the parameters (and the optimizer state) from whole ones
        keyed as ``gather_state`` gives them (arrays or tensors), each
        narrowed to this rank's shard; a missing key or a wrong shape
        raises."""
        names = dict(self.model.named_parameters())
        if set(params) != set(names):
            raise ValueError(f"params differ from the model's: missing "
                             f"{sorted(set(names) - set(params))}, extra "
                             f"{sorted(set(params) - set(names))}")
        local = shard_tensors({k: torch.as_tensor(np.asarray(v))
                               for k, v in params.items()},
                              self.mesh, self.split)
        with torch.no_grad():
            for name, p in names.items():
                if tuple(local[name].shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(local[name].shape)}"
                                     f" does not match {tuple(p.shape)}")
                p.copy_(local[name])
        if opt_state is None:
            return
        by_param: dict[str, dict[str, torch.Tensor]] = {}
        for key, by_name in opt_state.items():
            arrays = {k: torch.as_tensor(np.asarray(v))
                      for k, v in by_name.items()}
            arrays = shard_tensors(arrays, self.mesh, self._split_of(arrays))
            for name, value in arrays.items():
                by_param.setdefault(name, {})[key] = value
        order = [name for name, _ in self.model.named_parameters()]
        sd = self.optimizer.state_dict()
        index = {name: i for i, name in enumerate(order)}
        sd["state"] = {index[name]: state for name, state in by_param.items()}
        self.optimizer.load_state_dict(sd)

    def _to_device(self, array) -> torch.Tensor:
        """This rank's rows of a global batch (all of it without a mesh),
        on the device."""
        array = np.asarray(array)
        if self.mesh is not None:
            start, stop = row_range(self.mesh, array.shape[0])
            array = array[start:stop]
        return torch.as_tensor(array).to(self.device)

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
