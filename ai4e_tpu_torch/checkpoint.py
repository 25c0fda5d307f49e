"""Checkpoints — counterpart of ``ai4e_tpu/checkpoint.py``, in a JAX-free
on-disk form.

The JAX package writes orbax checkpoints; reading one needs JAX. The port
reads and writes the flat ``.npz`` form of a tree (``convert.save_npz``).

Serving: ``load_params`` gives back the nested flax tree that
``cli.restore_checkpoint`` and ``ModelRuntime.reload_params`` take. A bare
name, as ``deploy/specs/models.json``'s ``"checkpoint": "landcover"``,
names ``landcover.npz`` beside it when that file exists, as the JAX
package resolves the name to its orbax directory. Where JAX is installed,
``scripts/orbax_to_npz.py SRC DST.npz`` converts an orbax checkpoint into
that form. ``save_params`` writes one.

Training: ``CheckpointManager`` keeps rolling train states under a
directory, one directory a step (``<directory>/<step>/``): the params as
``params.npz``, the optimizer state as ``opt_state.npz`` and a
``record.json`` of the step and ``extra``. A step is written under a
temporary name and renamed when whole, so a kill mid-save leaves the
latest complete step as it was (orbax's finalize). Its policy is
orbax's: ``save`` writes a step that is past the latest one and either a
multiple of ``save_interval_steps`` or the first; after a save only the
newest ``max_to_keep`` steps remain. Saves are synchronous, so ``wait``
and ``close`` have nothing to wait for.

``save_trainer`` and ``resume_trainer`` move a ``train.Trainer``'s
state: the parameters and AdamW's state by state_dict key, whole. Over a
mesh every rank gathers the whole state (a collective) and only the
primary writes, so a checkpoint saved at tp = 2 is the file one device
saves; a resume narrows what it reads to the trainer's own mesh.
bfloat16 tensors are stored as float32 (exactly) and cast back to the
template's type on a restore.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from .convert import flatten_tree, load_npz

#: What a checkpoint the port cannot read is told to do.
CONVERTER_HINT = ("the port reads .npz trees written by "
                  "ai4e_tpu_torch.convert.save_npz; convert an orbax "
                  "checkpoint where JAX is installed with "
                  "`python scripts/orbax_to_npz.py SRC DST.npz`")


def is_npz(path: str) -> bool:
    return path.endswith(".npz")


def resolve_npz(path: str) -> str:
    """``path + ".npz"`` where ``path`` is not a ``.npz`` and that file
    exists (``make_checkpoints`` writes ``<name>.npz``), else ``path``."""
    if not is_npz(path) and os.path.isfile(path + ".npz"):
        return path + ".npz"
    return path


def load_params(path: str, like: Any | None = None) -> dict:
    """The flax params tree of the ``.npz`` at ``path``, or at ``path +
    ".npz"`` (``resolve_npz``), as nested dicts of numpy arrays. With
    ``like`` (a tree of arrays or tensors) every leaf takes its template's
    shape check, dtype and, for a tensor, device. Raises ``ValueError`` for
    any other path, naming the converter, and ``FileNotFoundError`` for a
    missing file."""
    path = resolve_npz(path)
    if not is_npz(path):
        kind = "an orbax checkpoint directory" if os.path.isdir(path) else \
            "not a .npz"
        raise ValueError(f"checkpoint {path!r} is {kind}: {CONVERTER_HINT}")
    return _like(load_npz(path), like)


def save_params(path: str, params: Any) -> None:
    """Write a params tree (arrays or tensors) as the ``.npz`` that
    ``load_params(path)`` reads: at ``path`` if it ends in ``.npz``, else
    at ``path + ".npz"``. An existing checkpoint there is replaced, whole
    or not at all."""
    if not is_npz(path):
        path += ".npz"
    tmp = f"{path}.partial"
    _write_npz(tmp, params)
    os.replace(tmp, path)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def _numpy_tree(tree: dict) -> dict:
    return {k: _numpy_tree(v) if isinstance(v, dict) else _numpy(v)
            for k, v in tree.items()}


def _write_npz(path: str, tree: dict) -> None:
    flat = flatten_tree(_numpy_tree(tree))
    with open(path, "wb") as fh:
        np.savez(fh, **flat)
        fh.flush()
        os.fsync(fh.fileno())


def _like(tree, like):
    """``tree`` with each leaf cast as its ``like`` leaf (shape checked);
    ``tree`` itself without a template."""
    if like is None:
        return tree
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"checkpoint keys {sorted(tree)} differ from "
                             f"the template's {sorted(like)}")
        return {k: _like(tree[k], like[k]) for k in like}
    if tuple(np.shape(tree)) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {np.shape(tree)} does "
                         f"not match the template's {tuple(like.shape)}")
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(tree)).to(like.device, like.dtype)
    return np.asarray(tree, dtype=like.dtype)


class CheckpointManager:
    """Rolling train-state checkpoints: params + optimizer state + step,
    under ``directory`` (made if missing). Keeps the newest
    ``max_to_keep`` steps (all with ``None``), saves every
    ``save_interval_steps``, and resumes from the newest on restart."""

    PARAMS, OPT_STATE, RECORD = "params.npz", "opt_state.npz", "record.json"

    def __init__(self, directory: str, max_to_keep: int | None = 3,
                 save_interval_steps: int = 1):
        if max_to_keep is not None and max_to_keep < 0:
            raise ValueError("max_to_keep must be None or non-negative")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        """The complete steps on disk, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self.directory, name, self.RECORD)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        """orbax's decision: past the latest step, and on the interval or
        the first save."""
        steps = self.all_steps()
        if steps and steps[-1] >= step:
            return False
        return step % self.save_interval_steps == 0 or not steps

    def save(self, step: int, params: Any, opt_state: Any | None = None,
             extra: dict | None = None) -> bool:
        """Save (respecting the save-interval policy). Returns True if a
        checkpoint was actually written."""
        if not self.should_save(step):
            return False
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.partial")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        _write_npz(os.path.join(tmp, self.PARAMS), params)
        if opt_state is not None:
            _write_npz(os.path.join(tmp, self.OPT_STATE), opt_state)
        record = {"step": step}
        if extra:
            record["extra"] = extra
        with open(os.path.join(tmp, self.RECORD), "w") as fh:
            json.dump(record, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        steps = self.all_steps()
        if self.max_to_keep is not None:
            for old in steps[:max(len(steps) - self.max_to_keep, 0)]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def read(self, step: int | None = None) -> dict:
        """The given (or latest) step as saved, without templates:
        ``{"step", "params", "opt_state"?, "extra"?}`` of numpy trees.
        Raises ``FileNotFoundError`` when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint to restore")
        where = os.path.join(self.directory, str(step))
        with open(os.path.join(where, self.RECORD)) as fh:
            record = json.load(fh)
        out = {"step": record["step"],
               "params": load_npz(os.path.join(where, self.PARAMS))}
        if os.path.isfile(os.path.join(where, self.OPT_STATE)):
            out["opt_state"] = load_npz(os.path.join(where, self.OPT_STATE))
        if "extra" in record:
            out["extra"] = record["extra"]
        return out

    def restore(self, params_like: Any, opt_state_like: Any | None = None,
                step: int | None = None) -> dict:
        """Restore the given (or latest) step cast as the templates' leaves
        (numpy arrays or tensors, shapes checked). Returns {"step",
        "params", "opt_state"?, "extra"?}."""
        saved = self.read(step)
        out = {"step": saved["step"],
               "params": _like(saved["params"], params_like)}
        if opt_state_like is not None:
            out["opt_state"] = _like(saved.get("opt_state", {}),
                                     opt_state_like)
        if "extra" in saved:
            out["extra"] = saved["extra"]
        return out

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_trainer(mgr: CheckpointManager, trainer, step: int) -> bool:
    """Checkpoint a ``train.Trainer``'s full state. Over a mesh every rank
    calls it: the whole state is gathered on every rank, the primary
    writes, and every rank returns the primary's answer."""
    from .parallel import comm
    from .parallel.sharding import is_primary

    params, opt_state = trainer.gather_state()
    if trainer.mesh is None:
        return mgr.save(step, params, opt_state)
    saved = mgr.save(step, params, opt_state) if is_primary() else False
    return bool(comm.broadcast_host(np.array([saved], np.int32))[0])


def resume_trainer(mgr: CheckpointManager, trainer) -> int:
    """Restore the newest checkpoint into a ``train.Trainer`` in place,
    each whole tensor narrowed to the trainer's own shard; returns the
    restored step (0 if nothing to restore)."""
    try:
        saved = mgr.read()
    except FileNotFoundError:
        return 0
    trainer.load_state(saved["params"], saved.get("opt_state"))
    return saved["step"]
