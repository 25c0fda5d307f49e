"""Serving checkpoints — counterpart of ``ai4e_tpu/checkpoint.py``'s
``load_params``.

The JAX package writes orbax checkpoints; reading one needs JAX. The port
reads the flat ``.npz`` form of the same flax params tree
(``convert.save_npz``): ``load_params`` gives back the nested tree that
``cli.restore_checkpoint`` and ``ModelRuntime.reload_params`` take. A bare
name, as ``deploy/specs/models.json``'s ``"checkpoint": "landcover"``,
names ``landcover.npz`` beside it when that file exists, as the JAX
package resolves the name to its orbax directory. Where
JAX is installed, ``scripts/orbax_to_npz.py SRC DST.npz`` converts an orbax
checkpoint into that form. The training-side ``CheckpointManager`` is not
ported (ROADMAP A16.2).
"""

from __future__ import annotations

import os

from .convert import load_npz

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


def load_params(path: str) -> dict:
    """The flax params tree of the ``.npz`` at ``path``, or at ``path +
    ".npz"`` (``resolve_npz``), as nested dicts of numpy arrays. Raises
    ``ValueError`` for any other path, naming the converter, and
    ``FileNotFoundError`` for a missing file."""
    path = resolve_npz(path)
    if not is_npz(path):
        kind = "an orbax checkpoint directory" if os.path.isdir(path) else \
            "not a .npz"
        raise ValueError(f"checkpoint {path!r} is {kind}: {CONVERTER_HINT}")
    return load_npz(path)
