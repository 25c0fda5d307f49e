"""Convert a serving checkpoint the JAX package wrote (an orbax directory,
``ai4e_tpu.checkpoint.save_params``) into the ``.npz`` the PyTorch port
reads (``ai4e_tpu_torch.convert.save_npz``)::

    python scripts/orbax_to_npz.py SRC DST.npz

It runs where JAX and orbax are installed: it restores the params tree with
``ai4e_tpu.checkpoint.load_params`` and writes it with the port's own
``save_npz``, so the ``.npz`` format has one definition. The tree is written
as it is (nested dicts, float32 leaves as flax keeps them); the port's
``cli.restore_checkpoint`` and the worker's reload verb then convert it to
the model's state_dict. It prints the tree's leaves and the output path.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def convert(src: str, dst: str) -> dict:
    """Restore the orbax checkpoint at ``src`` and write its tree to the
    ``.npz`` ``dst``; returns the tree (numpy leaves)."""
    import jax

    from ai4e_tpu.checkpoint import load_params
    from ai4e_tpu_torch.convert import save_npz

    if not dst.endswith(".npz"):
        raise SystemExit(f"{dst!r}: the output must be a .npz path")
    tree = jax.tree.map(np.asarray, load_params(os.path.abspath(src)))
    if not isinstance(tree, dict):
        raise SystemExit(f"{src!r} holds a {type(tree).__name__}, not a "
                         "params tree of nested dicts")
    save_npz(tree, dst)
    return tree


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("src", help="orbax checkpoint directory")
    parser.add_argument("dst", help="output .npz path")
    args = parser.parse_args(argv)
    from ai4e_tpu_torch.convert import flatten_tree

    tree = convert(args.src, args.dst)
    flat = flatten_tree(tree)
    for key, arr in flat.items():
        print(f"{key}: {arr.dtype} {tuple(arr.shape)}")
    print(f"wrote {len(flat)} arrays to {args.dst}")


if __name__ == "__main__":
    main()
