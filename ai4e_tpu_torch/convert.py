"""Weight conversion from the JAX package's flax trees to the port's
``state_dict``s, and a flat ``.npz`` form of such a tree that the port can
read where JAX is not installed.

The tree arrives as nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)`` on the JAX side). Flax names a module's children in the order they
are created, so for ``UNet(widths)`` with L = len(widths):

- encoder blocks are ``ConvBlock_0..L-1`` and their stride-2 convs
  ``Conv_0..L-2``;
- decoder 1x1 up-convs are ``Conv_{L-1}..2L-3`` and decoder blocks
  ``ConvBlock_L..2L-2``;
- the head is ``Conv_{2L-2}``, the only conv with a bias;
- inside a block: ``Conv_0, GroupNorm_0, Conv_1, GroupNorm_1``.

Conv kernels go from HWIO to OIHW; GroupNorm ``scale``/``bias`` become
``weight``/``bias``. A missing or extra key, or a wrong shape, raises.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten_tree(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> ``{"a/b/c": array}``."""
    flat: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_tree(flat: dict[str, np.ndarray]) -> dict:
    """``{"a/b/c": array}`` -> nested dicts."""
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def save_npz(tree: dict, path: str) -> None:
    """Save a flax tree of numpy arrays flat, with ``/``-joined keys."""
    np.savez(path, **flatten_tree(tree))


def load_npz(path: str) -> dict:
    """Read a tree saved by ``save_npz`` back into nested dicts."""
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})


def _conv_weight(kernel) -> torch.Tensor:
    """Flax HWIO kernel -> torch OIHW weight (float32)."""
    k = np.asarray(kernel, np.float32)
    if k.ndim != 4:
        raise ValueError(f"conv kernel must be 4-D HWIO, got shape {k.shape}")
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _take(node: dict, key: str, where: str):
    if not isinstance(node, dict) or key not in node:
        raise ValueError(f"flax tree is missing {where}/{key}")
    return node[key]


def unet_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """The port's ``UNet`` state_dict (float32) for a flax ``UNet`` tree
    (``{"params": {...}}`` or the inner dict)."""
    from .models.unet import UNet

    tree = params.get("params", params)
    n_blocks = sum(1 for k in tree if k.startswith("ConvBlock_"))
    if n_blocks < 1 or n_blocks % 2 == 0:
        raise ValueError(f"a UNet tree has 2L-1 ConvBlocks, found {n_blocks}")
    depth = (n_blocks + 1) // 2
    widths = tuple(
        np.shape(_take(_take(_take(tree, f"ConvBlock_{i}", "params"),
                             "Conv_0", f"ConvBlock_{i}"), "kernel",
                       f"ConvBlock_{i}/Conv_0"))[-1]
        for i in range(depth))
    head = _take(tree, f"Conv_{2 * depth - 2}", "params")
    num_classes = np.shape(_take(head, "kernel", f"Conv_{2 * depth - 2}"))[-1]

    sd: dict[str, torch.Tensor] = {}
    used: set[str] = set()

    def block(flax_name: str, prefix: str) -> None:
        node = _take(tree, flax_name, "params")
        for k in range(2):
            sd[f"{prefix}.convs.{k}.weight"] = _conv_weight(
                _take(_take(node, f"Conv_{k}", flax_name), "kernel",
                      f"{flax_name}/Conv_{k}"))
            norm = _take(node, f"GroupNorm_{k}", flax_name)
            for src, dst in (("scale", "weight"), ("bias", "bias")):
                sd[f"{prefix}.norms.{k}.{dst}"] = torch.from_numpy(
                    np.asarray(_take(norm, src, f"{flax_name}/GroupNorm_{k}"),
                               np.float32).copy())
            used.update((f"{flax_name}/Conv_{k}/kernel",
                         f"{flax_name}/GroupNorm_{k}/scale",
                         f"{flax_name}/GroupNorm_{k}/bias"))

    def conv(flax_name: str, dst: str) -> None:
        node = _take(tree, flax_name, "params")
        sd[f"{dst}.weight"] = _conv_weight(_take(node, "kernel", flax_name))
        used.add(f"{flax_name}/kernel")

    for i in range(depth):
        block(f"ConvBlock_{i}", f"encoder.{i}")
    for i in range(depth - 1):
        conv(f"Conv_{i}", f"down.{i}")
        conv(f"Conv_{depth - 1 + i}", f"up.{i}")
        block(f"ConvBlock_{depth + i}", f"decoder.{i}")
    conv(f"Conv_{2 * depth - 2}", "head")
    sd["head.bias"] = torch.from_numpy(np.asarray(
        _take(head, "bias", f"Conv_{2 * depth - 2}"), np.float32).copy())
    used.add(f"Conv_{2 * depth - 2}/bias")

    extra = sorted(set(flatten_tree(tree)) - used)
    if extra:
        raise ValueError(f"flax tree has keys the UNet does not: {extra}")
    with torch.device("meta"):
        expected = UNet(num_classes=int(num_classes), widths=widths,
                        dtype=torch.float32).state_dict()
    if set(expected) != set(sd):
        raise ValueError(f"converted keys differ from the UNet's: missing "
                         f"{sorted(set(expected) - set(sd))}, extra "
                         f"{sorted(set(sd) - set(expected))}")
    for key, tensor in sd.items():
        if tuple(tensor.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key}: shape {tuple(tensor.shape)} does not "
                             f"match the UNet's {tuple(expected[key].shape)}")
    return sd
