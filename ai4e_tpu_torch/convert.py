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

For ``SeqFormer`` the names are the modules' own (``embed``, ``pos_emb``,
``block{i}/attn/qkv|out``, ``block{i}/mlp_up|mlp_down``, ``head``) plus
flax's auto names for the unnamed LayerNorms: ``block{i}/LayerNorm_0``
(before attention) and ``LayerNorm_1`` (before the MLP), and a top-level
``LayerNorm_0`` (after pooling). Dense kernels go from (in, out) to
Linear's (out, in), ``Embed.embedding`` is ``nn.Embedding.weight`` as it
is, and ``pos_emb`` keeps its (1, S, dim) shape.

``unet_flax_from_state_dict`` and ``seqformer_flax_from_state_dict`` are the
inverses: a trained state_dict becomes the flax tree that ``save_npz``
writes and a worker restores, and a served model's tree is what a reload's
tree is compared with.
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

    with torch.device("meta"):
        expected = UNet(num_classes=int(num_classes), widths=widths,
                        dtype=torch.float32).state_dict()
    return _checked(sd, expected, set(flatten_tree(tree)) - used, "UNet")


def unet_flax_from_state_dict(sd: dict[str, torch.Tensor]) -> dict:
    """The flax ``UNet`` tree (``{"params": {...}}`` of float32 numpy
    arrays) for the port's state_dict: the inverse of
    ``unet_state_dict_from_flax``, exact both ways (a bfloat16 state_dict
    widens to float32 without rounding)."""

    def array(key: str) -> np.ndarray:
        if key not in sd:
            raise ValueError(f"state_dict is missing {key}")
        return sd[key].detach().cpu().float().numpy().copy()

    def kernel(key: str) -> np.ndarray:  # OIHW -> HWIO
        return np.ascontiguousarray(array(key).transpose(2, 3, 1, 0))

    def block(src: str) -> dict:
        node = {}
        for k in range(2):
            node[f"Conv_{k}"] = {"kernel": kernel(f"{src}.convs.{k}.weight")}
            node[f"GroupNorm_{k}"] = {"scale": array(f"{src}.norms.{k}.weight"),
                                      "bias": array(f"{src}.norms.{k}.bias")}
        return node

    depth = len({k.split(".")[1] for k in sd if k.startswith("encoder.")})
    tree: dict = {}
    for i in range(depth):
        tree[f"ConvBlock_{i}"] = block(f"encoder.{i}")
    for i in range(depth - 1):
        tree[f"Conv_{i}"] = {"kernel": kernel(f"down.{i}.weight")}
        tree[f"Conv_{depth - 1 + i}"] = {"kernel": kernel(f"up.{i}.weight")}
        tree[f"ConvBlock_{depth + i}"] = block(f"decoder.{i}")
    tree[f"Conv_{2 * depth - 2}"] = {"kernel": kernel("head.weight"),
                                     "bias": array("head.bias")}
    params = {"params": tree}
    # The forward conversion checks keys and shapes against the model.
    unet_state_dict_from_flax(params)
    return params


def seqformer_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """The port's ``SeqFormer`` state_dict (float32) for a flax
    ``SeqFormer`` tree, token or feature mode (``{"params": {...}}`` or the
    inner dict)."""
    from .models.seqformer import SeqFormer

    tree = params.get("params", params)
    depth = sum(1 for k in tree if k.startswith("block"))
    pos = np.asarray(_take(tree, "pos_emb", "params"), np.float32)
    if pos.ndim != 3 or pos.shape[0] != 1:
        raise ValueError(f"pos_emb must be (1, S, dim), got {pos.shape}")
    embed = _take(tree, "embed", "params")
    token_mode = isinstance(embed, dict) and "embedding" in embed
    sd: dict[str, torch.Tensor] = {"pos_emb": torch.from_numpy(pos.copy())}
    used = {"pos_emb"}

    def array(node: dict, key: str, where: str) -> torch.Tensor:
        used.add(f"{where}/{key}")
        return torch.from_numpy(
            np.asarray(_take(node, key, where), np.float32).copy())

    def node(path: str) -> dict:
        here, where = tree, "params"
        for part in path.split("/"):
            here, where = _take(here, part, where), f"{where}/{part}"
        return here

    def dense(path: str, dst: str, bias: bool = True) -> None:
        kernel = array(node(path), "kernel", path)
        if kernel.dim() != 2:
            raise ValueError(f"{path}/kernel: shape {tuple(kernel.shape)} "
                             "is not a 2-D (in, out) Dense kernel")
        sd[f"{dst}.weight"] = kernel.T.contiguous()
        if bias:
            sd[f"{dst}.bias"] = array(node(path), "bias", path)

    def norm(path: str, dst: str) -> None:
        sd[f"{dst}.weight"] = array(node(path), "scale", path)
        sd[f"{dst}.bias"] = array(node(path), "bias", path)

    if token_mode:
        sd["embed.weight"] = array(embed, "embedding", "embed")
    else:
        dense("embed", "embed")
    for i in range(depth):
        norm(f"block{i}/LayerNorm_0", f"blocks.{i}.ln1")
        dense(f"block{i}/attn/qkv", f"blocks.{i}.attn.qkv", bias=False)
        dense(f"block{i}/attn/out", f"blocks.{i}.attn.out", bias=False)
        norm(f"block{i}/LayerNorm_1", f"blocks.{i}.ln2")
        dense(f"block{i}/mlp_up", f"blocks.{i}.mlp_up")
        dense(f"block{i}/mlp_down", f"blocks.{i}.mlp_down")
    norm("LayerNorm_0", "norm")
    dense("head", "head")

    _, seq_len, dim = pos.shape
    with torch.device("meta"):
        expected = SeqFormer(
            seq_len=seq_len, dim=dim, depth=depth, heads=1,
            input_dim=1 if token_mode else sd["embed.weight"].shape[1],
            num_classes=sd["head.weight"].shape[0],
            vocab_size=sd["embed.weight"].shape[0] if token_mode else None,
            dtype=torch.float32).state_dict()
    return _checked(sd, expected, set(flatten_tree(tree)) - used, "SeqFormer")


def seqformer_flax_from_state_dict(sd: dict[str, torch.Tensor]) -> dict:
    """The flax ``SeqFormer`` tree (``{"params": {...}}`` of float32 numpy
    arrays) for the port's state_dict, token or feature mode: the inverse
    of ``seqformer_state_dict_from_flax``, exact both ways (a bfloat16
    state_dict widens to float32 without rounding)."""

    def array(key: str) -> np.ndarray:
        if key not in sd:
            raise ValueError(f"state_dict is missing {key}")
        return sd[key].detach().cpu().float().numpy().copy()

    def dense(src: str, bias: bool = True) -> dict:
        node = {"kernel": np.ascontiguousarray(array(f"{src}.weight").T)}
        if bias:
            node["bias"] = array(f"{src}.bias")
        return node

    def norm(src: str) -> dict:
        return {"scale": array(f"{src}.weight"), "bias": array(f"{src}.bias")}

    depth = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    tree: dict = {"pos_emb": array("pos_emb")}
    token_mode = "embed.bias" not in sd
    tree["embed"] = ({"embedding": array("embed.weight")} if token_mode
                     else dense("embed"))
    for i in range(depth):
        src = f"blocks.{i}"
        tree[f"block{i}"] = {
            "LayerNorm_0": norm(f"{src}.ln1"),
            "attn": {"qkv": dense(f"{src}.attn.qkv", bias=False),
                     "out": dense(f"{src}.attn.out", bias=False)},
            "LayerNorm_1": norm(f"{src}.ln2"),
            "mlp_up": dense(f"{src}.mlp_up"),
            "mlp_down": dense(f"{src}.mlp_down"),
        }
    tree["LayerNorm_0"] = norm("norm")
    tree["head"] = dense("head")
    params = {"params": tree}
    # The forward conversion checks keys and shapes against the model.
    seqformer_state_dict_from_flax(params)
    return params


def _checked(sd: dict[str, torch.Tensor], expected: dict,
             extra_flax: set[str], model: str) -> dict[str, torch.Tensor]:
    """``sd`` if its keys and shapes are ``expected``'s and the flax tree
    had nothing left over; raises otherwise."""
    if extra_flax:
        raise ValueError(f"flax tree has keys the {model} does not: "
                         f"{sorted(extra_flax)}")
    if set(expected) != set(sd):
        raise ValueError(f"converted keys differ from the {model}'s: missing "
                         f"{sorted(set(expected) - set(sd))}, extra "
                         f"{sorted(set(sd) - set(expected))}")
    for key, tensor in sd.items():
        if tuple(tensor.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key}: shape {tuple(tensor.shape)} does not "
                             f"match the {model}'s "
                             f"{tuple(expected[key].shape)}")
    return sd
