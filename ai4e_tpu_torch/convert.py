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

For ``ResNet`` the tree has two collections, ``params`` and
``batch_stats``: the stem is ``Conv_0``/``BatchNorm_0``, the bottlenecks
``Bottleneck_0..N-1`` (inside: ``Conv_k``/``BatchNorm_k``, k = 3 the
shortcut's projection where there is one) and the classifier ``Dense_0``.
A BatchNorm's ``scale``/``bias`` become ``weight``/``bias`` and its
``batch_stats`` ``mean``/``var`` the ``running_mean``/``running_var``
buffers. For ``CenterNetDetector`` the stages are ``_Stage_0..2`` (laid out
as a UNet block) and the feature conv and the heatmap, wh and offset heads
``Conv_0..3``, each with a bias.

For ``MoEClassifier`` the tree is the SeqFormer's with ``block{i}/moe``
(``router`` a Dense with a bias, the experts' raw ``up`` (E, D, H) and
``down`` (E, H, D), kept in that layout) where the MLP was. For ``ViT`` the
patch conv ``embed`` (an HWIO kernel and a bias), ``pos_embed`` and
``block{i}/attn/{qkv,out}`` (only ``out`` with a bias) and
``block{i}/mlp/{up,down}``, with the LayerNorms named as the SeqFormer's.

For ``SeqFormerLM`` the names are the modules' own too (``embed``,
``pos_emb`` of shape (max_len, dim), ``block{i}/ln1|qkv|proj|ln2|mlp_up|
mlp_down``, ``ln_f``); ``qkv`` and ``proj`` have no bias, and the head is
the embedding table, tied.

Each ``*_flax_from_state_dict`` is the inverse of its
``*_state_dict_from_flax``: a trained state_dict becomes the flax tree that
``save_npz`` writes and a worker restores, and a served model's tree is what
a reload's tree is compared with.
"""

from __future__ import annotations

import math

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


def _tensor(node: dict, key: str, where: str) -> torch.Tensor:
    return torch.from_numpy(np.asarray(_take(node, key, where),
                                       np.float32).copy())


def _state_array(sd: dict[str, torch.Tensor], key: str) -> np.ndarray:
    if key not in sd:
        raise ValueError(f"state_dict is missing {key}")
    return sd[key].detach().cpu().float().numpy().copy()


def _state_kernel(sd: dict[str, torch.Tensor], key: str) -> np.ndarray:
    """A torch OIHW conv weight as a flax HWIO kernel."""
    return np.ascontiguousarray(_state_array(sd, key).transpose(2, 3, 1, 0))


class _FlaxReader:
    """Reads leaves of a flax tree by ``/``-joined path as float32 tensors
    and remembers which it read, so ``_checked`` can name the rest."""

    def __init__(self, tree: dict):
        self.tree, self.used = tree, set()

    def tensor(self, path: str) -> torch.Tensor:
        *parents, leaf = path.split("/")
        node, where = self.tree, "params"
        for part in parents:
            node, where = _take(node, part, where), f"{where}/{part}"
        self.used.add(path)
        return _tensor(node, leaf, where)

    def dense(self, sd: dict, path: str, dst: str, bias: bool = True) -> None:
        kernel = self.tensor(f"{path}/kernel")
        if kernel.dim() != 2:
            raise ValueError(f"{path}/kernel: shape {tuple(kernel.shape)} "
                             "is not a 2-D (in, out) Dense kernel")
        sd[f"{dst}.weight"] = kernel.T.contiguous()
        if bias:
            sd[f"{dst}.bias"] = self.tensor(f"{path}/bias")

    def norm(self, sd: dict, path: str, dst: str) -> None:
        sd[f"{dst}.weight"] = self.tensor(f"{path}/scale")
        sd[f"{dst}.bias"] = self.tensor(f"{path}/bias")

    def leftover(self) -> set[str]:
        return set(flatten_tree(self.tree)) - self.used


def _flax_dense(sd: dict[str, torch.Tensor], src: str,
                bias: bool = True) -> dict:
    node = {"kernel": np.ascontiguousarray(_state_array(sd, f"{src}.weight").T)}
    if bias:
        node["bias"] = _state_array(sd, f"{src}.bias")
    return node


def _flax_norm(sd: dict[str, torch.Tensor], src: str) -> dict:
    return {"scale": _state_array(sd, f"{src}.weight"),
            "bias": _state_array(sd, f"{src}.bias")}


def _depth(sd: dict[str, torch.Tensor]) -> int:
    return len({k.split(".")[1] for k in sd if k.startswith("blocks.")})


def seqformer_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """The port's ``SeqFormer`` state_dict (float32) for a flax
    ``SeqFormer`` tree, token or feature mode (``{"params": {...}}`` or the
    inner dict)."""
    from .models.seqformer import SeqFormer

    tree = params.get("params", params)
    read = _FlaxReader(tree)
    depth = sum(1 for k in tree if k.startswith("block"))
    pos = read.tensor("pos_emb")
    if pos.dim() != 3 or pos.shape[0] != 1:
        raise ValueError(f"pos_emb must be (1, S, dim), got {tuple(pos.shape)}")
    embed = _take(tree, "embed", "params")
    token_mode = isinstance(embed, dict) and "embedding" in embed
    sd: dict[str, torch.Tensor] = {"pos_emb": pos}
    if token_mode:
        sd["embed.weight"] = read.tensor("embed/embedding")
    else:
        read.dense(sd, "embed", "embed")
    for i in range(depth):
        b, dst = f"block{i}", f"blocks.{i}"
        read.norm(sd, f"{b}/LayerNorm_0", f"{dst}.ln1")
        read.dense(sd, f"{b}/attn/qkv", f"{dst}.attn.qkv", bias=False)
        read.dense(sd, f"{b}/attn/out", f"{dst}.attn.out", bias=False)
        read.norm(sd, f"{b}/LayerNorm_1", f"{dst}.ln2")
        read.dense(sd, f"{b}/mlp_up", f"{dst}.mlp_up")
        read.dense(sd, f"{b}/mlp_down", f"{dst}.mlp_down")
    read.norm(sd, "LayerNorm_0", "norm")
    read.dense(sd, "head", "head")

    _, seq_len, dim = pos.shape
    with torch.device("meta"):
        expected = SeqFormer(
            seq_len=seq_len, dim=dim, depth=depth, heads=1,
            input_dim=1 if token_mode else sd["embed.weight"].shape[1],
            num_classes=sd["head.weight"].shape[0],
            vocab_size=sd["embed.weight"].shape[0] if token_mode else None,
            dtype=torch.float32).state_dict()
    return _checked(sd, expected, read.leftover(), "SeqFormer")


def seqformer_flax_from_state_dict(sd: dict[str, torch.Tensor]) -> dict:
    """The flax ``SeqFormer`` tree (``{"params": {...}}`` of float32 numpy
    arrays) for the port's state_dict, token or feature mode: the inverse
    of ``seqformer_state_dict_from_flax``, exact both ways (a bfloat16
    state_dict widens to float32 without rounding)."""
    tree: dict = {"pos_emb": _state_array(sd, "pos_emb")}
    tree["embed"] = ({"embedding": _state_array(sd, "embed.weight")}
                     if "embed.bias" not in sd else _flax_dense(sd, "embed"))
    for i in range(_depth(sd)):
        src = f"blocks.{i}"
        tree[f"block{i}"] = {
            "LayerNorm_0": _flax_norm(sd, f"{src}.ln1"),
            "attn": {"qkv": _flax_dense(sd, f"{src}.attn.qkv", bias=False),
                     "out": _flax_dense(sd, f"{src}.attn.out", bias=False)},
            "LayerNorm_1": _flax_norm(sd, f"{src}.ln2"),
            "mlp_up": _flax_dense(sd, f"{src}.mlp_up"),
            "mlp_down": _flax_dense(sd, f"{src}.mlp_down"),
        }
    tree["LayerNorm_0"] = _flax_norm(sd, "norm")
    tree["head"] = _flax_dense(sd, "head")
    params = {"params": tree}
    # The forward conversion checks keys and shapes against the model.
    seqformer_state_dict_from_flax(params)
    return params


def seqformer_lm_state_dict_from_flax(params: dict
                                      ) -> dict[str, torch.Tensor]:
    """The port's ``SeqFormerLM`` state_dict (float32) for a flax
    ``SeqFormerLM`` tree (``{"params": {...}}`` or the inner dict)."""
    from .models.seqformer import SeqFormerLM

    tree = params.get("params", params)
    read = _FlaxReader(tree)
    depth = sum(1 for k in tree if k.startswith("block"))
    pos = read.tensor("pos_emb")
    if pos.dim() != 2:
        raise ValueError(f"pos_emb must be (max_len, dim), got "
                         f"{tuple(pos.shape)}")
    sd: dict[str, torch.Tensor] = {"pos_emb": pos,
                                   "embed.weight": read.tensor(
                                       "embed/embedding")}
    for i in range(depth):
        b, dst = f"block{i}", f"blocks.{i}"
        read.norm(sd, f"{b}/ln1", f"{dst}.ln1")
        read.dense(sd, f"{b}/qkv", f"{dst}.qkv", bias=False)
        read.dense(sd, f"{b}/proj", f"{dst}.proj", bias=False)
        read.norm(sd, f"{b}/ln2", f"{dst}.ln2")
        read.dense(sd, f"{b}/mlp_up", f"{dst}.mlp_up")
        read.dense(sd, f"{b}/mlp_down", f"{dst}.mlp_down")
    read.norm(sd, "ln_f", "ln_f")

    max_len, dim = pos.shape
    with torch.device("meta"):
        expected = SeqFormerLM(vocab_size=sd["embed.weight"].shape[0],
                               max_len=max_len, dim=dim, depth=depth,
                               heads=1).state_dict()
    return _checked(sd, expected, read.leftover(), "SeqFormerLM")


def seqformer_lm_flax_from_state_dict(sd: dict[str, torch.Tensor]) -> dict:
    """The flax ``SeqFormerLM`` tree (``{"params": {...}}`` of float32 numpy
    arrays) for the port's state_dict: the inverse of
    ``seqformer_lm_state_dict_from_flax``, exact both ways."""
    tree: dict = {"pos_emb": _state_array(sd, "pos_emb"),
                  "embed": {"embedding": _state_array(sd, "embed.weight")}}
    for i in range(_depth(sd)):
        src = f"blocks.{i}"
        tree[f"block{i}"] = {
            "ln1": _flax_norm(sd, f"{src}.ln1"),
            "qkv": _flax_dense(sd, f"{src}.qkv", bias=False),
            "proj": _flax_dense(sd, f"{src}.proj", bias=False),
            "ln2": _flax_norm(sd, f"{src}.ln2"),
            "mlp_up": _flax_dense(sd, f"{src}.mlp_up"),
            "mlp_down": _flax_dense(sd, f"{src}.mlp_down"),
        }
    tree["ln_f"] = _flax_norm(sd, "ln_f")
    params = {"params": tree}
    # The forward conversion checks keys and shapes against the model.
    seqformer_lm_state_dict_from_flax(params)
    return params


def resnet_state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """The port's ``ResNet`` state_dict (float32), BatchNorm running
    statistics included, for a flax ``ResNet``'s variables
    (``{"params": {...}, "batch_stats": {...}}``)."""
    from .models.resnet import ResNet

    params = _take(variables, "params", "variables")
    stats = _take(variables, "batch_stats", "variables")
    sd: dict[str, torch.Tensor] = {}
    used: set[str] = set()

    def node(tree: dict, path: str, where: str) -> dict:
        for part in path.split("/"):
            tree, where = _take(tree, part, where), f"{where}/{part}"
        return tree

    def conv(path: str, dst: str) -> None:
        sd[f"{dst}.weight"] = _conv_weight(
            _take(node(params, path, "params"), "kernel", path))
        used.add(f"params/{path}/kernel")

    def norm(path: str, dst: str) -> None:
        p, s = node(params, path, "params"), node(stats, path, "batch_stats")
        for tree, col, src, name in ((p, "params", "scale", "weight"),
                                     (p, "params", "bias", "bias"),
                                     (s, "batch_stats", "mean", "running_mean"),
                                     (s, "batch_stats", "var", "running_var")):
            sd[f"{dst}.{name}"] = _tensor(tree, src, f"{col}/{path}")
            used.add(f"{col}/{path}/{src}")

    conv("Conv_0", "stem")
    norm("BatchNorm_0", "stem_norm")
    n_blocks = sum(1 for k in params if k.startswith("Bottleneck_"))
    blocks = []
    for i in range(n_blocks):
        block = _take(params, f"Bottleneck_{i}", "params")
        n_convs = sum(1 for k in block if k.startswith("Conv_"))
        if n_convs not in (3, 4):
            raise ValueError(f"Bottleneck_{i} has {n_convs} convs, not 3 or 4")
        for k in range(n_convs):
            conv(f"Bottleneck_{i}/Conv_{k}", f"blocks.{i}.convs.{k}")
            norm(f"Bottleneck_{i}/BatchNorm_{k}", f"blocks.{i}.norms.{k}")
        blocks.append(np.shape(_take(block["Conv_0"], "kernel",
                                     f"Bottleneck_{i}/Conv_0"))[-1])
    dense = _take(params, "Dense_0", "params")
    kernel = _tensor(dense, "kernel", "params/Dense_0")
    sd["head.weight"] = kernel.T.contiguous()
    sd["head.bias"] = _tensor(dense, "bias", "params/Dense_0")
    used.update(("params/Dense_0/kernel", "params/Dense_0/bias"))

    # The stage sizes from the block widths: a stage is a run of one width.
    width = sd["stem.weight"].shape[0]
    stage_sizes = [sum(1 for f in blocks if f == width * 2 ** i)
                   for i in range(len(set(blocks)))]
    with torch.device("meta"):
        expected = ResNet(stage_sizes=tuple(stage_sizes),
                          num_classes=kernel.shape[1], width=width,
                          dtype=torch.float32).state_dict()
    return _checked(sd, expected, set(flatten_tree(variables)) - used,
                    "ResNet")


def resnet_flax_from_state_dict(sd: dict[str, torch.Tensor]) -> dict:
    """The flax ``ResNet`` variables (``{"params", "batch_stats"}`` of
    float32 numpy arrays) for the port's state_dict: the inverse of
    ``resnet_state_dict_from_flax``, exact both ways."""
    params: dict = {"Conv_0": {"kernel": _state_kernel(sd, "stem.weight")}}
    stats: dict = {}

    def norm(src: str, p: dict, s: dict, name: str) -> None:
        p[name] = {"scale": _state_array(sd, f"{src}.weight"),
                   "bias": _state_array(sd, f"{src}.bias")}
        s[name] = {"mean": _state_array(sd, f"{src}.running_mean"),
                   "var": _state_array(sd, f"{src}.running_var")}

    norm("stem_norm", params, stats, "BatchNorm_0")
    n_blocks = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    for i in range(n_blocks):
        p, s = {}, {}
        n_convs = len({k.split(".")[3] for k in sd
                       if k.startswith(f"blocks.{i}.convs.")})
        for k in range(n_convs):
            p[f"Conv_{k}"] = {"kernel": _state_kernel(
                sd, f"blocks.{i}.convs.{k}.weight")}
            norm(f"blocks.{i}.norms.{k}", p, s, f"BatchNorm_{k}")
        params[f"Bottleneck_{i}"], stats[f"Bottleneck_{i}"] = p, s
    params["Dense_0"] = {
        "kernel": np.ascontiguousarray(_state_array(sd, "head.weight").T),
        "bias": _state_array(sd, "head.bias")}
    variables = {"params": params, "batch_stats": stats}
    # The forward conversion checks keys and shapes against the model.
    resnet_state_dict_from_flax(variables)
    return variables


#: The detector's flax convs after its stages -> the port's module names.
_DETECTOR_HEADS = ("feat", "heatmap", "wh", "offset")


def detector_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """The port's ``CenterNetDetector`` state_dict (float32) for a flax
    ``CenterNetDetector`` tree (``{"params": {...}}`` or the inner dict)."""
    from .models.detector import CenterNetDetector

    tree = params.get("params", params)
    n_stages = sum(1 for k in tree if k.startswith("_Stage_"))
    sd: dict[str, torch.Tensor] = {}
    used: set[str] = set()
    widths = []
    for i in range(n_stages):
        stage = _take(tree, f"_Stage_{i}", "params")
        for k in range(2):
            where = f"_Stage_{i}/Conv_{k}"
            sd[f"stages.{i}.convs.{k}.weight"] = _conv_weight(
                _take(_take(stage, f"Conv_{k}", f"_Stage_{i}"), "kernel",
                      where))
            norm = _take(stage, f"GroupNorm_{k}", f"_Stage_{i}")
            for src, dst in (("scale", "weight"), ("bias", "bias")):
                sd[f"stages.{i}.norms.{k}.{dst}"] = _tensor(
                    norm, src, f"_Stage_{i}/GroupNorm_{k}")
                used.add(f"_Stage_{i}/GroupNorm_{k}/{src}")
            used.add(f"{where}/kernel")
        widths.append(sd[f"stages.{i}.convs.0.weight"].shape[0])
    for k, name in enumerate(_DETECTOR_HEADS):
        conv = _take(tree, f"Conv_{k}", "params")
        sd[f"{name}.weight"] = _conv_weight(_take(conv, "kernel", f"Conv_{k}"))
        sd[f"{name}.bias"] = _tensor(conv, "bias", f"Conv_{k}")
        used.update((f"Conv_{k}/kernel", f"Conv_{k}/bias"))
    with torch.device("meta"):
        expected = CenterNetDetector(
            num_classes=sd["heatmap.weight"].shape[0], widths=tuple(widths),
            dtype=torch.float32).state_dict()
    return _checked(sd, expected, set(flatten_tree(tree)) - used,
                    "CenterNetDetector")


def detector_flax_from_state_dict(sd: dict[str, torch.Tensor]) -> dict:
    """The flax ``CenterNetDetector`` tree (``{"params": {...}}`` of float32
    numpy arrays) for the port's state_dict: the inverse of
    ``detector_state_dict_from_flax``, exact both ways."""
    tree: dict = {}
    n_stages = len({k.split(".")[1] for k in sd if k.startswith("stages.")})
    for i in range(n_stages):
        src = f"stages.{i}"
        tree[f"_Stage_{i}"] = {}
        for k in range(2):
            tree[f"_Stage_{i}"][f"Conv_{k}"] = {
                "kernel": _state_kernel(sd, f"{src}.convs.{k}.weight")}
            tree[f"_Stage_{i}"][f"GroupNorm_{k}"] = {
                "scale": _state_array(sd, f"{src}.norms.{k}.weight"),
                "bias": _state_array(sd, f"{src}.norms.{k}.bias")}
    for k, name in enumerate(_DETECTOR_HEADS):
        tree[f"Conv_{k}"] = {"kernel": _state_kernel(sd, f"{name}.weight"),
                             "bias": _state_array(sd, f"{name}.bias")}
    params = {"params": tree}
    # The forward conversion checks keys and shapes against the model.
    detector_state_dict_from_flax(params)
    return params


def moe_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """The port's ``MoEClassifier`` state_dict (float32) for a flax
    ``MoEClassifier`` tree, token or feature mode (``{"params": {...}}`` or
    the inner dict). The tree is the SeqFormer's with ``block{i}/moe``
    (``router/{kernel,bias}``, ``up`` (E, D, H), ``down`` (E, H, D)) in
    place of the MLP; the experts keep their layout."""
    from .models.moe import MoEClassifier

    tree = params.get("params", params)
    read = _FlaxReader(tree)
    depth = sum(1 for k in tree if k.startswith("block"))
    pos = read.tensor("pos_emb")
    if pos.dim() != 3 or pos.shape[0] != 1:
        raise ValueError(f"pos_emb must be (1, S, dim), got {tuple(pos.shape)}")
    embed = _take(tree, "embed", "params")
    token_mode = isinstance(embed, dict) and "embedding" in embed
    sd: dict[str, torch.Tensor] = {"pos_emb": pos}
    if token_mode:
        sd["embed.weight"] = read.tensor("embed/embedding")
    else:
        read.dense(sd, "embed", "embed")
    for i in range(depth):
        b, dst = f"block{i}", f"blocks.{i}"
        read.norm(sd, f"{b}/LayerNorm_0", f"{dst}.ln1")
        read.dense(sd, f"{b}/attn/qkv", f"{dst}.attn.qkv", bias=False)
        read.dense(sd, f"{b}/attn/out", f"{dst}.attn.out", bias=False)
        read.norm(sd, f"{b}/LayerNorm_1", f"{dst}.ln2")
        read.dense(sd, f"{b}/moe/router", f"{dst}.moe.router")
        sd[f"{dst}.moe.up"] = read.tensor(f"{b}/moe/up")
        sd[f"{dst}.moe.down"] = read.tensor(f"{b}/moe/down")
    read.norm(sd, "LayerNorm_0", "norm")
    read.dense(sd, "head", "head")

    _, seq_len, dim = pos.shape
    up = sd["blocks.0.moe.up"] if depth else torch.zeros(1, dim, 4 * dim)
    with torch.device("meta"):
        expected = MoEClassifier(
            seq_len=seq_len, dim=dim, depth=depth, heads=1,
            num_experts=up.shape[0],
            input_dim=1 if token_mode else sd["embed.weight"].shape[1],
            num_classes=sd["head.weight"].shape[0],
            vocab_size=sd["embed.weight"].shape[0] if token_mode else None,
            dtype=torch.float32).state_dict()
    return _checked(sd, expected, read.leftover(), "MoEClassifier")


def moe_flax_from_state_dict(sd: dict[str, torch.Tensor]) -> dict:
    """The flax ``MoEClassifier`` tree (``{"params": {...}}`` of float32
    numpy arrays) for the port's state_dict: the inverse of
    ``moe_state_dict_from_flax``, exact both ways."""
    tree: dict = {"pos_emb": _state_array(sd, "pos_emb")}
    tree["embed"] = ({"embedding": _state_array(sd, "embed.weight")}
                     if "embed.bias" not in sd else _flax_dense(sd, "embed"))
    for i in range(_depth(sd)):
        src = f"blocks.{i}"
        tree[f"block{i}"] = {
            "LayerNorm_0": _flax_norm(sd, f"{src}.ln1"),
            "attn": {"qkv": _flax_dense(sd, f"{src}.attn.qkv", bias=False),
                     "out": _flax_dense(sd, f"{src}.attn.out", bias=False)},
            "LayerNorm_1": _flax_norm(sd, f"{src}.ln2"),
            "moe": {"router": _flax_dense(sd, f"{src}.moe.router"),
                    "up": _state_array(sd, f"{src}.moe.up"),
                    "down": _state_array(sd, f"{src}.moe.down")},
        }
    tree["LayerNorm_0"] = _flax_norm(sd, "norm")
    tree["head"] = _flax_dense(sd, "head")
    params = {"params": tree}
    # The forward conversion checks keys and shapes against the model.
    moe_state_dict_from_flax(params)
    return params


def vit_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """The port's ``ViT`` state_dict (float32) for a flax ``ViT`` tree
    (``{"params": {...}}`` or the inner dict): the patch conv's HWIO kernel
    becomes OIHW, Dense kernels (in, out) become (out, in), ``pos_embed``
    keeps its (1, N, dim) shape, and flax's auto names map as the
    SeqFormer's (``block{i}/LayerNorm_0`` before attention, ``LayerNorm_1``
    before the MLP, a top-level ``LayerNorm_0`` before pooling)."""
    from .models.vit import ViT

    tree = params.get("params", params)
    read = _FlaxReader(tree)
    depth = sum(1 for k in tree if k.startswith("block"))
    kernel = read.tensor("embed/kernel")
    if kernel.dim() != 4 or kernel.shape[0] != kernel.shape[1]:
        raise ValueError(f"embed/kernel must be a square HWIO patch kernel, "
                         f"got {tuple(kernel.shape)}")
    sd: dict[str, torch.Tensor] = {
        "embed.weight": kernel.permute(3, 2, 0, 1).contiguous(),
        "embed.bias": read.tensor("embed/bias"),
        "pos_embed": read.tensor("pos_embed")}
    if sd["pos_embed"].dim() != 3 or sd["pos_embed"].shape[0] != 1:
        raise ValueError(f"pos_embed must be (1, N, dim), got "
                         f"{tuple(sd['pos_embed'].shape)}")
    for i in range(depth):
        b, dst = f"block{i}", f"blocks.{i}"
        read.norm(sd, f"{b}/LayerNorm_0", f"{dst}.ln1")
        read.dense(sd, f"{b}/attn/qkv", f"{dst}.attn.qkv", bias=False)
        read.dense(sd, f"{b}/attn/out", f"{dst}.attn.out")
        read.norm(sd, f"{b}/LayerNorm_1", f"{dst}.ln2")
        read.dense(sd, f"{b}/mlp/up", f"{dst}.mlp.up")
        read.dense(sd, f"{b}/mlp/down", f"{dst}.mlp.down")
    read.norm(sd, "LayerNorm_0", "norm")
    read.dense(sd, "head", "head")

    patch, dim = kernel.shape[0], kernel.shape[3]
    grid = math.isqrt(sd["pos_embed"].shape[1])
    with torch.device("meta"):
        expected = ViT(num_classes=sd["head.weight"].shape[0], patch=patch,
                       dim=dim, depth=depth, heads=1,
                       image_size=grid * patch, dtype=torch.float32
                       ).state_dict()
    return _checked(sd, expected, read.leftover(), "ViT")


def vit_flax_from_state_dict(sd: dict[str, torch.Tensor]) -> dict:
    """The flax ``ViT`` tree (``{"params": {...}}`` of float32 numpy arrays)
    for the port's state_dict: the inverse of ``vit_state_dict_from_flax``,
    exact both ways."""
    tree: dict = {"embed": {"kernel": _state_kernel(sd, "embed.weight"),
                            "bias": _state_array(sd, "embed.bias")},
                  "pos_embed": _state_array(sd, "pos_embed")}
    for i in range(_depth(sd)):
        src = f"blocks.{i}"
        tree[f"block{i}"] = {
            "LayerNorm_0": _flax_norm(sd, f"{src}.ln1"),
            "attn": {"qkv": _flax_dense(sd, f"{src}.attn.qkv", bias=False),
                     "out": _flax_dense(sd, f"{src}.attn.out")},
            "LayerNorm_1": _flax_norm(sd, f"{src}.ln2"),
            "mlp": {"up": _flax_dense(sd, f"{src}.mlp.up"),
                    "down": _flax_dense(sd, f"{src}.mlp.down")},
        }
    tree["LayerNorm_0"] = _flax_norm(sd, "norm")
    tree["head"] = _flax_dense(sd, "head")
    params = {"params": tree}
    # The forward conversion checks keys and shapes against the model.
    vit_state_dict_from_flax(params)
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
