"""Deterministic checkpoint factory — counterpart of
``ai4e_tpu/train/make_checkpoints.py``, the sequence recipes.

``train_longcontext`` trains the ``longcontext`` SeqFormer and
``train_moe`` the ``moe`` MoEClassifier (both token mode) on the seeded
marker task at the serving geometry, with float32 master weights and
optax's ``adamw(lr, weight_decay=1e-5)``, and measure their held-out
accuracy (the MoE with the capacity dispatch it serves);
``make_checkpoint`` refuses weights below the gate and saves the rest,
through the family's converter, as the ``.npz`` flax tree the port's worker
restores (``cli.restore_checkpoint``), with a ``MANIFEST.json`` entry in
the JAX package's shape. The image recipes of the JAX package stay in
``RECIPES`` and raise, naming their ROADMAP items.

CLI: ``python -m ai4e_tpu_torch.train.make_checkpoints --out DIR --only
longcontext moe [--fast] [--device cpu]`` (default device: ``cuda``).
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from ..convert import (moe_flax_from_state_dict, save_npz,
                       seqformer_flax_from_state_dict)
from ..device import resolve_device

log = logging.getLogger("ai4e_tpu_torch.make_checkpoints")


def longcontext_batch(rng: np.random.Generator, batch: int, seq_len: int,
                      vocab_size: int, num_classes: int = 16):
    """Marker-token classification: sequences of uniform-random background
    ids with ~3% of positions overwritten by the label class's marker id
    (the top ``num_classes`` ids of the vocab). The JAX package's draws, in
    its order, so a seed gives the same arrays."""
    markers = max(4, seq_len // 32)
    toks = rng.integers(0, vocab_size - num_classes, (batch, seq_len))
    labels = rng.integers(0, num_classes, (batch,))
    for i in range(batch):
        pos = rng.choice(seq_len, size=markers, replace=False)
        toks[i, pos] = vocab_size - num_classes + labels[i]
    return toks.astype(np.int32), labels.astype(np.int32)


def _eval_marker_task(model, seq_len: int, vocab_size: int,
                      num_classes: int, seed: int, rounds: int = 4,
                      batch: int = 16) -> float:
    """Held-out accuracy on the marker task: ``rounds`` batches drawn from
    seed + 1, as the JAX package draws them (64 sequences by default), on
    the model's device."""
    device = next(model.parameters()).device
    eval_rng = np.random.default_rng(seed + 1)
    hits = total = 0
    with torch.inference_mode():
        for _ in range(rounds):
            toks, lab = longcontext_batch(eval_rng, batch, seq_len,
                                          vocab_size, num_classes)
            logits = model(torch.from_numpy(toks).to(device))
            hits += int((logits.argmax(-1).cpu().numpy() == lab).sum())
            total += len(lab)
    return hits / total


def resolve_train_attention(attention: str, device=None) -> str:
    """``train-auto`` -> the training attention for the device: the
    differentiable flash kernels on ``cuda`` (no S x S score matrix in
    either pass), plain materialised ``full`` attention on the CPU. Any
    explicit strategy passes through."""
    if attention != "train-auto":
        return attention
    resolved = "flash" if resolve_device(device).type == "cuda" else "full"
    log.info("train-auto attention resolved to %r", resolved)
    return resolved


def _train_marker_task(model, name: str, steps: int, batch: int,
                       seq_len: int, vocab_size: int, num_classes: int,
                       seed: int, lr: float, device) -> dict:
    """``steps`` AdamW steps of ``model`` on marker batches drawn from
    ``seed``, the model left in eval mode; returns the run's record:
    ``losses`` and ``phases_ms`` per step (forward, backward, optimizer),
    ``loop_seconds`` of the step loop on the host clock and ``peak_bytes``
    of device memory (0 on the CPU)."""
    from .step import Trainer, adamw, cross_entropy_loss

    tr = Trainer(model, cross_entropy_loss,
                 optimizer=lambda p: adamw(p, lr, weight_decay=1e-5),
                 device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rng = np.random.default_rng(seed)
    losses, phases = [], []
    t0 = time.perf_counter()
    for step in range(steps):
        toks, lab = longcontext_batch(rng, batch, seq_len, vocab_size,
                                      num_classes)
        loss, ms = tr.train_step_phases(toks, lab)
        losses.append(loss)
        phases.append(ms)
        if step % 25 == 0:
            log.info("%s step %d loss %.4f", name, step, loss)
    loop_seconds = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    model.eval()
    return {"losses": losses, "phases_ms": phases,
            "loop_seconds": loop_seconds, "peak_bytes": peak}


def train_longcontext(steps: int = 200, seq_len: int = 4096, batch: int = 8,
                      seed: int = 0, dim: int = 256, depth: int = 4,
                      heads: int = 2, vocab_size: int = 32768,
                      num_classes: int = 16, attention: str = "train-auto",
                      serve_attention: str = "flash", lr: float = 1e-3,
                      device=None) -> dict:
    """SeqFormer (token mode) on the marker task at the serving geometry:
    seq_len and vocab are baked into the parameter tree (pos_emb, Embed),
    so the trained shape is the serving shape. The body computes in
    bfloat16 on float32 masters. Returns the float32 ``state_dict``, the
    ``eval`` accuracy, ``family``/``kwargs`` for the manifest, and the run's
    record: ``losses`` and ``phases_ms`` per step (forward, backward,
    optimizer), ``loop_seconds`` of the step loop on the host clock and
    ``peak_bytes`` of device memory (0 on the CPU)."""
    from ..models import create_seqformer

    device = resolve_device(device)
    attention = resolve_train_attention(attention, device)
    model = create_seqformer(
        generator=torch.Generator().manual_seed(seed), seq_len=seq_len,
        input_dim=64, dim=dim, depth=depth, heads=heads,
        num_classes=num_classes, attention=attention, vocab_size=vocab_size,
        param_dtype=torch.float32, device=device)
    record = _train_marker_task(model, "longcontext", steps, batch,
                                seq_len, vocab_size, num_classes, seed, lr,
                                device)
    acc = _eval_marker_task(model, seq_len, vocab_size, num_classes, seed)
    log.info("longcontext eval acc %.3f", acc)
    return {"state_dict": {k: v.detach().cpu()
                           for k, v in model.state_dict().items()},
            "eval": {"accuracy": round(acc, 4)},
            "family": "seqformer",
            # Everything serving needs to rebuild the exact tree.
            "kwargs": {"seq_len": seq_len, "input_dim": 64, "dim": dim,
                       "depth": depth, "heads": heads,
                       "num_classes": num_classes, "vocab_size": vocab_size,
                       "attention": serve_attention},
            "batch": batch, **record}


def train_moe(steps: int = 200, seq_len: int = 1024, batch: int = 16,
              seed: int = 0, dim: int = 128, depth: int = 2, heads: int = 1,
              num_experts: int = 8, vocab_size: int = 8192,
              num_classes: int = 16, capacity_factor: float = 1.25,
              attention: str = "train-auto", serve_attention: str = "flash",
              lr: float = 1e-3, device=None) -> dict:
    """MoEClassifier (token mode) on the longcontext marker task. It
    trains with dense dispatch (every expert on every token) and evaluates
    with the capacity dispatch it will serve, on the same modules (their
    ``dispatch`` switched, no re-init): overflow drops make capacity the
    stricter eval. float32 masters, optax's ``adamw(lr,
    weight_decay=1e-5)``. Returns what ``train_longcontext`` returns, with
    JAX's ``kwargs`` (capacity dispatch)."""
    from ..models import create_moe

    device = resolve_device(device)
    attention = resolve_train_attention(attention, device)
    model = create_moe(
        generator=torch.Generator().manual_seed(seed), seq_len=seq_len,
        input_dim=64, dim=dim, depth=depth, heads=heads,
        num_experts=num_experts, num_classes=num_classes,
        attention=attention, dispatch="dense", vocab_size=vocab_size,
        param_dtype=torch.float32, device=device)
    record = _train_marker_task(model, "moe", steps, batch, seq_len,
                                vocab_size, num_classes, seed, lr, device)
    model.set_dispatch("capacity", capacity_factor)
    acc = _eval_marker_task(model, seq_len, vocab_size, num_classes, seed)
    log.info("moe eval (capacity dispatch) acc %.3f", acc)
    return {"state_dict": {k: v.detach().cpu()
                           for k, v in model.state_dict().items()},
            "eval": {"accuracy": round(acc, 4)},
            "family": "moe",
            "kwargs": {"seq_len": seq_len, "input_dim": 64, "dim": dim,
                       "depth": depth, "heads": heads,
                       "num_experts": num_experts,
                       "num_classes": num_classes, "vocab_size": vocab_size,
                       "dispatch": "capacity",
                       "capacity_factor": capacity_factor,
                       "attention": serve_attention},
            "batch": batch, **record}


def _unported(item: str):
    def recipe(**_):
        raise NotImplementedError(f"this recipe is not ported yet ({item})")
    return recipe


RECIPES = {
    "landcover": _unported(
        "ROADMAP A16: the UNet's backward, its bf16 GroupNorm and gelu"),
    "landcover128": _unported(
        "ROADMAP A16: the UNet's backward, its bf16 GroupNorm and gelu"),
    "megadetector": _unported(
        "ROADMAP A16.4: the detector's training; its model, A10, is ported"),
    "species": _unported(
        "ROADMAP A16.4: the ResNet's training; its model, A10, is ported"),
    "species_fine": _unported(
        "ROADMAP A16.4: the ResNet's training; its model, A10, is ported"),
    "longcontext": train_longcontext,
    "moe": train_moe,
}

# Eval floor every produced checkpoint must clear (chance on the marker
# task: 1/16).
MIN_EVAL = 0.85


#: Each trained family's state_dict -> its flax tree (what ``save_npz``
#: writes and JAX's ``load_params`` and the port's ``reload_params`` read).
TO_FLAX = {"seqformer": seqformer_flax_from_state_dict,
           "moe": moe_flax_from_state_dict}


def make_checkpoint(name: str, out_dir: str, min_eval: float = MIN_EVAL,
                    result: dict | None = None, **overrides) -> dict:
    """Train one recipe (or take its already trained ``result``), refuse it
    below ``min_eval``, save ``out_dir/<name>.npz`` and record it in
    ``out_dir/MANIFEST.json``; returns the manifest entry (family, kwargs,
    eval, path)."""
    if result is None:
        result = RECIPES[name](**overrides)
    (metric_name, value), = result["eval"].items()
    if value < min_eval:
        raise AssertionError(
            f"{name}: {metric_name}={value} below {min_eval} — training did "
            "not converge; refusing to ship untrained weights")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(out_dir, f"{name}.npz"))
    save_npz(TO_FLAX[result["family"]](result["state_dict"]), path)
    entry = {"family": result["family"], "kwargs": result["kwargs"],
             "eval": result["eval"], "path": path}
    manifest_path = os.path.join(out_dir, "MANIFEST.json")
    manifest = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
    manifest[name] = entry
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)
    log.info("saved %s -> %s (%s=%.3f)", name, path, metric_name, value)
    return entry


#: --fast: the JAX package's small CI geometry.
FAST = {"longcontext": {"steps": 160, "seq_len": 256, "dim": 32, "depth": 2,
                        "heads": 2, "vocab_size": 512, "batch": 16},
        "moe": {"steps": 160, "seq_len": 128, "dim": 32, "heads": 1,
                "num_experts": 4, "vocab_size": 256, "batch": 16}}


def main(argv=None) -> None:
    import argparse

    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="checkpoints")
    parser.add_argument("--only", nargs="+", choices=sorted(RECIPES),
                        default=["longcontext", "moe"])
    parser.add_argument("--fast", action="store_true",
                        help="the small CI geometry")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    evals = {}
    for name in args.only:
        overrides = FAST.get(name, {}) if args.fast else {}
        evals[name] = make_checkpoint(name, args.out, device=args.device,
                                      **overrides)["eval"]
    print(json.dumps(evals))


if __name__ == "__main__":
    main()
