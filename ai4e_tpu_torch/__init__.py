"""PyTorch / CUDA port of ``ai4e_tpu`` for an NVIDIA H100.

The package mirrors ``ai4e_tpu``'s layout module for module and imports
nothing of it, nor JAX. Plain tensor code is PyTorch; each Pallas kernel of
the JAX package becomes a hand-written CUDA C++ kernel under ``csrc/``,
built for ``sm_90a`` at first use (``ops/_native.py``), beside a plain
PyTorch version that CPU tensors take.

Entry points: ``python -m ai4e_tpu_torch worker --models <spec.json>``
serves; ``python -m ai4e_tpu_torch control-plane --routes <routes.json>``
runs the gateway, task store, broker and dispatchers in front of workers
(this half imports neither torch nor JAX);
``python -m ai4e_tpu_torch.train.make_checkpoints --out <dir> --only
longcontext moe`` trains the checkpoints the worker restores.
"""
