"""Device choice for the port's entry points: the card unless the caller
asks for the CPU."""

from __future__ import annotations

import threading

import torch

_cpu_lock = threading.Lock()
_cpu_ready = False


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises if CUDA is asked for and missing:
    nothing falls back to the CPU unless the caller passed ``"cpu"``. The
    first CPU device of a process also runs ``_set_up_cpu``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    if dev.type == "cpu":
        _set_up_cpu()
    return dev


def _set_up_cpu() -> None:
    """Make the process's first call into MKL's vector math (VML) from one
    thread. PyTorch's CPU ``exp``, ``tanh``, ``log``... of a float tensor
    call VML in chunks on the intra-op threads; when a process's first VML
    call comes from two threads at once, one thread's chunk is sometimes
    computed by a less exact kernel (about 1e-4 relative against 1e-7), on
    that call only (``scripts/cpu_first_exp.py``). ``exp`` of one element
    runs on the calling thread alone."""
    global _cpu_ready
    with _cpu_lock:
        if not _cpu_ready:
            torch.exp(torch.zeros(1))
            _cpu_ready = True
