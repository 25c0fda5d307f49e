"""The first call into MKL's vector math (VML) in a process, made by two
intra-op threads at once, against the same call made again::

    python scripts/cpu_first_exp.py [--set-up none|port|tiny-exp]
        [--trials 4000] [--parallel 16] [--threads 2]

PyTorch's CPU ``torch.exp`` of a float32 tensor (and ``tanh``, ``log``...)
calls MKL's VML in chunks, one chunk a intra-op thread. This script forks
``--trials`` children from a parent that has made no VML call and run no
OpenMP region; each child computes ``torch.exp`` of the same (4, 2, 64, 64)
float32 tensor twice on ``--threads`` threads (the plain flash attention's
score shape in ``tests/test_torch_train.py``'s masters test) and compares
the two calls bit for bit. ``--set-up`` is what a child does first:
``none``; ``port``, the port's CPU set-up (``device.resolve_device("cpu")``);
``tiny-exp``, ``torch.exp`` of one element (the same call the set-up makes).
For each child whose first call differs it reports which (batch, head)
slices differ and both calls' largest relative error against float64.
Prints one JSON line: the set-up, the trials, how many first calls differ,
and those reports (at most 10).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ai4e_tpu_torch.device import resolve_device  # noqa: E402 (no VML call)


def child(x: torch.Tensor, set_up: str, out_fd: int) -> None:
    if set_up == "port":
        resolve_device("cpu")
    elif set_up == "tiny-exp":
        torch.exp(torch.zeros(1))
    first, second = torch.exp(x), torch.exp(x)
    if torch.equal(first, second):
        os._exit(0)
    exact = torch.exp(x.double())

    def rel_err(t):
        return float(((t.double() - exact).abs() / exact).max())

    report = {"slices_differ": (first != second).flatten(2).any(-1)
              .int().tolist(),
              "first_rel_err": rel_err(first),
              "second_rel_err": rel_err(second)}
    os.write(out_fd, (json.dumps(report) + "\n").encode())
    os._exit(1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set-up", choices=("none", "port", "tiny-exp"),
                    default="none")
    ap.add_argument("--trials", type=int, default=4000)
    ap.add_argument("--parallel", type=int, default=16)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    x = torch.randn(4, 2, 64, 64,
                    generator=torch.Generator().manual_seed(0)) * 2
    # The parent's torch import left threads behind; a child only runs
    # torch.exp, which takes none of their locks.
    warnings.simplefilter("ignore", DeprecationWarning)
    read_fd, write_fd = os.pipe()
    differ = done = 0
    live: set[int] = set()
    while done < args.trials:
        while len(live) < args.parallel and done + len(live) < args.trials:
            pid = os.fork()
            if pid == 0:
                os.close(read_fd)
                child(x, args.set_up, write_fd)
            live.add(pid)
        pid, status = os.wait()
        live.discard(pid)
        done += 1
        differ += os.waitstatus_to_exitcode(status) != 0
    os.close(write_fd)
    with os.fdopen(read_fd) as reports:
        found = [json.loads(line) for line in reports]
    print(json.dumps({"set_up": args.set_up, "threads": args.threads,
                      "trials": args.trials, "first_call_differs": differ,
                      "reports": found[:10]}))


if __name__ == "__main__":
    main()
