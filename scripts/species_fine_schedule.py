"""The species_fine recipe's held-out accuracy against its step count, on
the CPU, for the PyTorch port and (with ``--jax``, where JAX is installed)
the JAX package, from the same seeded task: where its 250-step default
lands against the 0.85 gate, and where a longer schedule does.

    python scripts/species_fine_schedule.py --steps 250 500 --seeds 0 1 --jax

Prints one JSON line a run: package, steps, seed, accuracy, seconds.
"""

from __future__ import annotations

import argparse
import json
import time


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, nargs="+", default=[250, 500])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--jax", action="store_true",
                        help="also the JAX package's recipe")
    parser.add_argument("--threads", type=int, default=4)
    args = parser.parse_args()

    import torch

    from ai4e_tpu_torch.train import make_checkpoints as mc

    torch.set_num_threads(args.threads)
    for steps in args.steps:
        for seed in args.seeds:
            t0 = time.perf_counter()
            result = mc.train_species_fine(steps=steps, seed=seed,
                                           device="cpu")
            print(json.dumps({"package": "ai4e_tpu_torch", "steps": steps,
                              "seed": seed, **result["eval"],
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    if args.jax:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from ai4e_tpu.train import make_checkpoints as jax_mc

        for steps in args.steps:
            for seed in args.seeds:
                t0 = time.perf_counter()
                result = jax_mc.train_species_fine(steps=steps, seed=seed)
                print(json.dumps({"package": "ai4e_tpu", "steps": steps,
                                  "seed": seed, **result["eval"],
                                  "seconds": time.perf_counter() - t0}),
                      flush=True)


if __name__ == "__main__":
    main()
