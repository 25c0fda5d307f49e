"""Land cover's answer for a tile does not depend on the batch it rides in
(ROADMAP C8), on the port as on the JAX package.

The same weights (JAX's ``build_unet`` at seed 0, saved flat for the port
by ``convert.save_npz``) serve 16 tiles of 64 px at widths (16, 32): each
tile alone (bucket 1), in batches of 4 and in one batch of 16. The
per-class pixel counts must be byte-equal across the three. The port's
cause was ATen's CPU GroupNorm on a ``channels_last`` input, whose
reduction splits by batch and thread; ``models/unet.py`` ``ConvBlock``
normalizes an NCHW-contiguous copy instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ai4e_tpu.runtime.families import build_unet as jax_build_unet
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.cli import restore_checkpoint
from ai4e_tpu_torch.runtime.families import build_servable
from ai4e_tpu_torch.runtime.registry import ModelRuntime

TILE = 64
WIDTHS = (16, 32)
N = 16
BATCHES = {"alone": 1, "by4": 4, "by16": 16}


@pytest.fixture(scope="module")
def tiles():
    return np.random.default_rng(0).integers(0, 256, (N, TILE, TILE, 3),
                                             np.uint8)


@pytest.fixture(scope="module")
def jax_servable():
    return jax_build_unet(tile=TILE, widths=WIDTHS, num_classes=4,
                          buckets=(1, 4, 16))


@pytest.fixture(scope="module")
def port_runtime(jax_servable, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("c8") / "seed0.npz")
    convert.save_npz(jax.tree.map(np.asarray, jax_servable.params), path)
    servable = build_servable("unet", name="landcover", tile=TILE,
                              widths=WIDTHS, num_classes=4,
                              buckets=(1, 4, 16))
    restore_checkpoint(servable, path)
    runtime = ModelRuntime(device="cpu")
    runtime.register(servable)
    runtime.warmup()
    return runtime


def counts_by(run, tiles: np.ndarray, size: int) -> np.ndarray:
    return np.concatenate([np.asarray(run(tiles[i:i + size]))
                           for i in range(0, len(tiles), size)])


@pytest.mark.parametrize("package", ["port", "jax"])
def test_counts_are_byte_equal_in_every_batch(package, tiles, jax_servable,
                                              port_runtime):
    if package == "port":
        def run(batch):
            return port_runtime.run_batch("landcover", batch)["counts"]
    else:
        def run(batch):
            return jax_servable.apply_fn(jax_servable.params,
                                         jnp.asarray(batch))["counts"]
    got = {name: counts_by(run, tiles, size)
           for name, size in BATCHES.items()}
    assert got["alone"].shape == (N, 4)
    assert (got["alone"].sum(axis=1) == TILE * TILE).all()
    for name in ("by4", "by16"):
        assert got[name].tobytes() == got["alone"].tobytes(), name


def test_port_counts_are_jax_s_within_the_bfloat16_bound(tiles, jax_servable,
                                                          port_runtime):
    """The same tiles through both packages, all 16 in one batch: within
    1% of the pixels per class, the bound the land-cover tests hold (bf16
    rounds in different places)."""
    port = np.asarray(port_runtime.run_batch("landcover", tiles)["counts"])
    want = np.asarray(jax_servable.apply_fn(jax_servable.params,
                                            jnp.asarray(tiles))["counts"])
    assert np.abs(port.astype(np.int64) - want).max() <= 0.01 * TILE * TILE
