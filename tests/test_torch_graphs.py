"""The port's CUDA graphs (``ai4e_tpu_torch.runtime.registry``), on the card
only: every test is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. This file imports no JAX, so it runs
on a GPU machine that has none::

    python -m pytest tests/test_torch_graphs.py -q

- a bucket's replay equals an eager ``apply_fn`` on the same batch, for each
  served model at small widths;
- the kernels' launch counters go up on every replay by what the capture
  launched;
- a capture that fails (a host sync inside ``apply_fn``) raises, and nothing
  serves that bucket;
- a reload between two replays changes the replay's output to the new
  weights';
- the split-phase surface gives ``run_batch``'s answer.
"""

import numpy as np
import pytest
import torch

from ai4e_tpu_torch import ops
from ai4e_tpu_torch.runtime.families import build_servable
from ai4e_tpu_torch.runtime.registry import ModelRuntime

pytestmark = pytest.mark.cuda

TILE = 32
UNET = dict(tile=TILE, widths=(8, 16), num_classes=4, buckets=(1, 4))
SEQ = dict(seq_len=128, input_dim=24, dim=32, depth=2, heads=2,
           num_classes=16, vocab_size=256, attention="flash", buckets=(1, 4))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def batch_for(family: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if family == "unet":
        return rng.integers(0, 256, (n, TILE, TILE, 3), np.uint8)
    return rng.integers(0, SEQ["vocab_size"], (n, SEQ["seq_len"])).astype(
        np.int32)


def served(family: str):
    rt = ModelRuntime(device="cuda")
    servable = rt.register(build_servable(family, **(
        UNET if family == "unet" else SEQ)))
    rt.warmup()
    return rt, servable


def eager(servable, batch: np.ndarray):
    with torch.inference_mode():
        out = servable.apply_fn(servable.module,
                                torch.from_numpy(batch).cuda())
    if isinstance(out, dict):
        return {k: v.cpu().numpy() for k, v in out.items()}
    return out.cpu().numpy()


def same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                            for k in a)
    return np.array_equal(a, b)


@pytest.mark.parametrize("family", ["unet", "seqformer"])
def test_replay_equals_eager(cuda, family):
    rt, servable = served(family)
    for bucket in servable.batch_buckets:
        assert (servable.name, bucket) in rt.graphs
        x = batch_for(family, bucket, seed=bucket)
        got = rt.run_batch(servable.name, x)
        want = eager(servable, x)
        if family == "unet":
            # cuDNN may pick another algorithm for the graph than eagerly:
            # per-class counts within 1% of the pixels (chip_smoke phase 4).
            assert np.abs(got["counts"].astype(np.int64)
                          - want["counts"]).max() <= 0.01 * TILE * TILE
        else:
            assert same(got, want)


def test_replays_add_the_captured_launches(cuda):
    rt, servable = served("seqformer")
    graph = rt.graphs[(servable.name, 4)]
    assert graph.launches == {"flash_attention": SEQ["depth"]}
    before = ops.launch_counts()
    for _ in range(3):
        rt.run_batch(servable.name, batch_for("seqformer", 4))
    after = ops.launch_counts()
    assert after["flash_attention"] - before["flash_attention"] == \
        3 * SEQ["depth"]
    rt, servable = served("unet")
    before = ops.launch_counts()
    rt.run_batch(servable.name, batch_for("unet", 4))
    after = ops.launch_counts()
    assert after["normalize_image"] - before["normalize_image"] == 1
    assert after["fused_seg_postprocess"] - before["fused_seg_postprocess"] \
        == 1


def test_capture_failure_raises_and_serves_nothing(cuda):
    rt, servable = served("seqformer")
    apply_fn = servable.apply_fn

    def syncing(module, batch):
        out = apply_fn(module, batch)
        float(out.sum())  # a host sync: illegal while capturing
        return out

    servable.apply_fn = syncing
    before = ops.launch_counts()["flash_attention"]
    with pytest.raises(RuntimeError):
        rt.run_batch(servable.name, batch_for("seqformer", 2))
    # The eager run before the capture launched; the failed capture did not.
    assert ops.launch_counts()["flash_attention"] - before == \
        len(servable.module.blocks)
    assert (servable.name, 2) not in rt.graphs
    assert (servable.name, 2) not in rt._executed_shapes
    servable.apply_fn = apply_fn
    x = batch_for("seqformer", 4)
    assert same(rt.run_batch(servable.name, x), eager(servable, x))


def test_reload_between_replays_changes_the_replay(cuda):
    rt, servable = served("seqformer")
    x = batch_for("seqformer", 4, seed=3)
    before = rt.run_batch(servable.name, x)
    tree = servable.flax_from_state_dict(servable.module.state_dict())
    tree["params"]["head"]["bias"] = tree["params"]["head"]["bias"] + 1.0
    rt.reload_params(servable.name, tree)
    after = rt.run_batch(servable.name, x)
    np.testing.assert_allclose(after, before + 1.0, rtol=0, atol=1e-5)
    assert same(after, eager(servable, x))
    assert servable.params_version == 2


@pytest.mark.parametrize("family", ["unet", "seqformer"])
def test_split_phases_equal_run_batch(cuda, family):
    rt, servable = served(family)
    x = batch_for(family, 4, seed=5)
    want = rt.run_batch(servable.name, x)
    dev, _ = rt.h2d_resident(servable.name, x)
    out, label, _ = rt.execute_resident(servable.name, dev)
    got, _ = rt.fetch_resident(out)
    assert label == "execute"
    assert same(got, want)
    assert rt.graph_pool_bytes() > 0
