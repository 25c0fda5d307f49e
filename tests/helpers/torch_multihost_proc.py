"""Subprocess body of the port's multi-process serving test: N gloo ranks
on the CPU, rank 0 broadcasts batches, the others mirror
(``ai4e_tpu_torch/parallel/multihost.py``); the port's counterpart of
``multihost_proc.py``. Run: torch_multihost_proc.py <rank> <nprocs> <port>.
"""

import os
import sys

rank, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                  WORLD_SIZE=str(nprocs), RANK=str(rank))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import ai4e_tpu_torch.parallel.multihost as mh_mod  # noqa: E402
from ai4e_tpu_torch.parallel.multihost import MultihostRuntime  # noqa: E402
from ai4e_tpu_torch.parallel.sharding import (  # noqa: E402
    MeshSpec, init_distributed, is_primary, make_mesh, process_count)
from ai4e_tpu_torch.runtime.families import build_servable  # noqa: E402
from ai4e_tpu_torch.runtime.registry import ModelRuntime  # noqa: E402

torch.set_num_threads(1)
assert init_distributed("cpu") and process_count() == nprocs

# Every rank on dp. Two servables, so the bridge carries both wire dtypes:
# float32 (echo) and the seqformer family's float16 default.
mesh = make_mesh(MeshSpec(dp=nprocs), device_type="cpu")
runtime = ModelRuntime("cpu", mesh=mesh)
runtime.register(build_servable("echo", size=4, buckets=(nprocs,)))
runtime.register(build_servable(
    "seqformer", name="lc16", seq_len=16, input_dim=8, dim=16, depth=1,
    heads=2, num_classes=4, attention="full", buckets=(nprocs,), mesh=mesh))
runtime.warmup()
mh = MultihostRuntime(runtime)

if rank == 1:
    # Sabotage follower 1's FOURTH shard fetch (batches 1-3 are the happy
    # path below): it must run a zeros shard, stay in lockstep, and report
    # its rows poisoned on the gather.
    real_fetch = mh_mod._fetch
    calls = {"n": 0}

    def flaky_fetch(url, token, timeout_s=60.0):
        calls["n"] += 1
        if calls["n"] == 4:
            raise TimeoutError("injected fetch failure")
        return real_fetch(url, token, timeout_s)

    mh_mod._fetch = flaky_fetch

if is_primary():
    n = nprocs
    batch = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    np.testing.assert_allclose(mh.run_batch("echo", batch), batch, rtol=1e-6)
    np.testing.assert_allclose(mh.run_batch("echo", batch * 3), batch * 3,
                               rtol=1e-6)
    # Sharded ingestion: each follower gets only its rows.
    expected = batch.nbytes * (nprocs - 1) // nprocs
    assert mh.last_egress_bytes == expected, (mh.last_egress_bytes, expected)
    assert 0.0 < mh.last_ingest_s < 5.0, mh.last_ingest_s
    # The float16 wire through the bridge, against one device's answer.
    seqs = np.random.default_rng(0).standard_normal(
        (n, 16, 8)).astype(np.float16)
    logits = mh.run_batch("lc16", seqs)
    assert logits.shape == (n, 4) and np.isfinite(logits).all()
    single = ModelRuntime("cpu")
    single.register(build_servable(
        "seqformer", name="lc16", seq_len=16, input_dim=8, dim=16, depth=1,
        heads=2, num_classes=4, attention="full", buckets=(n,)))
    # One row a rank against n rows on one device: CPU kernels may sum a
    # batch's rows in another order.
    np.testing.assert_allclose(logits, single.run_batch("lc16", seqs),
                               rtol=1e-5, atol=1e-6)
    assert mh.last_egress_bytes == seqs.nbytes * (nprocs - 1) // nprocs
    # Batch 4: follower 1's fetch fails; exactly its rows are poisoned.
    out4, poisoned = mh.run_batch_report("echo", batch)
    expect_rows = {i for a, b in mh._plan("echo", batch.shape)[1]
                   for i in range(a, b)}
    assert poisoned == frozenset(expect_rows), (poisoned, expect_rows)
    good = sorted(set(range(n)) - expect_rows)
    np.testing.assert_allclose(out4[good], batch[good], rtol=1e-6)
    # Batch 5: healed.
    out5, poisoned5 = mh.run_batch_report("echo", batch * 2)
    assert poisoned5 == frozenset(), poisoned5
    np.testing.assert_allclose(out5, batch * 2, rtol=1e-6)
    mh.shutdown_followers()
    print("PRIMARY_OK", flush=True)
else:
    mh.follower_loop()
    assert 0.0 < mh.last_ingest_s < 5.0, mh.last_ingest_s
    print("FOLLOWER_OK", flush=True)
torch.distributed.destroy_process_group()
