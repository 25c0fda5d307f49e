"""The port's runtime (``ai4e_tpu_torch.runtime.registry``) and batcher
(``ai4e_tpu_torch.runtime.batcher``) against the JAX package's, on the CPU:

- the split-phase surface (h2d -> execute -> fetch) equals ``run_batch``;
- the double-buffered batcher's answers equal the fused path's, for pipeline
  depths 1 and 2, and equal JAX's batcher's on the same requests;
- the staging ring and its eviction on a ladder swap (the regressions of
  ``tests/test_ladder.py``);
- ``reload_params`` against JAX's on the same new weights (land cover and
  longcontext at small widths, converted from flax's init): the same answers
  after the reload within the tolerances of ``test_torch_unet.py`` and
  ``test_torch_seqformer.py``; a mismatched tree is refused by both and
  serving is unchanged;
- a reload racing a stream of batches: every batch's answer is the old
  weights' or the new weights', never a mix;
- land cover's unfused path (float32 tiles, logits to the host) against
  JAX's: histograms within 1% of the pixels per class, and a compressed
  wire refused by both.
"""

import asyncio
import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai4e_tpu.metrics.registry import MetricsRegistry as JaxMetrics
from ai4e_tpu.parallel import MeshSpec, make_mesh
from ai4e_tpu.runtime.batcher import MicroBatcher as JaxBatcher
from ai4e_tpu.runtime.families import build_servable as jax_build
from ai4e_tpu.runtime.registry import ModelRuntime as JaxRuntime
from ai4e_tpu_torch.metrics import MetricsRegistry
from ai4e_tpu_torch.runtime.batcher import MicroBatcher
from ai4e_tpu_torch.runtime.families import build_servable
from ai4e_tpu_torch.runtime.registry import ModelRuntime, flax_spec

torch.set_num_threads(2)

TILE = 32
PIXELS = TILE * TILE
UNET = dict(tile=TILE, widths=(8, 16), num_classes=4, buckets=(1, 4))
SEQ = dict(seq_len=128, input_dim=24, dim=32, depth=2, heads=2,
           num_classes=16, vocab_size=256, attention="flash", buckets=(1, 4))
ECHO = dict(size=4, buckets=(1, 2, 4, 8))


def run(coro):
    return asyncio.run(coro)


def jax_runtime(family, **kw):
    mesh = make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    rt = JaxRuntime(mesh=mesh)
    servable = rt.register(jax_build(family, **kw))
    rt.warmup(parallel=False)
    return rt, servable


def port_runtime(family, params=None, **kw):
    """The port's runtime on the CPU serving ``family``, on the flax tree
    ``params`` when given (else its seed-0 weights)."""
    rt = ModelRuntime(device="cpu")
    servable = build_servable(family, **kw)
    if params is not None:
        servable.module.load_state_dict(servable.state_dict_from_flax(params))
    rt.register(servable)
    rt.warmup()
    return rt, servable


def numpy_tree(params):
    return jax.tree.map(np.array, params)


def images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, TILE, TILE, 3),
                                                np.uint8)


def sequences(n, seed=0):
    return np.random.default_rng(seed).integers(0, SEQ["vocab_size"],
                                                (n, SEQ["seq_len"])
                                                ).astype(np.int32)


def equal_trees(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal_trees(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


class TestSplitPhases:
    @pytest.mark.parametrize("family,kw,batch", [
        ("unet", UNET, lambda: images(4)),
        ("seqformer", SEQ, lambda: sequences(4)),
        ("echo", ECHO, lambda: np.arange(32, dtype=np.float32).reshape(8, 4)),
    ], ids=["landcover", "longcontext", "echo"])
    def test_h2d_execute_fetch_equals_run_batch(self, family, kw, batch):
        rt, servable = port_runtime(family, **kw)
        x = batch()
        want = rt.run_batch(servable.name, x)
        dev, h2d_w = rt.h2d_resident(servable.name, x)
        out, label, exec_w = rt.execute_resident(servable.name, dev)
        got, d2h_w = rt.fetch_resident(out)
        assert label == "execute"  # warmed: never a serving-path compile
        assert equal_trees(got, want)
        assert h2d_w[0] <= h2d_w[1] <= exec_w[0] <= exec_w[1] <= d2h_w[0] \
            <= d2h_w[1]
        assert rt.supports_split_phases()

    def test_first_run_of_a_shape_is_labelled_compile(self):
        rt, _ = port_runtime("echo", **ECHO)
        dev, _ = rt.h2d_resident("echo", np.ones((3, 4), np.float32))
        assert rt.execute_resident("echo", dev)[1] == "compile"
        assert rt.execute_resident("echo", dev)[1] == "execute"
        _, _, phases = rt.run_batch_phases("echo", np.ones((5, 4), np.float32))
        assert set(phases) == {"h2d", "compile", "d2h"}


def submit_many(batcher, n, size=4):
    async def main():
        await batcher.start()
        try:
            return await asyncio.gather(*(
                batcher.submit("echo", np.full((size,), i, np.float32))
                for i in range(n)))
        finally:
            await batcher.stop()
    return run(main())


class TestBatcher:
    def test_default_metric_set_is_jax_s(self):
        """The default batcher registers JAX's default set, the deadline
        counter of admission's batch-cut drops among it."""
        port, ref = MetricsRegistry(), JaxMetrics()
        b = MicroBatcher(port_runtime("echo", **ECHO)[0], metrics=port)
        JaxBatcher(jax_runtime("echo", **ECHO)[0], metrics=ref)
        assert set(port._metrics) == set(ref._metrics)
        assert b.pipeline_depth == 2 and len(b._executor._threads) == 0
        assert b._executor._max_workers == 2

    @pytest.mark.parametrize("depth", [0, -1])
    def test_depth_check_is_jax_s(self, depth):
        rt = port_runtime("echo", **ECHO)[0]
        jrt = jax_runtime("echo", **ECHO)[0]
        with pytest.raises(ValueError) as port_err:
            MicroBatcher(rt, metrics=MetricsRegistry(), pipeline_depth=depth)
        with pytest.raises(ValueError) as jax_err:
            JaxBatcher(jrt, metrics=JaxMetrics(), pipeline_depth=depth)
        assert str(port_err.value) == str(jax_err.value)

    @pytest.mark.parametrize("depth", [1, 2])
    def test_double_buffer_and_depth_give_jax_s_answers(self, depth):
        """Echo (x * 1) through the fused and the double-buffered path at
        ``depth``, against JAX's batcher on its runtime."""
        results = {}
        for double in (False, True):
            rt = port_runtime("echo", **ECHO)[0]
            batcher = MicroBatcher(rt, max_wait_ms=1.0,
                                   metrics=MetricsRegistry(),
                                   pipeline_depth=depth, double_buffer=double)
            assert batcher._double is double
            results[double] = submit_many(batcher, 12)
        jrt = jax_runtime("echo", **ECHO)[0]
        want = submit_many(JaxBatcher(jrt, max_wait_ms=1.0,
                                      metrics=JaxMetrics(),
                                      pipeline_depth=depth), 12)
        assert results[True] == results[False] == want

    def test_phase_windows_overlap_and_pad_accounting(self):
        rt = port_runtime("echo", **ECHO)[0]
        reg = MetricsRegistry()
        batcher = MicroBatcher(rt, max_wait_ms=1.0, metrics=reg,
                               double_buffer=True, measure_phases=True)
        submit_many(batcher, 16)
        counts = {}
        for _k, _n, labels, data in reg.histogram(
                "ai4e_device_phase_seconds", "").collect():
            counts[labels["phase"]] = counts.get(labels["phase"], 0) + \
                int(data["count"])
        assert counts.get("h2d", 0) > 0 and counts.get("execute", 0) > 0
        assert counts.get("d2h", 0) > 0
        assert counts.get("compile", 0) == 0  # warmed
        assert reg.gauge("ai4e_batch_overlap_ratio", "").value() >= 0.0
        assert reg.gauge("ai4e_batch_pad_ratio", "").value(model="echo") >= 0

    def test_staging_ring_alternates_and_reuses(self):
        rt, servable = port_runtime("echo", **ECHO)
        batcher = MicroBatcher(rt, metrics=MetricsRegistry(),
                               double_buffer=True, pipeline_depth=2)
        b1 = batcher._staging_buffer("echo", 8, servable)
        b2 = batcher._staging_buffer("echo", 8, servable)
        assert b1 is not b2
        assert batcher._staging_buffer("echo", 8, servable) is b1

    @pytest.mark.parametrize("ladder,new,kept", [
        ((1, 8, 64), (1, 16), 16), ((1, 16, 64), (1, 16), 16)],
        ids=["grow-new-ring", "shrink-only"])
    def test_staging_ring_evicted_on_ladder_swap(self, ladder, new, kept):
        rt, servable = port_runtime("echo", size=4, buckets=ladder)
        batcher = MicroBatcher(rt, metrics=MetricsRegistry(),
                               double_buffer=True, pipeline_depth=2)
        batcher._staging_buffer("echo", 64, servable)
        batcher._staging_buffer("echo", ladder[1], servable)
        rt.apply_ladder("echo", rt.prepare_buckets("echo", new))
        batcher._staging_buffer("echo", kept, servable)
        assert ("echo", 64) not in batcher._staging
        assert ("echo", kept) in batcher._staging

    def test_swap_between_cut_and_execute_pads_to_cut_time_bucket(self):
        from ai4e_tpu_torch.runtime.batcher import _Pending

        async def main():
            rt, _ = port_runtime("echo", size=4, buckets=(1, 64))
            batcher = MicroBatcher(rt, metrics=MetricsRegistry())
            loop = asyncio.get_running_loop()
            batcher._pending["echo"] = [
                _Pending(np.full((4,), i, np.float32), loop.create_future())
                for i in range(40)]
            batch, bucket = batcher._take_batch("echo")
            assert (len(batch), bucket) == (40, 64)
            rt.apply_ladder("echo", rt.prepare_buckets("echo", (1, 4, 8)))
            await batcher._execute(loop, "echo", batch, bucket)
            return [p.future.result() for p in batch]

        results = run(main())
        assert [r["echo"][0] for r in results] == list(range(40))


def reload_pair(family, kw, seed):
    """JAX's runtime and the port's on the same seed-0 flax weights, and a
    second flax tree (the JAX family's init from ``seed``) to reload."""
    jrt, jserv = jax_runtime(family, **kw)
    prt, pserv = port_runtime(family, params=numpy_tree(jserv.params), **kw)
    if family == "unet":
        from ai4e_tpu.models.unet import create_unet
        _, new = create_unet(jax.random.PRNGKey(seed), tile=TILE,
                             num_classes=kw["num_classes"],
                             widths=kw["widths"])
    else:
        from ai4e_tpu.models.seqformer import create_seqformer
        keys = ("seq_len", "input_dim", "dim", "depth", "heads",
                "num_classes", "vocab_size", "attention")
        _, new = create_seqformer(jax.random.PRNGKey(seed),
                                  **{k: kw[k] for k in keys})
    return (jrt, jserv), (prt, pserv), numpy_tree(new)


def check_landcover(port_out, jax_out):
    """Counts per class within 1% of the pixels (``test_torch_worker``)."""
    diff = np.abs(port_out["counts"].astype(np.int64)
                  - np.asarray(jax_out["counts"]).astype(np.int64))
    assert diff.max() <= 0.01 * PIXELS, (port_out, jax_out)
    assert (port_out["counts"].sum(axis=1) == PIXELS).all()


def check_longcontext(port_out, jax_out):
    """The class agrees and the confidence is within 1e-2
    (``test_torch_seqformer``)."""
    def answer(logits):
        p = np.exp(logits.astype(np.float64) - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        return p.argmax(-1), p.max(-1)

    pc, pp = answer(np.asarray(port_out))
    jc, jp = answer(np.asarray(jax_out))
    assert (pc == jc).all(), (pc, jc)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-2)


class TestReload:
    @pytest.mark.parametrize("family,kw,batch,check", [
        ("unet", UNET, lambda: images(4, seed=5), check_landcover),
        ("seqformer", SEQ, lambda: sequences(4, seed=5), check_longcontext),
    ], ids=["landcover", "longcontext"])
    def test_reload_matches_jax(self, family, kw, batch, check):
        (jrt, jserv), (prt, pserv), new = reload_pair(family, kw, seed=7)
        x = batch()
        before = prt.run_batch(pserv.name, x)
        check(before, jrt.run_batch(jserv.name, x))
        jrt.reload_params(jserv.name, jax.tree.map(jnp.asarray, new))
        prt.reload_params(pserv.name, new)
        assert pserv.params_version == jserv.params_version == 2
        after = prt.run_batch(pserv.name, x)
        check(after, jrt.run_batch(jserv.name, x))
        assert not equal_trees(after, before)
        # The served tree is now the new one, bit for bit (float32 leaves
        # widen from the served bf16 exactly where the model rounds).
        served = pserv.flax_from_state_dict(pserv.module.state_dict())
        assert flax_spec(served) == flax_spec(new)

    @pytest.mark.parametrize("edit", ["shape", "dtype", "missing", "extra"])
    def test_mismatched_tree_is_refused_by_both(self, edit):
        (jrt, jserv), (prt, pserv), new = reload_pair("unet", UNET, seed=7)
        head = new["params"]["Conv_2"]
        if edit == "shape":
            head["bias"] = np.zeros(5, np.float32)
        elif edit == "dtype":
            head["bias"] = head["bias"].astype(np.float16)
        elif edit == "missing":
            del head["bias"]
        else:
            head["extra"] = np.zeros(3, np.float32)
        x = images(2, seed=3)
        before = prt.run_batch(pserv.name, x)
        with pytest.raises(ValueError, match="does not match the served"):
            prt.reload_params(pserv.name, new)
        with pytest.raises(ValueError, match="does not match the served"):
            jrt.reload_params(jserv.name, new)
        assert pserv.params_version == jserv.params_version == 1
        assert equal_trees(prt.run_batch(pserv.name, x), before)

    def test_unknown_model_raises_key_error_as_jax(self):
        prt, _ = port_runtime("echo", **ECHO)
        jrt, _ = jax_runtime("echo", **ECHO)
        for rt in (prt, jrt):
            with pytest.raises(KeyError):
                rt.reload_params("nope", {"scale": np.float32(2.0)})

    def test_reload_racing_batches_is_never_a_mix(self):
        """Batches of the same input run on one thread while another
        reloads the model back and forth between two weight sets: every
        answer is wholly the old weights' or wholly the new ones'."""
        (_, jserv), (prt, pserv), new = reload_pair("seqformer", SEQ, seed=7)
        old = numpy_tree(jserv.params)
        x = sequences(4, seed=9)
        want_old = prt.run_batch(pserv.name, x)
        prt.reload_params(pserv.name, new)
        want_new = prt.run_batch(pserv.name, x)
        assert not np.array_equal(want_old, want_new)
        stop = threading.Event()
        answers = []

        def batches():
            while not stop.is_set():
                answers.append(prt.run_batch(pserv.name, x))

        worker = threading.Thread(target=batches)
        worker.start()
        try:
            for i in range(6):
                prt.reload_params(pserv.name, old if i % 2 == 0 else new)
        finally:
            stop.set()
            worker.join()
        assert len(answers) > 1
        for got in answers:
            assert np.array_equal(got, want_old) or np.array_equal(
                got, want_new)
        assert pserv.params_version == 8


class TestUnfusedLandcover:
    """``build_unet(fused_postprocess=False)``: JAX's unfused path (float32
    tiles in, the logits to the host, the class map and histogram there),
    on flax weights converted to the port."""

    def test_histograms_match_jax(self):
        kw = dict(UNET, fused_postprocess=False, buckets=(4,))
        jrt, jserv = jax_runtime("unet", **kw)
        prt, pserv = port_runtime("unet", params=numpy_tree(jserv.params),
                                  **kw)
        assert pserv.input_dtype == np.float32
        tiles = np.random.default_rng(11).random((4, TILE, TILE, 3),
                                                 dtype=np.float32)
        bodies = []
        for tile in tiles:
            buf = io.BytesIO()
            np.save(buf, tile)
            bodies.append(buf.getvalue())
        x = np.stack([pserv.preprocess(b, "application/octet-stream")
                      for b in bodies])
        np.testing.assert_array_equal(x, np.stack([
            jserv.preprocess(b, "application/octet-stream") for b in bodies]))
        port_logits = prt.run_batch(pserv.name, x)
        jax_logits = np.asarray(jrt.run_batch(jserv.name, x))
        assert port_logits.shape == jax_logits.shape == (4, TILE, TILE, 4)
        for p_row, j_row in zip(port_logits, jax_logits):
            got = pserv.postprocess(p_row)["class_histogram"]
            want = jserv.postprocess(j_row)["class_histogram"]
            assert sum(got.values()) == sum(want.values()) == PIXELS
            # test_torch_worker's bound: each class within 1% of the pixels.
            for c in set(got) | set(want):
                assert abs(got.get(c, 0) - want.get(c, 0)) <= 0.01 * PIXELS, (
                    got, want)
            # The host's map is the argmax of the port's own logits.
            exact = np.unique(p_row.argmax(-1), return_counts=True)
            assert got == {int(v): int(n) for v, n in zip(*exact)}

    def test_classmap_png_rides_the_unfused_path(self):
        _, pserv = port_runtime("unet", fused_postprocess=False,
                                return_classmap=True, **UNET)
        logits = np.zeros((TILE, TILE, 4), np.float32)
        logits[..., 2] = 1.0
        out = pserv.postprocess(logits)
        assert out["class_histogram"] == {2: PIXELS}
        assert out["classmap_png"]

    @pytest.mark.parametrize("wire", ["yuv420", "dct"])
    def test_a_compressed_wire_is_refused_by_both(self, wire):
        kw = dict(UNET, fused_postprocess=False, wire=wire)
        with pytest.raises(ValueError) as got:
            build_servable("unet", **kw)
        with pytest.raises(ValueError) as want:
            jax_build("unet", **kw)
        assert str(got.value) == str(want.value)
