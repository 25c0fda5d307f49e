"""The port's traffic-tuned ladders (``ai4e_tpu_torch.runtime.ladder``)
against the JAX package's (``ai4e_tpu.runtime.ladder``): the pure functions
on the same histograms and cut sequences, and ``LadderManager`` driving the
port's ``ModelRuntime`` (on the CPU) beside JAX's manager on JAX's runtime
(one CPU device), fed the same cuts: the same ladders derived, swapped,
persisted and restored."""

import random

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ai4e_tpu.metrics.registry import MetricsRegistry as JaxMetrics
from ai4e_tpu.parallel import MeshSpec, make_mesh
from ai4e_tpu.runtime import ladder as jl
from ai4e_tpu.runtime.families import build_servable as jax_build
from ai4e_tpu.runtime.registry import ModelRuntime as JaxRuntime
from ai4e_tpu_torch.metrics import MetricsRegistry
from ai4e_tpu_torch.runtime import ladder as pl
from ai4e_tpu_torch.runtime.families import build_servable
from ai4e_tpu_torch.runtime.registry import ModelRuntime

SEED = 20261017

histograms = st.dictionaries(st.integers(1, 256),
                             st.floats(0.1, 100.0, allow_nan=False),
                             min_size=1, max_size=14)
ladders = st.lists(st.integers(1, 256), min_size=1, max_size=8,
                   unique=True).map(lambda b: tuple(sorted(b)))


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class TestPureFunctions:
    def test_constants(self):
        assert pl.DEFAULT_BUCKETS == jl.DEFAULT_BUCKETS
        assert pl.IMAGE_BUCKETS == jl.IMAGE_BUCKETS
        assert pl.EXPOSITION_BUCKETS == jl.EXPOSITION_BUCKETS

    @settings(max_examples=200, deadline=None)
    @given(hist=histograms, baseline=ladders,
           max_programs=st.integers(1, 16), align=st.sampled_from([1, 2, 8]))
    def test_derive_ladder_matches_jax(self, hist, baseline, max_programs,
                                       align):
        assert pl.derive_ladder(hist, baseline=baseline,
                                max_programs=max_programs, align=align) == \
            jl.derive_ladder(hist, baseline=baseline,
                             max_programs=max_programs, align=align)

    @settings(max_examples=200, deadline=None)
    @given(hist=histograms, ladder=ladders)
    def test_expected_pad_waste_matches_jax(self, hist, ladder):
        assert pl.expected_pad_waste(ladder, hist) == \
            jl.expected_pad_waste(ladder, hist)

    def test_property_derived_never_worse_than_static(self):
        """tests/test_ladder.py's property on the port's deriver."""
        rng = random.Random(SEED)
        static = pl.EXPOSITION_BUCKETS
        for trial in range(250):
            hist = {rng.randint(1, 256): rng.uniform(0.1, 100.0)
                    for _ in range(rng.randint(1, 14))}
            derived = pl.derive_ladder(hist, baseline=static, max_programs=16)
            assert list(derived) == sorted(set(derived)), (trial, hist)
            assert max(derived) >= max(hist), (trial, hist)
            assert (pl.expected_pad_waste(derived, hist)
                    <= pl.expected_pad_waste(static, hist) + 1e-9)

    def test_rejects_bad_budget_as_jax_does(self):
        for mod in (pl, jl):
            with pytest.raises(ValueError, match="max_programs"):
                mod.derive_ladder({1: 1.0}, baseline=(1,), max_programs=0)

    @pytest.mark.parametrize("window_s,max_sizes", [(10.0, 256), (1e9, 4)])
    def test_shape_histogram_matches_jax(self, window_s, max_sizes):
        """The same cut sequence, with time passing, into both histograms."""
        rng = random.Random(SEED + int(window_s))
        pc, jc = _Clock(), _Clock()
        ph = pl.ShapeHistogram(window_s=window_s, max_sizes=max_sizes,
                               clock=pc)
        jh = jl.ShapeHistogram(window_s=window_s, max_sizes=max_sizes,
                               clock=jc)
        for _ in range(300):
            n, w = rng.randint(-2, 40), rng.uniform(0.1, 5.0)
            ph.observe(n, weight=w)
            jh.observe(n, weight=w)
            dt = rng.uniform(0.0, 3.0)
            pc.t += dt
            jc.t += dt
            assert ph.snapshot() == jh.snapshot()
        assert ph.observations == jh.observations

    def test_fingerprints_and_exposition_match_jax(self):
        port = build_servable("echo", size=4, buckets=(1, 20, 64))
        ref = jax_build("echo", size=4, buckets=(1, 20, 64))
        assert pl.servable_fingerprint(port) == jl.servable_fingerprint(ref)
        port.params_version += 1  # a hot reload keeps the fingerprint
        assert pl.servable_fingerprint(port) == jl.servable_fingerprint(ref)
        assert pl.exposition_buckets([port]) == jl.exposition_buckets([ref])
        assert pl.exposition_buckets([]) == jl.exposition_buckets([])

    def test_persistence_round_trips_across_packages(self, tmp_path):
        entries = {"m": {"fingerprint": "f", "buckets": [4, 8],
                         "baseline": [1, 64], "generation": 2}}
        port_path, jax_path = str(tmp_path / "p.json"), str(tmp_path / "j.json")
        pl.save_ladders(port_path, entries)
        jl.save_ladders(jax_path, entries)
        assert jl.load_ladders(port_path) == pl.load_ladders(jax_path) == \
            entries
        with open(port_path, "w") as fh:
            fh.write("{not json")
        assert pl.load_ladders(port_path) == jl.load_ladders(port_path) == {}


def jax_runtime(buckets):
    mesh = make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    rt = JaxRuntime(mesh=mesh)
    rt.register(jax_build("echo", size=4, buckets=buckets))
    rt.warmup(parallel=False)
    return rt


def port_runtime(buckets):
    rt = ModelRuntime(device="cpu")
    rt.register(build_servable("echo", size=4, buckets=buckets))
    rt.warmup()
    return rt


def managers(tmp_path, buckets=(1, 64), **kw):
    """A port manager on the port's runtime and a JAX one on JAX's, each
    with its own persistence file and fake clock."""
    out = []
    for tag, runtime, mod, reg in (
            ("port", port_runtime(buckets), pl, MetricsRegistry),
            ("jax", jax_runtime(buckets), jl, JaxMetrics)):
        clock = _Clock()
        mgr = mod.LadderManager(
            runtime, period_s=1e9, dwell_s=kw.get("dwell_s", 0.0),
            min_observations=4, persist_path=str(tmp_path / f"{tag}.json"),
            metrics=reg(), clock=clock)
        out.append((mgr, runtime, clock))
    return out


class TestLadderManagerOnRuntimes:
    @pytest.mark.parametrize("cuts", [[20] * 10, [3, 5, 9, 17, 33] * 4,
                                      [64] * 8 + [1] * 8, [24] * 12 + [7]])
    def test_same_cuts_derive_and_swap_the_same_ladder(self, tmp_path, cuts):
        (pm, prt, _), (jm, jrt, _) = managers(tmp_path)
        for n in cuts:
            pm.observe_cut("echo", n)
            jm.observe_cut("echo", n)
        assert pm.derive_now("echo") == jm.derive_now("echo")
        assert prt.models["echo"].batch_buckets == \
            jrt.models["echo"].batch_buckets
        assert pm.generation("echo") == jm.generation("echo")
        # Every bucket of the swapped ladder runs as ``execute``.
        for bucket in prt.models["echo"].batch_buckets:
            _, _, phases = prt.run_batch_phases(
                "echo", np.ones((bucket, 4), np.float32))
            assert "execute" in phases and "compile" not in phases
        port_entry = pl.load_ladders(str(tmp_path / "port.json"))
        jax_entry = jl.load_ladders(str(tmp_path / "jax.json"))
        assert port_entry == jax_entry

    def test_dwell_skips_as_jax_does(self, tmp_path):
        pair = managers(tmp_path, dwell_s=100.0)
        outcomes = []
        for mgr, _rt, clock in pair:
            seq = []
            for n in (20, 33):
                for _ in range(10):
                    mgr.observe_cut("echo", n)
                seq.append(mgr.derive_now("echo"))
            clock.t += 101.0
            for _ in range(10):
                mgr.observe_cut("echo", 33)
            seq.append(mgr.derive_now("echo"))
            outcomes.append(seq)
        assert outcomes[0] == outcomes[1] == ["swapped", "skipped", "swapped"]

    def test_restart_restores_the_same_ladder(self, tmp_path):
        (pm, prt, _), (jm, jrt, _) = managers(tmp_path)
        for n in [20] * 16:
            pm.observe_cut("echo", n)
            jm.observe_cut("echo", n)
        pm.derive_now("echo")
        jm.derive_now("echo")
        tuned = prt.models["echo"].batch_buckets
        # Fresh runtimes on the factory ladder; restore BEFORE warmup.
        fresh_port = ModelRuntime(device="cpu")
        fresh_port.register(build_servable("echo", size=4, buckets=(1, 64)))
        mesh = make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
        fresh_jax = JaxRuntime(mesh=mesh)
        fresh_jax.register(jax_build("echo", size=4, buckets=(1, 64)))
        restored_port = pl.LadderManager(
            fresh_port, persist_path=str(tmp_path / "port.json"),
            metrics=MetricsRegistry()).restore()
        restored_jax = jl.LadderManager(
            fresh_jax, persist_path=str(tmp_path / "jax.json"),
            metrics=JaxMetrics()).restore()
        assert restored_port == restored_jax == {"echo": tuned}
        fresh_port.warmup()
        _, _, phases = fresh_port.run_batch_phases(
            "echo", np.ones((tuned[0], 4), np.float32))
        assert "execute" in phases and "compile" not in phases

    def test_apply_without_prepare_is_refused_by_both(self):
        prt, jrt = port_runtime((1, 8)), jax_runtime((1, 8))
        for rt in (prt, jrt):
            with pytest.raises(RuntimeError, match=r"no\s+executed program"):
                rt.apply_ladder("echo", (1, 4, 8))
            assert rt.models["echo"].batch_buckets == (1, 8)
        assert prt.prepare_buckets("echo", (8, 4)) == \
            jrt.prepare_buckets("echo", (8, 4)) == (4, 8)
        assert prt.apply_ladder("echo", (4, 8)) == \
            jrt.apply_ladder("echo", (4, 8)) == (4, 8)
