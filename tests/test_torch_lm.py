"""The port's streaming LM against the JAX package's on the same weights, on
the CPU at JAX's verify geometry (vocab 64, max_len 48, dim 32, heads 2,
eos 63, depth 1-2, 2 slots, prompt bucket 8):

- ``SeqFormerLM.prefill`` and ``decode_step`` against flax's on converted
  weights: K/V and caches within ``KV_RTOL`` of their largest magnitude;
  next-token ids equal wherever JAX's top-two logit gap exceeds ``TIE_GAP``;
- the converters, exact both ways;
- ``PagedDecodeRuntime`` against JAX's: the clamped buckets and
  ``bucket_for``; prefills into several slots, then 10 pool steps (inactive
  slots writing their garbage at position 0, as in JAX), both runtimes fed
  the same tokens, with the same caches and, under the tie rule, the same
  ids; ``reset_cache`` in place; ``reload_params``;
- the whole slice: the port's worker serving an LM ``.npz`` written from
  JAX's params generates, over HTTP, the tokens JAX's ``PagedDecodeRuntime``
  and ``DecodeEngine`` generate for the same prompts, under the tie rule.
"""

import asyncio
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from ai4e_tpu.metrics.registry import MetricsRegistry as JaxRegistry
from ai4e_tpu.models.seqformer import SeqFormerLM as FlaxLM
from ai4e_tpu.models.seqformer import create_seqformer_lm as flax_lm
from ai4e_tpu.runtime.decode import DecodeEngine as JaxEngine
from ai4e_tpu.runtime.kvcache import PagedDecodeRuntime as JaxRuntime
from ai4e_tpu.runtime.kvcache import build_lm_servable as jax_servable
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.cli import build_worker
from ai4e_tpu_torch.config import FrameworkConfig
from ai4e_tpu_torch.models import create_seqformer_lm
from ai4e_tpu_torch.runtime.kvcache import (PagedDecodeRuntime,
                                            build_lm_servable)
from ai4e_tpu_torch.runtime.registry import ModelRuntime

torch.set_num_threads(2)

VOCAB, MAX_LEN, DIM, HEADS, EOS = 64, 48, 32, 2, 63
SLOTS, BUCKETS = 2, (8,)
KV_RTOL = 1e-5   # of the tensor's largest magnitude: float32, other orders
TIE_GAP = 1e-4   # ids must agree where JAX's top-two logit gap exceeds it
PREFIX = "/v1/lm"


def geometry(depth: int) -> dict:
    return dict(vocab_size=VOCAB, max_len=MAX_LEN, dim=DIM, depth=depth,
                heads=HEADS)


@pytest.fixture(scope="module", params=[1, 2], ids=["depth1", "depth2"])
def pair(request):
    """flax's LM and params at a depth, and the port's module on the same
    weights (converted)."""
    model, params = flax_lm(rng=jax.random.PRNGKey(request.param),
                            **geometry(request.param))
    params = jax.tree.map(np.asarray, params)
    module = create_seqformer_lm(device="cpu", **geometry(request.param))
    module.load_state_dict(convert.seqformer_lm_state_dict_from_flax(params))
    return model, params, module


def _prefill_logits(m, tokens, length):
    """flax's ``prefill`` up to the logits of the last real token."""
    p = tokens.shape[1]
    h = m.embed(tokens) + m.pos_emb[None, :p]
    mask = jnp.arange(p)[None, :] < length[:, None]
    for blk in m.blocks:
        h, _, _ = blk.prefill(h, mask)
    last = jnp.take_along_axis(
        h, (length - 1)[:, None, None].astype(jnp.int32), axis=1)[:, 0]
    return m._logits(last)


def _step_logits(m, tokens, k, v, position):
    """flax's ``decode_step`` up to the logits."""
    h = m.embed(tokens) + m.pos_emb[position]
    for i, blk in enumerate(m.blocks):
        h, _, _ = blk.step(h, k[i], v[i], position)
    return m._logits(h)


def gaps(logits) -> np.ndarray:
    top = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def assert_close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= KV_RTOL * np.abs(want).max(), (what, err)


def assert_ids(got, want, gap, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    clear = gap > TIE_GAP
    assert (got[clear] == want[clear]).all(), (what, got, want, gap)


class TestModel:
    def test_converter_is_exact_both_ways(self, pair):
        _, params, module = pair
        sd = module.state_dict()
        tree = convert.seqformer_lm_flax_from_state_dict(sd)
        assert jax.tree.structure(tree) == jax.tree.structure(params)
        assert all(jax.tree.leaves(jax.tree.map(np.array_equal, tree,
                                                params)))
        again = convert.seqformer_lm_state_dict_from_flax(tree)
        assert set(again) == set(sd)
        assert all(torch.equal(again[k], sd[k]) for k in sd)

    def test_converter_refuses_a_classifier_tree(self):
        bad = {"params": {"pos_emb": np.zeros((1, 8, 4), np.float32)}}
        with pytest.raises(ValueError, match="pos_emb must be"):
            convert.seqformer_lm_state_dict_from_flax(bad)

    def test_prefill_matches_flax(self, pair):
        model, params, module = pair
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, VOCAB, (4, 16)).astype(np.int32)
        length = np.array([16, 9, 1, 4], np.int32)
        ids, k, v = model.apply(params, tokens, length,
                                method=FlaxLM.prefill)
        logits = model.apply(params, tokens, length, method=_prefill_logits)
        with torch.inference_mode():
            got_ids, got_k, got_v = module.prefill(
                torch.from_numpy(tokens).long(),
                torch.from_numpy(length).long())
        assert got_k.shape == k.shape == (module.depth, 4, HEADS, 16,
                                          DIM // HEADS)
        assert_close(got_k, k, "k")
        assert_close(got_v, v, "v")
        assert_ids(got_ids, ids, gaps(logits), "prefill ids")

    def test_decode_step_matches_flax(self, pair):
        """A pool of 4 slots with seeded caches; slot 2 idles at position
        0, as the engine passes an inactive slot."""
        model, params, module = pair
        rng = np.random.default_rng(1)
        shape = (module.depth, 4, HEADS, MAX_LEN, DIM // HEADS)
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        tokens = rng.integers(0, VOCAB, 4).astype(np.int32)
        position = np.array([5, 47, 0, 20], np.int32)
        ids, k_want, v_want = model.apply(params, tokens, k, v, position,
                                          method=FlaxLM.decode_step)
        logits = model.apply(params, tokens, k, v, position,
                             method=_step_logits)
        k_got, v_got = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        with torch.inference_mode():
            got_ids, k_out, v_out = module.decode_step(
                torch.from_numpy(tokens).long(), k_got, v_got,
                torch.from_numpy(position).long())
        assert k_out is k_got and v_out is v_got  # written in place
        assert_close(k_got, k_want, "k cache")
        assert_close(v_got, v_want, "v cache")
        # Outside the written positions the caches are untouched, bit for
        # bit, as JAX's one-hot blend leaves them.
        written = np.zeros(shape, bool)
        written[:, np.arange(4), :, position] = True
        assert np.array_equal(k_got.numpy()[~written], k[~written])
        assert_ids(got_ids, ids, gaps(logits), "step ids")


def runtimes(depth: int = 2, buckets=BUCKETS, seed: int = 0):
    """JAX's and the port's ``PagedDecodeRuntime`` on the same weights."""
    servable = jax_servable(name="lm", eos_id=EOS,
                            rng=jax.random.PRNGKey(seed), **geometry(depth))
    servable.params = jax.tree.map(np.asarray, servable.params)
    port = build_lm_servable(name="lm", eos_id=EOS, **geometry(depth))
    port.module.load_state_dict(
        convert.seqformer_lm_state_dict_from_flax(servable.params))
    return (JaxRuntime(servable, slots=SLOTS, prompt_buckets=buckets),
            PagedDecodeRuntime(port, ModelRuntime(device="cpu"), slots=SLOTS,
                               prompt_buckets=buckets))


class TestPagedDecodeRuntime:
    @pytest.mark.parametrize("buckets", [None, (8,), (4, 100, 16), (48,)])
    def test_buckets_are_jax_s(self, buckets):
        jax_rt, port_rt = runtimes(depth=1, buckets=buckets)
        assert port_rt.prompt_buckets == jax_rt.prompt_buckets
        assert port_rt.prompt_buckets[-1] == MAX_LEN
        for n in range(1, MAX_LEN):
            assert port_rt.bucket_for(n) == jax_rt.bucket_for(n)
        assert port_rt.cache_nbytes() == jax_rt.cache_nbytes()

    def test_prefills_then_ten_steps_match_jax(self):
        jax_rt, port_rt = runtimes()
        model = jax_rt.servable.model
        prompts = {1: [5, 9, 12], 0: list(range(3, 20))}  # buckets 8 and 48
        tokens, positions = [0] * SLOTS, [0] * SLOTS
        for slot, prompt in prompts.items():
            want = jax_rt.prefill_into(slot, prompt)
            got = port_rt.prefill_into(slot, prompt)
            bucket = jax_rt.bucket_for(len(prompt))
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :len(prompt)] = prompt
            gap = gaps(model.apply(jax_rt.servable.params, padded,
                                   np.array([len(prompt)], np.int32),
                                   method=_prefill_logits))
            assert_ids([got], [want], gap, f"prefill slot {slot}")
            tokens[slot], positions[slot] = want, len(prompt)
        assert_close(port_rt.k_cache, jax_rt._k, "k after prefills")
        assert_close(port_rt.v_cache, jax_rt._v, "v after prefills")
        active = [True, True]
        for step in range(10):
            if step == 4:
                # Slot 0 leaves: it idles at position 0 with token 0, and
                # both runtimes write its garbage K/V there.
                active[0], tokens[0], positions[0] = False, 0, 0
            gap = gaps(model.apply(
                jax_rt.servable.params, np.asarray(tokens, np.int32),
                jax_rt._k, jax_rt._v, np.asarray(positions, np.int32),
                method=_step_logits))
            want = jax_rt.step(tokens, positions, active)
            got = port_rt.step(tokens, positions, active)
            assert_ids(got, want, gap, f"step {step}")
            assert_close(port_rt.k_cache, jax_rt._k, f"k after step {step}")
            assert_close(port_rt.v_cache, jax_rt._v, f"v after step {step}")
            # Both fed JAX's tokens, so a near-tie cannot fork the caches.
            for slot in range(SLOTS):
                if active[slot]:
                    tokens[slot], positions[slot] = want[slot], \
                        positions[slot] + 1

    @pytest.mark.parametrize("prompt", [[], [1] * MAX_LEN, [3, VOCAB],
                                        [-1, 2]],
                             ids=["empty", "full", "vocab", "negative"])
    def test_prefill_refuses_what_cannot_run(self, prompt):
        _, port_rt = runtimes(depth=1)
        with pytest.raises(ValueError):
            port_rt.prefill_into(0, prompt)
        assert not port_rt.k_cache.any()

    def test_reset_cache_zeroes_in_place(self):
        _, port_rt = runtimes(depth=1)
        k_ptr, v_ptr = (port_rt.k_cache.data_ptr(),
                        port_rt.v_cache.data_ptr())
        port_rt.prefill_into(0, [1, 2, 3])
        assert port_rt.k_cache.abs().sum() > 0
        port_rt.reset_cache()
        assert port_rt.k_cache.data_ptr() == k_ptr
        assert port_rt.v_cache.data_ptr() == v_ptr
        assert not port_rt.k_cache.any() and not port_rt.v_cache.any()

    def test_reload_params_checks_the_tree_and_bumps_the_version(self):
        jax_rt, port_rt = runtimes(depth=1)
        other = flax_lm(rng=jax.random.PRNGKey(7), **geometry(1))[1]
        other = jax.tree.map(np.asarray, other)
        assert port_rt.reload_params(other) == 2
        assert jax_rt.reload_params(other) == 2
        assert port_rt.params_version == 2
        sd = port_rt.module.state_dict()
        assert torch.equal(sd["embed.weight"], torch.from_numpy(
            np.array(other["params"]["embed"]["embedding"])))
        wrong = flax_lm(**{**geometry(2), "dim": 16})[1]
        with pytest.raises(ValueError, match="does not match"):
            port_rt.reload_params(jax.tree.map(np.asarray, wrong))
        with pytest.raises(ValueError):
            jax_rt.reload_params(wrong)
        assert port_rt.params_version == 2
        # The same prompt now decodes as JAX's on the new weights.
        assert port_rt.prefill_into(1, [4, 4, 2]) == jax_rt.prefill_into(
            1, [4, 4, 2])


PROMPTS = [[5, 9, 12], [1], list(range(10, 30)), [62, 3, 3, 7, 0, 41],
           [33] * 8]
MAX_NEW = [10, 6, 12, 20, 5]


def lm_spec(checkpoint: str) -> dict:
    return {"service_name": "lmsvc", "prefix": "v1/lm",
            "models": [{"family": "seqformer-lm", "name": "lm",
                        "vocab_size": VOCAB, "dim": DIM, "depth": 2,
                        "heads": HEADS, "eos_id": EOS,
                        "checkpoint": checkpoint}]}


def decode_config() -> FrameworkConfig:
    return FrameworkConfig.from_env({
        "AI4E_RUNTIME_DECODE_ENABLE": "1",
        "AI4E_RUNTIME_KV_SLOTS": str(SLOTS),
        "AI4E_RUNTIME_KV_MAX_LEN": str(MAX_LEN),
        "AI4E_RUNTIME_DECODE_PROMPT_BUCKETS": "8"})


def jax_generate(jax_rt) -> list[list[int]]:
    async def main():
        engine = JaxEngine(jax_rt, metrics=JaxRegistry())
        await engine.start()
        try:
            return await asyncio.gather(*(
                engine.submit(p, n) for p, n in zip(PROMPTS, MAX_NEW)))
        finally:
            await engine.stop()

    return asyncio.run(main())


def greedy_gaps(jax_rt, prompt: list[int], tokens: list[int]) -> np.ndarray:
    """JAX's top-two gap before each generated token: the prefill logits
    over the history so far, as a greedy re-prefill computes them (padded
    to ``MAX_LEN``, one compiled program)."""
    model, params = jax_rt.servable.model, jax_rt.servable.params
    logits = jax.jit(lambda t, n: model.apply(params, t, n,
                                              method=_prefill_logits))
    out = []
    for i in range(len(tokens)):
        history = prompt + tokens[:i]
        padded = np.zeros((1, MAX_LEN), np.int32)
        padded[0, :len(history)] = history
        out.append(gaps(logits(padded, np.array([len(history)],
                                                np.int32)))[0])
    return np.asarray(out)


def agree_to_first_tie(got: list[int], want: list[int],
                       gap: np.ndarray) -> None:
    """Equal up to the first position where JAX's gap is at or under
    ``TIE_GAP`` (past it the two may fork); a sequence that ended early
    (EOS) ends at the same token."""
    close = np.flatnonzero(gap <= TIE_GAP)
    upto = int(close[0]) if len(close) else len(want)
    assert got[:upto] == want[:upto], (got, want, gap)
    if upto == len(want):
        assert got == want


class TestServedSlice:
    def test_worker_serves_jax_s_tokens(self, tmp_path):
        jax_rt, _ = runtimes(depth=2)
        path = tmp_path / "lm.npz"
        convert.save_npz(jax_rt.servable.params, str(path))
        want = jax_generate(jax_rt)
        worker, batcher, _ = build_worker(lm_spec(str(path)), device="cpu",
                                          config=decode_config())
        engine, = worker.decode_engines
        assert engine.backend.prompt_buckets == (8, MAX_LEN)
        assert engine.backend.servable.checkpoint_path == str(path)

        async def main():
            await batcher.start()
            await engine.start()
            client = TestClient(TestServer(worker.service.app))
            await client.start_server()
            try:
                ids = []
                for prompt, n in zip(PROMPTS, MAX_NEW):
                    resp = await client.post(
                        f"{PREFIX}/lm-stream-async",
                        json={"prompt": prompt, "max_new_tokens": n})
                    assert resp.status == 200, await resp.text()
                    ids.append((await resp.json())["TaskId"])
                out = []
                for task_id in ids:
                    for _ in range(2000):
                        status = (await (await client.get(
                            f"{PREFIX}/task/{task_id}")).json())["Status"]
                        if not status.startswith(("created", "running")):
                            break
                        await asyncio.sleep(0.01)
                    out.append((status, *worker.store.get_result(task_id)))
                return out
            finally:
                await client.close()
                await engine.stop()
                await batcher.stop()

        served = asyncio.run(main())
        for (status, payload, ctype), prompt, tokens in zip(served, PROMPTS,
                                                            want):
            result = json.loads(payload)
            assert ctype == "application/json"
            assert status == f"completed - {result['count']} tokens"
            assert result["count"] == len(result["tokens"])
            agree_to_first_tie(result["tokens"], tokens,
                               greedy_gaps(jax_rt, prompt, tokens))
        engine.pool.check_conservation()
        assert engine.pool.free_count == SLOTS

    def test_lm_spec_keys_are_jax_s(self, tmp_path):
        """The spec without ``max_len`` takes ``AI4E_RUNTIME_KV_MAX_LEN``,
        as JAX's worker does."""
        jax_rt, _ = runtimes(depth=2)
        path = tmp_path / "lm.npz"
        convert.save_npz(jax_rt.servable.params, str(path))
        spec = copy.deepcopy(lm_spec(str(path)))
        worker, _, _ = build_worker(spec, device="cpu",
                                    config=decode_config())
        backend = worker.decode_engines[0].backend
        assert backend.max_len == MAX_LEN and backend.slots == SLOTS
        assert backend.eos_id == EOS
        assert worker._served["lm"] == {"stream_async":
                                        "/v1/lm/lm-stream-async"}
