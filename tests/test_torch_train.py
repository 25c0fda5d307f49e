"""The port's training plane (``ai4e_tpu_torch.train``), its float32 master
weights and its bfloat16 gelu under autograd, against the JAX package's, on
the same weights (flax's init, converted) and batches made with numpy from
a seed. JAX's flash attention and its backward run in interpret mode; the
port's take their plain versions on the CPU.

Then the longcontext recipe end to end at the JAX package's toy geometry:
trained, saved as ``.npz``, restored by ``cli.build_worker`` and served."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai4e_tpu.models.seqformer import SeqFormer as FlaxSeqFormer
from ai4e_tpu.models.seqformer import attention_for as jax_attention_for
from ai4e_tpu.models.seqformer import create_seqformer as jax_create
from ai4e_tpu.parallel import MeshSpec, make_mesh
from ai4e_tpu.train import make_checkpoints as jax_mc
from ai4e_tpu.train import step as jax_step
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.cli import build_worker
from ai4e_tpu_torch.models import SeqFormer, attention_for, create_seqformer
from ai4e_tpu_torch.models import layers
from ai4e_tpu_torch.train import Trainer, cross_entropy_loss, segmentation_loss
from ai4e_tpu_torch.train import make_checkpoints as mc

torch.set_num_threads(2)

SMALL = dict(seq_len=256, input_dim=24, dim=64, depth=2, heads=2)
VOCAB = 512
# tests/test_make_checkpoints.py's toy longcontext geometry.
TOY = dict(seq_len=128, dim=32, depth=2, heads=2, vocab_size=256, batch=16)


def flax_params(vocab_size=VOCAB, config=SMALL):
    _, params = jax_create(vocab_size=vocab_size, attention="flash", **config)
    return jax.tree.map(np.asarray, params)


class TestLosses:
    def test_cross_entropy_matches_jax(self):
        rng = np.random.default_rng(0)
        logits = (rng.standard_normal((16, 10)) * 4).astype(np.float32)
        labels = rng.integers(0, 10, 16).astype(np.int32)
        want = float(jax_step.cross_entropy_loss(jnp.asarray(logits),
                                                 jnp.asarray(labels)))
        got = float(cross_entropy_loss(torch.from_numpy(logits),
                                       torch.from_numpy(labels)))
        assert got == pytest.approx(want, rel=1e-6)

    def test_segmentation_loss_matches_jax_in_bfloat16(self):
        """(B, H, W, C) bf16 logits: log-softmax in float32 on both."""
        rng = np.random.default_rng(1)
        logits = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        labels = rng.integers(0, 4, (2, 8, 8)).astype(np.int32)
        want = float(jax_step.segmentation_loss(
            jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels)))
        got = float(segmentation_loss(
            torch.from_numpy(logits).to(torch.bfloat16),
            torch.from_numpy(labels)))
        assert got == pytest.approx(want, rel=1e-6)


class TestGeluGradient:
    def test_bfloat16_gradient_is_jax_grad_bit_for_bit(self):
        """Every bfloat16 with 1e-6 < |x| < 16 (as the forward's test):
        ``_GeluBF16`` writes out the VJP JAX traces, op for op, so the
        gradient equals ``jax.grad``'s exactly (measured: 0 of 65,000
        differ; autograd through the chain's own ops differed by up to 109
        bf16 ulps where the derivative cancels, near x = -3)."""
        bits = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
        with np.errstate(invalid="ignore"):
            x = bits[(np.abs(bits) > 1e-6) & (np.abs(bits) < 16)]
        g = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
        gb = np.asarray(jnp.asarray(g, jnp.bfloat16), np.float32)
        want = np.asarray(jax.grad(lambda v: jnp.sum(
            jax.nn.gelu(v).astype(jnp.float32) * gb))(
                jnp.asarray(x, jnp.bfloat16)), np.float32)
        xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
        y = layers.gelu(xt)
        (got,) = torch.autograd.grad(y, xt, torch.from_numpy(gb).to(
            torch.bfloat16))
        np.testing.assert_array_equal(got.float().numpy(), want)
        with torch.no_grad():  # the served chain: same values
            np.testing.assert_array_equal(
                y.detach().float().numpy(),
                layers.gelu(xt.detach()).float().numpy())

    def test_float32_gradient(self):
        """F.gelu's tanh gradient against jax.grad: within 1e-5 (measured
        3.8e-6)."""
        x = np.linspace(-6, 6, 1001, dtype=np.float32)
        want = np.asarray(jax.vmap(jax.grad(jax.nn.gelu))(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        (got,) = torch.autograd.grad(layers.gelu(xt).sum(), xt)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


class TestFloat32Masters:
    def test_parameters_are_float32_and_keys_unchanged(self):
        masters = SeqFormer(**SMALL, vocab_size=VOCAB,
                            param_dtype=torch.float32)
        served = SeqFormer(**SMALL, vocab_size=VOCAB)
        assert set(masters.state_dict()) == set(served.state_dict())
        assert all(p.dtype == torch.float32 for p in masters.parameters())
        assert masters.blocks[0].mlp_up.weight.dtype == torch.float32
        assert served.blocks[0].mlp_up.weight.dtype == torch.bfloat16
        assert served.embed.weight.dtype == served.pos_emb.dtype == \
            torch.bfloat16

    def test_trained_state_dict_loads_into_the_served_model(self):
        """float32 masters cast on every call give the same logits as the
        served model built in bfloat16 from the same weights (one rounding
        either way), bit for bit. Both models draw from their own
        generators, so no other test's use of the global RNG reaches them;
        a mismatch reports the process-wide settings that could steer
        PyTorch's CPU kernels."""
        masters = create_seqformer(seq_len=64, dim=32, depth=2, heads=2,
                                   vocab_size=VOCAB, device="cpu",
                                   param_dtype=torch.float32,
                                   generator=torch.Generator().manual_seed(0))
        served = create_seqformer(seq_len=64, dim=32, depth=2, heads=2,
                                  vocab_size=VOCAB, device="cpu",
                                  generator=torch.Generator().manual_seed(9))
        served.load_state_dict(masters.state_dict())
        x = torch.from_numpy(np.random.default_rng(3).integers(
            0, VOCAB, (4, 64)))
        with torch.inference_mode():
            got, want = masters(x), served(x)
        assert torch.equal(got, want), {
            "max_abs_diff": float((got - want).abs().max()),
            "differ": int((got != want).sum()),
            "threads": torch.get_num_threads(),
            "mkldnn": torch.backends.mkldnn.enabled,
            "cpu_capability": torch.backends.cpu.get_cpu_capability(),
            "default_dtype": str(torch.get_default_dtype()),
            "deterministic": torch.are_deterministic_algorithms_enabled(),
            "autocast_cpu": torch.is_autocast_enabled("cpu"),
        }


def jax_trainer_run(params, batches, dtype):
    model = FlaxSeqFormer(**SMALL, vocab_size=VOCAB, dtype=dtype,
                          attn_fn=jax_attention_for(None, "flash"))
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    tr = jax_step.Trainer(model.apply, jax.tree.map(jnp.asarray, params),
                          mesh)
    losses = [tr.train_step(x, y) for x, y in batches]
    return losses, convert.seqformer_state_dict_from_flax(
        jax.tree.map(np.asarray, tr.params))


def port_trainer_run(params, batches, dtype, remat=False):
    model = SeqFormer(**SMALL, vocab_size=VOCAB, dtype=dtype,
                      param_dtype=torch.float32,
                      attn_fn=attention_for(None, "flash"))
    model.load_state_dict(convert.seqformer_state_dict_from_flax(params))
    tr = Trainer(model, device="cpu", remat=remat)
    losses = [tr.train_step(x, y) for x, y in batches]
    return losses, {k: v.detach() for k, v in model.state_dict().items()}


class TestTrainerAgainstJax:
    """``ai4e_tpu.train.step.Trainer`` on a one-device CPU mesh and the
    port's ``Trainer`` from the same converted weights over the same 3
    batches, flash attention on both, the default adamw(1e-4,
    weight_decay=1e-4)."""

    @pytest.fixture(scope="class")
    def setup(self):
        params = flax_params()
        rng = np.random.default_rng(5)
        batches = [jax_mc.longcontext_batch(rng, 4, 256, VOCAB)
                   for _ in range(3)]
        return params, batches

    def test_float32(self, setup):
        """Losses within 1e-4 (measured 3.8e-6), parameters within 1e-5
        (measured 1.5e-6) after 3 steps of 1e-4."""
        params, batches = setup
        want_losses, want = jax_trainer_run(params, batches, jnp.float32)
        got_losses, got = port_trainer_run(params, batches, torch.float32)
        np.testing.assert_allclose(got_losses, want_losses, rtol=0, atol=1e-4)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)

    def test_bfloat16_body(self, setup):
        """The served bf16 body on float32 masters. Losses within 1e-2
        (measured 1.7e-3). AdamW's first steps move each weight by about
        lr * sign(g), so a bf16 rounding that flips a small gradient's sign
        moves that weight by 2 lr: the updates (after - before) are held
        by their norm, within 25% (measured 10%), where a wrong gradient
        would be off by about 100%."""
        params, batches = setup
        init = convert.seqformer_state_dict_from_flax(params)
        want_losses, want = jax_trainer_run(params, batches, jnp.bfloat16)
        got_losses, got = port_trainer_run(params, batches, torch.bfloat16)
        np.testing.assert_allclose(got_losses, want_losses, rtol=0, atol=1e-2)
        for name, w in want.items():
            step_w, step_g = w - init[name], got[name] - init[name]
            gap = float((step_g - step_w).norm() / step_w.norm())
            assert gap < 0.25, (name, gap)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["float32", "bfloat16"])
    def test_remat_gives_the_same_steps(self, setup, dtype):
        params, batches = setup
        want_losses, want = port_trainer_run(params, batches, dtype)
        got_losses, got = port_trainer_run(params, batches, dtype, remat=True)
        assert got_losses == want_losses
        for name, w in want.items():
            assert torch.equal(got[name], w), name

    def test_mesh_and_tp_rules_name_the_parallel_plane(self):
        model = SeqFormer(seq_len=8, input_dim=4, dim=16, depth=1, heads=1)
        for kwargs in ({"mesh": object()}, {"tp_rules": {}}):
            with pytest.raises(NotImplementedError, match="A15"):
                Trainer(model, device="cpu", **kwargs)


class TestRecipe:
    def test_longcontext_batch_is_jax_s(self):
        for seed in (0, 7):
            want = jax_mc.longcontext_batch(np.random.default_rng(seed), 3,
                                            512, 1024)
            got = mc.longcontext_batch(np.random.default_rng(seed), 3, 512,
                                       1024)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)

    def test_train_auto_resolves_per_device(self, monkeypatch):
        assert mc.resolve_train_attention("train-auto", "cpu") == "full"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert mc.resolve_train_attention("train-auto") == "flash"
        assert mc.resolve_train_attention("train-auto", "cuda") == "flash"
        for strategy in ("full", "flash", "ring"):
            assert mc.resolve_train_attention(strategy, "cpu") == strategy

    def test_defaults_are_jax_s(self):
        import inspect

        want = inspect.signature(jax_mc.train_longcontext).parameters
        got = inspect.signature(mc.train_longcontext).parameters
        for name, param in want.items():
            assert got[name].default == param.default, name
        assert mc.MIN_EVAL == jax_mc.MIN_EVAL
        assert set(mc.RECIPES) == set(jax_mc.RECIPES)

    @pytest.mark.parametrize("name,item", [
        ("landcover", "A16"), ("landcover128", "A16"),
        ("megadetector", "A10"), ("species", "A10"), ("species_fine", "A10"),
        ("moe", "A14")])
    def test_unported_recipes_name_their_roadmap_item(self, tmp_path, name,
                                                      item):
        with pytest.raises(NotImplementedError, match=item):
            mc.make_checkpoint(name, str(tmp_path))
        with pytest.raises(NotImplementedError, match=item):
            mc.main(["--out", str(tmp_path), "--only", name, "--device",
                     "cpu"])

    def test_trains_saves_and_serves(self, tmp_path):
        """JAX's toy longcontext test (100 steps, gate 0.5) through the
        port: trained above 0.5 (measured 0.77), saved as ``.npz`` with a
        manifest entry in JAX's shape, restored by ``build_worker``; the
        served model reproduces the trainer's eval on its own held-out
        sequences and beats random weights by 0.2 on fresh ones."""
        entry = mc.make_checkpoint("longcontext", str(tmp_path), min_eval=0.5,
                                   steps=100, attention="full", device="cpu",
                                   **TOY)
        assert entry["eval"]["accuracy"] >= 0.5
        assert set(entry) == {"family", "kwargs", "eval", "path"}
        assert entry["path"] == str(tmp_path / "longcontext.npz")
        manifest = json.loads((tmp_path / "MANIFEST.json").read_text())
        assert manifest == {"longcontext": entry}
        kwargs = entry["kwargs"]
        assert kwargs["vocab_size"] == 256 and kwargs["attention"] == "flash"

        def servable(checkpoint=None):
            model = {"family": "seqformer", "name": "longcontext",
                     **kwargs, "buckets": [16]}
            if checkpoint:
                model["checkpoint"] = checkpoint
            worker, _, _ = build_worker({"models": [model]}, device="cpu")
            return worker.runtime

        def accuracy(runtime, toks, labels):
            out = runtime.run_batch("longcontext", toks)
            return float((out.argmax(-1) == labels).mean())

        trained, random = servable(entry["path"]), servable()
        rng = np.random.default_rng(1)  # the eval draws from seed + 1
        held_out = [mc.longcontext_batch(rng, 16, 128, 256) for _ in range(4)]
        hits = np.mean([accuracy(trained, *b) for b in held_out])
        assert hits == pytest.approx(entry["eval"]["accuracy"], abs=1e-3)
        toks, labels = mc.longcontext_batch(np.random.default_rng(77), 16,
                                            128, 256)
        acc, rand = accuracy(trained, toks, labels), accuracy(random, toks,
                                                              labels)
        assert acc >= 0.5 and acc > rand + 0.2, (acc, rand)

    def test_unconverged_training_is_refused(self, tmp_path):
        with pytest.raises(AssertionError, match="below"):
            mc.make_checkpoint("longcontext", str(tmp_path), min_eval=0.99,
                               steps=1, attention="full", device="cpu",
                               **TOY)
        assert not (tmp_path / "longcontext.npz").exists()


class TestFlaxTreeFromStateDict:
    @pytest.mark.parametrize("vocab_size", [VOCAB, None],
                             ids=["tokens", "features"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["float32", "bfloat16"])
    def test_round_trip_is_exact(self, vocab_size, dtype):
        model = create_seqformer(**SMALL, vocab_size=vocab_size, dtype=dtype,
                                 device="cpu")
        sd = model.state_dict()
        tree = convert.seqformer_flax_from_state_dict(sd)
        back = convert.seqformer_state_dict_from_flax(tree)
        assert set(back) == set(sd)
        for name, tensor in sd.items():
            assert torch.equal(back[name], tensor.float()), name

    def test_flax_reads_the_tree(self, tmp_path):
        """The ``.npz`` a trained port model saves is a tree flax's
        SeqFormer applies: float32 logits within 1e-4 of the port's."""
        model = create_seqformer(**SMALL, vocab_size=VOCAB,
                                 dtype=torch.float32, attention="flash",
                                 device="cpu",
                                 generator=torch.Generator().manual_seed(4))
        path = str(tmp_path / "longcontext.npz")
        convert.save_npz(convert.seqformer_flax_from_state_dict(
            model.state_dict()), path)
        x = np.random.default_rng(6).integers(0, VOCAB, (2, 256), np.int32)
        want = np.asarray(FlaxSeqFormer(
            **SMALL, vocab_size=VOCAB, dtype=jnp.float32,
            attn_fn=jax_attention_for(None, "flash")).apply(
                convert.load_npz(path), jnp.asarray(x)))
        with torch.inference_mode():
            got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    def test_missing_key_raises(self):
        sd = create_seqformer(**SMALL, vocab_size=VOCAB,
                              device="cpu").state_dict()
        sd.pop("blocks.1.mlp_up.bias")
        with pytest.raises(ValueError, match="blocks.1.mlp_up.bias"):
            convert.seqformer_flax_from_state_dict(sd)
