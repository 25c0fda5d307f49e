"""The port's checkpoints (``ai4e_tpu_torch.checkpoint``) against the JAX
package's (``ai4e_tpu/checkpoint.py``, orbax), case by case as
``tests/test_checkpoint.py`` runs them: the params round trip, the rolling
manager (and a sweep of steps, intervals and retentions whose ``save``
answers and surviving steps must be orbax's), a trainer's resume, and a
checkpoint saved at tp = 2 in two gloo ranks resumed on one device."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parallel import RANK_TIMEOUT_S, run_ranks
from test_torch_trainer_tp import VIT, flat_inputs, images, vit_params

from ai4e_tpu import checkpoint as jax_ckpt
from ai4e_tpu.models.vit import ViT as FlaxViT
from ai4e_tpu.parallel import MeshSpec as JaxMeshSpec
from ai4e_tpu.parallel import make_mesh as jax_make_mesh
from ai4e_tpu.train import Trainer as JaxTrainer
from ai4e_tpu.train import cross_entropy_loss as jax_cross_entropy
from ai4e_tpu_torch import checkpoint as ckpt
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.models.vit import ViT
from ai4e_tpu_torch.train import Trainer

#: A resumed step against the run that was not interrupted: the same
#: float32 sums on one device as in the ranks but for tp's order.
RESUME_RTOL = 2e-5
#: The port's ViT against flax's after the same steps (float32).
JAX_LOSS_RTOL = 1e-4


def tiny_params() -> dict:
    return {"dense": {"kernel": np.arange(12, dtype=np.float32).reshape(3, 4),
                      "bias": np.ones((4,), np.float32)},
            "scale": np.asarray(2.5, np.float32)}


def as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def trees_equal(a, b) -> bool:
    flat_a, flat_b = convert.flatten_tree(a), convert.flatten_tree(b)
    return set(flat_a) == set(flat_b) and all(
        np.array_equal(np.asarray(flat_a[k]), np.asarray(flat_b[k]))
        for k in flat_a)


class TestParamsRoundTrip:
    def test_save_load(self, tmp_path):
        params = tiny_params()
        jax_ckpt.save_params(str(tmp_path / "jax"), as_jax(params))
        want = jax_ckpt.load_params(str(tmp_path / "jax"),
                                    like=as_jax(params))
        ckpt.save_params(str(tmp_path / "ckpt"), params)
        got = ckpt.load_params(str(tmp_path / "ckpt"), like=params)
        assert trees_equal(got, jax.tree.map(np.asarray, want))
        assert trees_equal(got, params)

    def test_load_without_template(self, tmp_path):
        params = tiny_params()
        jax_ckpt.save_params(str(tmp_path / "jax"), as_jax(params))
        want = jax_ckpt.load_params(str(tmp_path / "jax"))
        ckpt.save_params(str(tmp_path / "ckpt"), params)
        got = ckpt.load_params(str(tmp_path / "ckpt"))
        np.testing.assert_array_equal(got["dense"]["kernel"],
                                      np.asarray(want["dense"]["kernel"]))
        assert (tmp_path / "ckpt.npz").is_file()

    def test_save_overwrites(self, tmp_path):
        for save, load, where in (
                (jax_ckpt.save_params, jax_ckpt.load_params, "jax"),
                (ckpt.save_params, ckpt.load_params, "ckpt")):
            path = str(tmp_path / where)
            save(path, {"w": jnp.zeros(3) if where == "jax" else np.zeros(3)})
            save(path, {"w": jnp.ones(3) if where == "jax" else np.ones(3)})
            assert np.allclose(load(path)["w"], 1.0), where

    def test_tensors_and_bfloat16_round_trip_to_the_template(self, tmp_path):
        """Tensors save as arrays; a bfloat16 leaf as float32, exactly, and
        comes back as the template's type."""
        g = torch.Generator().manual_seed(0)
        params = {"w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
                  "b": torch.randn(3, generator=g)}
        ckpt.save_params(str(tmp_path / "t"), params)
        got = ckpt.load_params(str(tmp_path / "t"), like=params)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"], params["w"])
        assert torch.equal(got["b"], params["b"])
        with pytest.raises(ValueError, match="shape"):
            ckpt.load_params(str(tmp_path / "t"),
                             like={"w": torch.zeros(3, 4), "b": params["b"]})


class TestManager:
    def test_rolling_retention_and_latest(self, tmp_path):
        params = tiny_params()
        outcomes = {}
        for name, mgr, tree in (
                ("jax", jax_ckpt.CheckpointManager(str(tmp_path / "jax"),
                                                   max_to_keep=2),
                 as_jax(params)),
                ("port", ckpt.CheckpointManager(str(tmp_path / "port"),
                                                max_to_keep=2), params)):
            saved = [mgr.save(step, tree) for step in (1, 2, 3)]
            mgr.wait()
            restored = mgr.restore(tree)
            outcomes[name] = (saved, mgr.latest_step(), restored["step"])
            assert trees_equal(jax.tree.map(np.asarray, restored["params"]),
                               params)
            mgr.close()
        assert outcomes["port"] == outcomes["jax"] == ([True] * 3, 3, 3)
        assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
            "2", "3"]

    def test_save_interval_policy(self, tmp_path):
        params = tiny_params()
        got = {}
        for name, cls, tree in (("jax", jax_ckpt.CheckpointManager,
                                 as_jax(params)),
                                ("port", ckpt.CheckpointManager, params)):
            mgr = cls(str(tmp_path / name), save_interval_steps=5)
            got[name] = [mgr.save(step, tree) for step in (0, 1, 5)]
            mgr.close()
        assert got["port"] == got["jax"] == [True, False, True]

    def test_extra_metadata_round_trip(self, tmp_path):
        params = tiny_params()
        for name, cls, tree in (("jax", jax_ckpt.CheckpointManager,
                                 as_jax(params)),
                                ("port", ckpt.CheckpointManager, params)):
            mgr = cls(str(tmp_path / name))
            assert mgr.save(4, tree, extra={"lr": 0.1, "epoch": 2})
            mgr.wait()
            assert mgr.restore(tree)["extra"] == {"lr": 0.1, "epoch": 2}
            mgr.close()

    def test_restore_empty_raises(self, tmp_path):
        for name, cls in (("jax", jax_ckpt.CheckpointManager),
                          ("port", ckpt.CheckpointManager)):
            mgr = cls(str(tmp_path / name))
            with pytest.raises(FileNotFoundError):
                mgr.restore(tiny_params())
            mgr.close()

    @pytest.mark.parametrize("interval,keep,steps", [
        (1, 3, list(range(8))),
        (2, 3, list(range(10))),
        (3, 2, list(range(1, 12))),
        (5, None, list(range(17))),
        (4, 1, [1, 2, 3, 4, 8, 8, 7, 12, 13, 16]),
        (1, None, [5, 3, 5, 6]),
        (3, 3, [2, 3, 6, 6, 9, 1, 12]),
    ], ids=["every-keep3", "every2-keep3", "every3-from1-keep2",
            "every5-keepall", "every4-repeats-keep1", "backwards-keepall",
            "every3-first-off-interval"])
    def test_policy_sweep_is_orbax_s(self, tmp_path, interval, keep, steps):
        """The same ``save`` answers, step by step, and the same surviving
        steps after each save, as JAX's manager over orbax."""
        params = tiny_params()
        jmgr = jax_ckpt.CheckpointManager(str(tmp_path / "jax"),
                                          max_to_keep=keep,
                                          save_interval_steps=interval)
        pmgr = ckpt.CheckpointManager(str(tmp_path / "port"),
                                      max_to_keep=keep,
                                      save_interval_steps=interval)
        for step in steps:
            want = jmgr.save(step, as_jax(params))
            jmgr.wait()
            assert pmgr.save(step, params) == want, step
            assert pmgr.all_steps() == sorted(jmgr._mgr.all_steps()), step
            assert pmgr.latest_step() == jmgr.latest_step(), step
        jmgr.close()

    def test_a_kill_mid_save_leaves_the_latest_step(self, tmp_path,
                                                    monkeypatch):
        """A save that dies before its rename leaves the previous step the
        latest and whole; the next save of that step succeeds."""
        params = tiny_params()
        mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
        assert mgr.save(1, params, {"mu": params})
        calls = []

        def dying(path, tree):
            calls.append(path)
            if len(calls) == 2:  # the optimizer state: params are written
                raise KeyboardInterrupt("killed")
            real(path, tree)

        real = ckpt._write_npz
        monkeypatch.setattr(ckpt, "_write_npz", dying)
        with pytest.raises(KeyboardInterrupt):
            mgr.save(2, params, {"mu": params})
        monkeypatch.setattr(ckpt, "_write_npz", real)
        assert mgr.latest_step() == 1 and mgr.all_steps() == [1]
        assert trees_equal(mgr.restore(params, {"mu": params})["opt_state"],
                           {"mu": params})
        assert mgr.save(2, params)
        assert mgr.all_steps() == [1, 2]


def jax_vit_trainer(params: dict):
    model = FlaxViT(**VIT, dtype=jnp.float32)
    mesh = jax_make_mesh(JaxMeshSpec(dp=1), devices=jax.devices("cpu")[:1])
    return mesh, JaxTrainer(model.apply, as_jax(params), mesh,
                            loss_fn=jax_cross_entropy)


def port_vit_trainer(params: dict | None = None) -> Trainer:
    model = ViT(**VIT, image_size=16, dtype=torch.float32)
    if params is not None:
        model.load_state_dict(convert.vit_state_dict_from_flax(params))
    return Trainer(model, device="cpu")


class TestTrainerResume:
    def test_resume_restores_params_opt_state_step(self, tmp_path):
        """Both packages: one step, saved as step 7, resumed into a fresh
        trainer (the port's from other weights), which equals the saved
        one exactly and keeps stepping: the port's next loss is JAX's."""
        params = vit_params()
        x, y = images(2, 0)
        mesh, jtrainer = jax_vit_trainer(params)
        with mesh:
            jtrainer.train_step(x, y)
            jmgr = jax_ckpt.CheckpointManager(str(tmp_path / "jax"))
            assert jax_ckpt.save_trainer(jmgr, jtrainer, step=7)
            jmgr.wait()
            _, jfresh = jax_vit_trainer(params)
            assert jax_ckpt.resume_trainer(jmgr, jfresh) == 7
            want = jfresh.train_step(x, y)
            jmgr.close()

        trainer = port_vit_trainer(params)
        trainer.train_step(x, y)
        mgr = ckpt.CheckpointManager(str(tmp_path / "port"))
        assert ckpt.save_trainer(mgr, trainer, step=7)
        fresh = port_vit_trainer()
        assert ckpt.resume_trainer(mgr, fresh) == 7
        for key, value in trainer.params.items():
            assert torch.equal(fresh.params[key], value), key
        for sk, by_name in trainer.opt_state.items():
            for key, value in by_name.items():
                assert torch.equal(fresh.opt_state[sk][key], value), (sk, key)
        got = fresh.train_step(x, y)
        assert np.isfinite(got)
        assert got == pytest.approx(want, rel=JAX_LOSS_RTOL)
        assert got == trainer.train_step(x, y)

    def test_resume_with_no_checkpoint_returns_zero(self, tmp_path):
        mesh, jtrainer = jax_vit_trainer(vit_params())
        with mesh:
            jmgr = jax_ckpt.CheckpointManager(str(tmp_path / "jax"))
            assert jax_ckpt.resume_trainer(jmgr, jtrainer) == 0
            jmgr.close()
        mgr = ckpt.CheckpointManager(str(tmp_path / "port"))
        trainer = port_vit_trainer(vit_params())
        before = {k: v.clone() for k, v in trainer.params.items()}
        assert ckpt.resume_trainer(mgr, trainer) == 0
        assert all(torch.equal(trainer.params[k], v)
                   for k, v in before.items())


SAVE_AFTER, TP_STEPS = 2, 3


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """The float32 ViT trained at tp = 2 in two ranks: two steps, then
    ``save_trainer`` (step 2; rank 0 also keeps the gathered state), then
    the third step, uninterrupted."""
    io_dir = tmp_path_factory.mktemp("ckpt_tp2")
    x, y = images(4, 1)
    case = {"train": [dict(name="tp2", model="vit",
                           kwargs=dict(VIT, image_size=16), mesh={"tp": 2},
                           params="vit", batch="x", labels="y",
                           steps=TP_STEPS, save_after=SAVE_AFTER)]}
    ranks = run_ranks("train", 2, io_dir,
                      dict(flat_inputs(vit=vit_params()), x=x, y=y), case,
                      timeout=RANK_TIMEOUT_S)
    return io_dir, ranks, (x, y)


class TestAcrossMeshes:
    def test_every_rank_reports_the_primary_s_save(self, tp2):
        _, ranks, _ = tp2
        assert [info["tp2"]["saved"] for _, info in ranks] == [True, True]

    def test_saved_at_tp2_is_the_file_one_device_saves(self, tp2, tmp_path):
        """Keys and shapes of params and moments as one device writes
        them, and the gathered params within float32 sums' order of one
        device's after the same two steps."""
        io_dir, ranks, (x, y) = tp2
        single = port_vit_trainer(vit_params())
        for _ in range(SAVE_AFTER):
            single.train_step(x, y)
        ckpt.save_trainer(ckpt.CheckpointManager(str(tmp_path)), single,
                          SAVE_AFTER)
        for name in ("params.npz", "opt_state.npz"):
            with np.load(io_dir / "tp2" / str(SAVE_AFTER) / name) as meshed, \
                    np.load(tmp_path / str(SAVE_AFTER) / name) as one:
                assert sorted(meshed.files) == sorted(one.files)
                for key in one.files:
                    assert meshed[key].shape == one[key].shape, key
                    assert meshed[key].dtype == one[key].dtype, key
        saved = ckpt.CheckpointManager(str(io_dir / "tp2")).read()
        for key, value in single.params.items():
            np.testing.assert_allclose(saved["params"][key], value.numpy(),
                                       rtol=0, atol=1e-5, err_msg=key)
        record = json.loads((io_dir / "tp2" / str(SAVE_AFTER)
                             / "record.json").read_text())
        assert record == {"step": SAVE_AFTER}

    def test_resumes_on_one_device_exactly(self, tp2):
        """Step 2; params and moments bit-equal to the gathered ones; the
        next loss the uninterrupted tp = 2 run's within 2e-5."""
        io_dir, ranks, (x, y) = tp2
        gathered = ranks[0][0]
        fresh = port_vit_trainer()
        mgr = ckpt.CheckpointManager(str(io_dir / "tp2"))
        assert ckpt.resume_trainer(mgr, fresh) == SAVE_AFTER
        for key, value in fresh.params.items():
            np.testing.assert_array_equal(
                value.numpy(), gathered[f"tp2/params/{key}"], err_msg=key)
        state = fresh.opt_state
        for sk in ("step", "exp_avg", "exp_avg_sq"):
            for key, value in state[sk].items():
                np.testing.assert_array_equal(
                    value.numpy(), gathered[f"tp2/opt/{sk}/{key}"],
                    err_msg=f"{sk} {key}")
        loss = fresh.train_step(x, y)
        for _, info in ranks:
            assert loss == pytest.approx(info["tp2"]["losses"][SAVE_AFTER],
                                         rel=RESUME_RTOL)
