"""The port's image recipes (``ai4e_tpu_torch.train.make_checkpoints``:
landcover, landcover128, megadetector, species, species_fine) against the
JAX package's: the seeded task generators, the CenterNet loss and the
detection gate; three training steps of the UNet, the ResNet and the
detector from one converted flax init through each side's recipe trainer,
in float32 and with the bfloat16 body; and the toy recipes of
``tests/test_make_checkpoints.py`` trained by the port, saved as ``.npz``
and served by JAX's servables with the trainer's eval."""

import functools
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai4e_tpu.models.detector import CenterNetDetector as FlaxDetector
from ai4e_tpu.models.detector import decode_detections as jax_decode
from ai4e_tpu.models.resnet import ResNet as FlaxResNet
from ai4e_tpu.models.unet import UNet as FlaxUNet
from ai4e_tpu.runtime.families import build_servable as jax_build_servable
from ai4e_tpu.train import make_checkpoints as jax_mc
from ai4e_tpu.train import step as jax_step
from ai4e_tpu_torch import convert
from ai4e_tpu_torch.models import CenterNetDetector, ResNet, UNet
from ai4e_tpu_torch.train import Trainer, cross_entropy_loss, segmentation_loss
from ai4e_tpu_torch.train import make_checkpoints as mc
from ai4e_tpu_torch.train.step import adamw

torch.set_num_threads(2)

IMAGE_RECIPES = ("landcover", "landcover128", "megadetector", "species",
                 "species_fine")


class TestTasks:
    @pytest.mark.parametrize("seed", [0, 7])
    @pytest.mark.parametrize("name,shape", [
        ("landcover_batch", (3, 48)), ("detector_batch", (3, 128)),
        ("species_batch", (4, 64)), ("species_fine_batch", (4, 40))])
    def test_generators_are_jax_s_bit_for_bit(self, name, shape, seed):
        want = getattr(jax_mc, name)(np.random.default_rng(seed), *shape)
        got = getattr(mc, name)(np.random.default_rng(seed), *shape)
        for g, w in zip(got, want):
            if isinstance(w, dict):
                assert set(g) == set(w)
                g, w = [g[k] for k in sorted(w)], [w[k] for k in sorted(w)]
            else:
                g, w = [g], [w]
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)

    def test_constants_are_jax_s(self):
        for name in ("STRIDE", "LANDCOVER_COLORS", "DETECTOR_COLORS",
                     "SPECIES_LABELS", "SPECIES_COLORS",
                     "SPECIES_FINE_LABELS", "MIN_EVAL"):
            np.testing.assert_array_equal(np.asarray(getattr(mc, name)),
                                          np.asarray(getattr(jax_mc, name)))
        # JAX's production table, and species_fine's longer schedule.
        assert mc.FULL_OVERRIDES == {**jax_mc.FULL_OVERRIDES,
                                     "species_fine": {"steps": 500}}

    @pytest.mark.parametrize("name", IMAGE_RECIPES)
    def test_recipe_defaults_are_jax_s(self, name):
        want = inspect.signature(jax_mc.RECIPES[name]).parameters
        got = inspect.signature(mc.RECIPES[name]).parameters
        for key, param in want.items():
            assert got[key].default == param.default, key
        assert set(got) - set(want) <= {"device"}


def detector_outputs(rng, batch, h, scale=2.0):
    return {"heatmap": (rng.standard_normal((batch, h, h, 3)) * scale
                        - 2).astype(np.float32),
            "wh": (rng.standard_normal((batch, h, h, 2)) * 3).astype(
                np.float32),
            "offset": rng.random((batch, h, h, 2)).astype(np.float32)}


class TestDetectorObjective:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_centernet_loss_is_jax_s(self, seed):
        """On a 128 px batch's targets and seeded head outputs: within
        1e-6 relative (measured 0 to 1.2e-7), the gradient of the heatmap
        logits within 1e-6 of the largest."""
        rng = np.random.default_rng(seed)
        _, targets = jax_mc.detector_batch(rng, 4, 128)
        out = detector_outputs(rng, 4, 16)
        want = float(jax_mc.centernet_loss(
            {k: jnp.asarray(v) for k, v in out.items()},
            {k: jnp.asarray(v) for k, v in targets.items()}))
        t_out = {k: torch.from_numpy(v).requires_grad_(True)
                 for k, v in out.items()}
        got = mc.centernet_loss(t_out, {k: torch.from_numpy(v)
                                        for k, v in targets.items()})
        assert float(got) == pytest.approx(want, rel=1e-6)
        got.backward()
        want_grad = np.asarray(jax.grad(lambda h: jax_mc.centernet_loss(
            {**{k: jnp.asarray(v) for k, v in out.items()}, "heatmap": h},
            {k: jnp.asarray(v) for k, v in targets.items()}))(
                jnp.asarray(out["heatmap"])))
        np.testing.assert_allclose(t_out["heatmap"].grad.numpy(), want_grad,
                                   rtol=0,
                                   atol=1e-6 * np.abs(want_grad).max())

    @pytest.mark.parametrize("wh_rel_tolerance", [None, 0.1])
    def test_detection_accuracy_is_jax_s(self, wh_rel_tolerance):
        """One set of decoded outputs (JAX's decode of seeded heads, the
        true objects planted in the first half of the scenes, their sizes
        off by 5% in odd scenes and 20% in even ones) scored by both:
        equal hits and totals, some objects missed."""
        rng = np.random.default_rng(11)
        _, targets = jax_mc.detector_batch(rng, 8, 128)
        out = detector_outputs(rng, 8, 16, scale=1.0)
        half = (np.arange(8) < 4)[:, None, None, None]
        out["heatmap"] = out["heatmap"] + 6 * targets["heatmap"] * half - 2
        scale = np.where(np.arange(8) % 2, 1.05, 1.2)[:, None, None, None]
        out["wh"] = np.where(targets["mask"] > 0, targets["wh"] * scale,
                             out["wh"]).astype(np.float32)
        decoded = {k: np.asarray(v) for k, v in jax_decode(
            {k: jnp.asarray(v) for k, v in out.items()}).items()}
        want = jax_mc.detection_accuracy(decoded, targets,
                                         wh_rel_tolerance=wh_rel_tolerance)
        got = mc.detection_accuracy(decoded, targets,
                                    wh_rel_tolerance=wh_rel_tolerance)
        assert got == want
        assert 0 < want[0] < want[1]


def perturb_batch_stats(variables, seed):
    """Running statistics away from flax's init (mean 0, var 1), so a
    step that touched them, or read them wrongly, would show."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if path[-1].key == "mean":
            return rng.standard_normal(x.shape).astype(np.float32) * 0.1
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(leaf, variables["batch_stats"])
    return {**variables, "batch_stats": stats}


#: Each family at tiny widths: its flax module and the port's, the
#: converter, a batch of (inputs, targets), both losses and the recipe's
#: learning rate.
FAMILIES = {
    "unet": dict(
        flax=lambda dt: FlaxUNet(widths=(8, 16), dtype=dt),
        port=lambda dt: UNet(widths=(8, 16), dtype=dt,
                             param_dtype=torch.float32),
        to_sd=convert.unet_state_dict_from_flax, size=32,
        batch=lambda rng: jax_mc.landcover_batch(rng, 2, 32),
        losses=(jax_step.segmentation_loss, segmentation_loss), lr=1e-3),
    "resnet": dict(
        flax=lambda dt: FlaxResNet(stage_sizes=(1, 1), num_classes=8,
                                   width=8, dtype=dt),
        port=lambda dt: ResNet(stage_sizes=(1, 1), num_classes=8, width=8,
                               dtype=dt, param_dtype=torch.float32),
        to_sd=convert.resnet_state_dict_from_flax, size=32,
        batch=lambda rng: jax_mc.species_batch(rng, 4, 32),
        losses=(jax_step.cross_entropy_loss, cross_entropy_loss), lr=1e-3),
    "detector": dict(
        flax=lambda dt: FlaxDetector(widths=(8, 16, 32), dtype=dt),
        port=lambda dt: CenterNetDetector(widths=(8, 16, 32), dtype=dt,
                                          param_dtype=torch.float32),
        to_sd=convert.detector_state_dict_from_flax, size=64,
        batch=lambda rng: jax_mc.detector_batch(rng, 2, 64),
        losses=(jax_mc.centernet_loss, mc.centernet_loss), lr=5e-4),
}


@functools.lru_cache(maxsize=None)
def trajectories(family: str, dtype: torch.dtype, lr: float | None = None):
    """Three steps of each side's recipe trainer (optax's adamw(lr,
    weight_decay=1e-5), ``lr`` the recipe's unless given; the ResNet's
    batch_stats frozen) from one flax init; returns the init, each side's
    losses and final state_dict."""
    spec = FAMILIES[family]
    lr = lr or spec["lr"]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    flax_model = spec["flax"](jdt)
    variables = flax_model.init(jax.random.PRNGKey(0), jnp.zeros(
        (1, spec["size"], spec["size"], 3), jnp.float32))
    variables = jax.tree.map(np.asarray, dict(variables))
    if "batch_stats" in variables:
        variables = perturb_batch_stats(variables, 1)
    rng = np.random.default_rng(4)
    batches = [spec["batch"](rng) for _ in range(3)]
    init = spec["to_sd"](variables)

    tr = jax_mc._trainer(flax_model.apply, jax.tree.map(jnp.asarray,
                                                        variables),
                         spec["losses"][0], lr,
                         freeze_batch_stats="batch_stats" in variables)
    want_losses = [tr.train_step(x, y) for x, y in batches]
    want = spec["to_sd"](jax.tree.map(np.asarray, tr.params))

    model = spec["port"](dtype)
    model.load_state_dict(init)
    port = Trainer(model, spec["losses"][1],
                   optimizer=lambda p: adamw(p, lr, weight_decay=1e-5),
                   device="cpu")
    got_losses = [port.train_step(x, y) for x, y in batches]
    got = {k: v.detach() for k, v in model.state_dict().items()}
    return init, (want_losses, want), (got_losses, got)


def first_gradients(family: str) -> tuple[dict, dict]:
    """Each parameter's gradient of the loss on one batch from one flax
    init with the bf16 body: JAX's (converted) and the port's."""
    spec = FAMILIES[family]
    flax_model = spec["flax"](jnp.bfloat16)
    variables = flax_model.init(jax.random.PRNGKey(0), jnp.zeros(
        (1, spec["size"], spec["size"], 3), jnp.float32))
    variables = jax.tree.map(np.asarray, dict(variables))
    if "batch_stats" in variables:
        variables = perturb_batch_stats(variables, 1)
    x, y = spec["batch"](np.random.default_rng(4))
    grads = jax.jit(jax.grad(
        lambda p: spec["losses"][0](flax_model.apply(p, x), y)))(
            jax.tree.map(jnp.asarray, variables))
    want = spec["to_sd"](jax.tree.map(np.asarray, grads))
    want = {k: v for k, v in want.items() if "running" not in k}
    model = spec["port"](torch.bfloat16)
    model.load_state_dict(spec["to_sd"](variables))
    target = ({k: torch.from_numpy(v) for k, v in y.items()}
              if isinstance(y, dict) else torch.from_numpy(y))
    spec["losses"][1](model(torch.from_numpy(np.asarray(x))),
                      target).backward()
    return want, {n: p.grad for n, p in model.named_parameters()}


class TestTrajectories:
    @pytest.mark.parametrize("family", sorted(FAMILIES))
    def test_float32(self, family):
        """Losses within 1e-4, every parameter and running statistic
        within 1e-5 after 3 steps (test_torch_train.py's tolerances)."""
        _, (want_losses, want), (got_losses, got) = trajectories(
            family, torch.float32)
        np.testing.assert_allclose(got_losses, want_losses, rtol=0, atol=1e-4)
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)

    @pytest.mark.parametrize("family", sorted(FAMILIES))
    def test_bfloat16_first_gradient(self, family):
        """The served bf16 body on float32 masters, from the same init and
        batch: every parameter's gradient within 15% of JAX's jitted one
        by norm (measured at most 10.6%, the detector's first GroupNorm
        scale of 8 elements; 4.8% elsewhere), where a wrong gradient would
        be off by about 100%, and exactly zero where JAX's is (the
        ResNet's bottlenecks behind their zero-initialised third BatchNorm
        scale)."""
        want, got = first_gradients(family)
        for name, w in want.items():
            if float(w.norm()) == 0.0:
                assert float(got[name].norm()) == 0.0, name
                continue
            gap = float((got[name] - w).norm() / w.norm())
            assert gap < 0.15, (name, gap)

    @pytest.mark.parametrize("family", sorted(FAMILIES))
    def test_bfloat16_body(self, family):
        """Three steps with the bf16 body: losses within 1e-2 (measured
        2.8e-4 ResNet, 3.6e-4 UNet) and 3e-2 for the detector (measured
        2.5e-2 at step 3, 3.5e-4 at step 1). Each update (after - before)
        within 25% of JAX's by its norm, where a wrong gradient would be
        off by about 100%: the whole model's (measured 6.5-10%) and each
        tensor's of at least 256 elements (measured at most 17%). Masters
        a float32 rounding apart cast to bf16 on either side of a rounding
        boundary, and AdamW's first steps move every weight by about lr
        whatever its gradient's size, so a near-zero gradient's sign moves
        a weight by 2 lr: on a tensor of 32 or 64 elements (a GroupNorm or
        BatchNorm scale) a few such flips measured 27-37%, which the first
        gradient's test above holds instead."""
        init, (want_losses, want), (got_losses, got) = trajectories(
            family, torch.bfloat16)
        np.testing.assert_allclose(
            got_losses, want_losses, rtol=0,
            atol=3e-2 if family == "detector" else 1e-2)
        trained = [n for n in want if "running" not in n]
        for name in trained:
            step_w, step_g = want[name] - init[name], got[name] - init[name]
            if step_w.numel() >= 256:
                gap = float((step_g - step_w).norm() / step_w.norm())
                assert gap < 0.25, (name, gap)
        step_w = torch.cat([(want[n] - init[n]).flatten() for n in trained])
        step_g = torch.cat([(got[n] - init[n]).flatten() for n in trained])
        assert float((step_g - step_w).norm() / step_w.norm()) < 0.25

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["float32", "bfloat16"])
    def test_running_statistics_never_train(self, dtype):
        """The ResNet's BatchNorm running statistics after 3 steps: the
        perturbed init's, bit for bit, as JAX's frozen ``batch_stats``;
        buffers, outside the optimizer and its weight decay."""
        init, (_, want), (_, got) = trajectories("resnet", dtype)
        stats = [k for k in init if "running" in k]
        assert len(stats) == 2 * sum(1 for k in init
                                     if k.endswith("running_mean"))
        for name in stats:
            assert torch.equal(got[name], init[name]), name
            assert torch.equal(want[name], init[name]), name
        model = FAMILIES["resnet"]["port"](dtype)
        trainable = {id(p) for p in model.parameters()}
        assert not any(id(b) in trainable for b in model.buffers())


class TestToyRecipes:
    def test_landcover_trains_saves_and_serves_in_jax(self, tmp_path):
        """JAX's toy landcover (widths 8/16, tile 32, 100 steps, gate 0.7)
        through the port; its ``.npz`` applied by JAX's unfused unet
        servable on the trainer's eval batch reproduces the recorded pixel
        accuracy within 0.01 (measured 0.001; XLA and PyTorch round the
        bf16 body's near-tie pixels apart)."""
        entry = mc.make_checkpoint("landcover", str(tmp_path), min_eval=0.7,
                                   steps=100, tile=32, batch=8,
                                   widths=(8, 16), device="cpu")
        assert entry["eval"]["pixel_accuracy"] >= 0.7
        assert entry["kwargs"] == {"widths": [8, 16], "num_classes": 4}
        assert entry["path"] == str(tmp_path / "landcover.npz")
        manifest = json.loads((tmp_path / "MANIFEST.json").read_text())
        assert manifest == {"landcover": entry}
        servable = jax_build_servable(
            "unet", name="landcover", tile=32, widths=(8, 16), num_classes=4,
            buckets=(4,), fused_postprocess=False)
        params = jax.tree.map(jnp.asarray, convert.load_npz(entry["path"]))
        img, lab = jax_mc.landcover_batch(np.random.default_rng(1), 8, 32)
        logits = np.asarray(servable.apply_fn(params, img))
        acc = float((np.argmax(logits, -1) == lab).mean())
        assert abs(acc - entry["eval"]["pixel_accuracy"]) <= 0.01, (
            acc, entry["eval"])

    def test_species_fast_through_main_serves_in_jax(self, tmp_path):
        """``main --only species --fast`` (JAX's 65 steps at 64 px) on the
        CPU: above the 0.85 gate, recorded in the manifest with its serving
        size, and its ``.npz`` in JAX's resnet servable (uint8 in, as
        deployed) scores the trainer's eval images as the trainer did,
        within 1 of 32 (measured equal)."""
        mc.main(["--out", str(tmp_path), "--only", "species", "--fast",
                 "--device", "cpu"])
        entry = json.loads((tmp_path / "MANIFEST.json").read_text())[
            "species"]
        assert entry["eval"]["accuracy"] >= mc.MIN_EVAL
        assert entry["kwargs"]["image_size"] == 64
        assert entry["kwargs"]["labels"] == jax_mc.SPECIES_LABELS
        servable = jax_build_servable(
            "resnet", name="species", image_size=64, num_classes=8,
            stage_sizes=(2, 2, 2), width=32, buckets=(4,))
        params = jax.tree.map(jnp.asarray, convert.load_npz(entry["path"]))
        img, lab = jax_mc.species_batch(np.random.default_rng(1), 32, 64)
        img = np.clip(np.round(img * 255), 0, 255).astype(np.uint8)
        hits = int((np.argmax(np.asarray(servable.apply_fn(params, img)), -1)
                    == lab).sum())
        assert abs(hits - entry["eval"]["accuracy"] * 32) <= 1

    def test_unconverged_species_is_refused(self, tmp_path):
        with pytest.raises(AssertionError, match="below"):
            mc.make_checkpoint("species", str(tmp_path), min_eval=0.99,
                               steps=1, image_size=32, batch=8,
                               stage_sizes=(1,), width=8, device="cpu")
        assert not (tmp_path / "species.npz").exists()

    @pytest.mark.parametrize("name,kwargs,metric", [
        ("landcover128", dict(steps=2, tile=32, batch=2, widths=(8, 16)),
         "pixel_accuracy_128"),
        ("megadetector", dict(steps=2, image_size=64, batch=2,
                              widths=(8, 16, 32)), "detection_accuracy"),
        ("species_fine", dict(steps=2, image_size=32, batch=4,
                              stage_sizes=(1,), width=8), "accuracy")])
    def test_every_image_recipe_runs_and_records(self, name, kwargs, metric):
        """Two steps of each other recipe on the CPU: its eval metric,
        manifest kwargs and the run's record (losses, phases, the host's
        share drawing batches)."""
        result = mc.RECIPES[name](device="cpu", **kwargs)
        (key, value), = result["eval"].items()
        assert key == metric and 0.0 <= value <= 1.0
        assert len(result["losses"]) == len(result["phases_ms"]) == 2
        assert 0 < result["data_seconds"] <= result["loop_seconds"]
        flax_tree = mc.TO_FLAX[result["family"]](result["state_dict"])
        assert convert.flatten_tree(flax_tree)
        if name == "megadetector":
            assert result["kwargs"]["image_size"] == 64
            assert result["eval_objects"]["total"] > 0
        if name == "landcover128":
            assert result["kwargs"]["tile"] == 128
