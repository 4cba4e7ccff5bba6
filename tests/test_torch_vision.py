"""The port's vision family against the JAX package on the CPU: the
convolutional layers, ResNet and VGG forwards, the factory, the vision
loader, the float branch of ``poison_batch``, the runner's three vision
presets at small sizes (the threshold sweep on ``resnet101_byzantine``),
the runner's command line on ResNet-32 / CIFAR-10 and ``cli train
--dataset``.

Inputs come from a numpy seed; the JAX side is initialised and its
weights converted with ``models.convert.params_from_jax``.

Tolerances (f32 compute on both sides; only summation orders differ):
  * ``conv2d`` within 1e-5 of ``lax.conv_general_dilated`` at kernels 1,
    3 and 7, strides 1 and 2, on even and odd sides (XLA's "SAME" pads the
    odd pixel on the high side); GroupNorm (C a multiple of 8 and not)
    within 1e-5; the pools exact;
  * forwards of narrow ResNet-32-structured (basic), bottleneck (both
    stems) and full-width VGG-11/16 models within 1e-5, losses within
    1e-5;
  * loader batches, block counts and poisoned batches exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.attacks.adversarial import \
    plan_from_config as jplan_from_config
from trustworthy_dl_tpu.attacks.adversarial import \
    poison_batch as jpoison_batch
from trustworthy_dl_tpu.core.config import AttackConfig as JAttackConfig
from trustworthy_dl_tpu.data.loader import get_dataloader as jget_dataloader
from trustworthy_dl_tpu.models import layers as JL
from trustworthy_dl_tpu.models.factory import create_model as jcreate_model
from trustworthy_dl_tpu_torch.attacks.adversarial import plan_from_config, \
    poison_batch
from trustworthy_dl_tpu_torch.core.config import AttackConfig
from trustworthy_dl_tpu_torch.data.loader import get_dataloader
from trustworthy_dl_tpu_torch.models import convert
from trustworthy_dl_tpu_torch.models import layers as L
from trustworthy_dl_tpu_torch.models.factory import ModelFactory, \
    create_model, get_model
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.torchport

ATOL = 1e-5
#: Narrow widths of each structure (full depth plans are checked by count).
BASIC = dict(stage_sizes=(1, 1, 1), widths=(8, 16, 32), stem_width=8)
BOTTLENECK = dict(stage_sizes=(1, 2, 1), widths=(4, 8, 8), stem_width=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: torch.Tensor, want, atol: float = ATOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", [8, 9])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [1, 3, 7])
def test_conv2d_matches_xla_same_padding(kernel, stride, side):
    rng = np.random.default_rng(100 + 10 * kernel + stride + side)
    x = rng.standard_normal((2, side, side, 5)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 5, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = JL.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(x), stride)
    got = L.conv2d({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                   torch.from_numpy(x), stride)
    assert got.shape == want.shape
    _close(got, want)
    valid = L.conv2d({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                     torch.from_numpy(x), stride, padding="VALID")
    _close(valid, JL.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                            jnp.asarray(x), stride, padding="VALID"))


def test_same_padding_is_xlas():
    assert L.same_padding(32, 3, 2) == (0, 1)
    assert L.same_padding(224, 7, 2) == (2, 3)
    assert L.same_padding(32, 3, 1) == (1, 1)
    assert L.same_padding(16, 1, 2) == (0, 0)
    with pytest.raises(ValueError):
        L.conv2d({"w": torch.zeros(1, 1, 1, 1), "b": torch.zeros(1)},
                 torch.zeros(1, 2, 2, 1), padding="FULL")


@pytest.mark.parametrize("channels", [8, 12, 24, 3])
def test_groupnorm_and_pools_match_jax(channels):
    rng = np.random.default_rng(channels)
    x = rng.normal(0.3, 2.0, (2, 6, 6, channels)).astype(np.float32)
    scale = rng.normal(1.0, 0.1, channels).astype(np.float32)
    bias = rng.normal(0.0, 0.1, channels).astype(np.float32)
    want = JL.groupnorm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}, jnp.asarray(x))
    got = L.groupnorm({"scale": torch.from_numpy(scale),
                       "bias": torch.from_numpy(bias)}, torch.from_numpy(x))
    _close(got, want)
    # bf16 in, f32 out: the f32 scale and bias promote, as in JAX.
    assert L.groupnorm({"scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)},
                       torch.from_numpy(x).bfloat16()).dtype == torch.float32
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for window in (2, 3):
        np.testing.assert_array_equal(L.max_pool(xt, window, 2).numpy(),
                                      np.asarray(JL.max_pool(xj, window, 2)))
    _close(L.avg_pool_global(xt), JL.avg_pool_global(xj))


def test_inits_follow_the_jax_scheme():
    gen = torch.Generator().manual_seed(0)
    conv = L.conv_init(gen, 3, 3, 64, 128)
    assert conv["w"].shape == (3, 3, 64, 128) and not conv["b"].any()
    assert abs(float(conv["w"].std()) - (2.0 / (9 * 64)) ** 0.5) < 3e-3
    dense = L.dense_init(gen, 256, 10)
    assert abs(float(dense["w"].std()) - 1 / 16) < 5e-3
    assert float(L.dense_init(gen, 64, 10, scale=0.01)["w"].std()) < 0.02
    gn = L.groupnorm_init(16)
    assert gn["scale"].eq(1).all() and not gn["bias"].any()


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------


def _both(name, side, seed=0, **kw):
    """(torch bundle, torch params, jax bundle, jax params) from one JAX
    init, f32 compute on both sides."""
    shape = (side, side, 3)
    jb = jcreate_model(name, image_shape=shape, dtype=jnp.float32, **kw)
    tb = create_model(name, image_shape=shape, dtype=torch.float32, **kw)
    jparams = jb.init(jax.random.PRNGKey(seed))
    return tb, convert.params_from_jax(_numpy_tree(jparams)), jb, jparams


@pytest.mark.parametrize("name,side,kw", [
    ("resnet32", 16, BASIC),
    ("resnet32", 9, BASIC),
    ("resnet50", 16, BOTTLENECK),
    ("resnet101", 66, BOTTLENECK),        # the 7x7 stride-2 stem + max pool
    ("vgg11", 8, {}),
    ("vgg16", 16, {}),
])
def test_forward_and_loss_match_jax(name, side, kw):
    tb, tparams, jb, jparams = _both(name, side, **kw)
    assert tb.kind == jb.kind == "vision"
    assert tb.num_blocks == jb.num_blocks
    assert len(tree_leaves(tparams)) == len(
        jax.tree_util.tree_leaves(jparams))
    for a, b in zip(tree_leaves(tparams), jax.tree_util.tree_leaves(jparams)):
        assert tuple(a.shape) == tuple(b.shape)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, side, side, 3)).astype(np.float32)
    y = rng.integers(0, 10, 3).astype(np.int32)
    want = jb.apply(jparams, jnp.asarray(x))
    got = tb.apply(tparams, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    _close(got, want)
    np.testing.assert_allclose(
        float(tb.loss(tparams, {"input": torch.from_numpy(x),
                                "target": torch.from_numpy(y).long()})),
        float(jb.loss(jparams, {"input": jnp.asarray(x),
                                "target": jnp.asarray(y)})),
        rtol=0, atol=ATOL)


@pytest.mark.parametrize("name,blocks", [
    ("resnet32", 15), ("resnet50", 16), ("resnet101", 33), ("vgg11", 8),
    ("vgg13", 10), ("vgg16", 13)])
def test_full_configs_have_jaxs_block_counts(name, blocks):
    tb, jb = create_model(name, num_classes=10), jcreate_model(name)
    assert tb.num_blocks == jb.num_blocks == blocks
    assert tb.input_spec == {"image_shape": (32, 32, 3), "num_classes": 10}
    assert tb.config.dtype == torch.bfloat16
    for field in ("stage_sizes", "widths", "bottleneck", "stem_width",
                  "small_input"):
        if hasattr(jb.config, field):
            assert getattr(tb.config, field) == getattr(jb.config, field)


def test_factory_aliases_batches_and_the_converter_refusal():
    assert get_model is create_model
    bundle = ModelFactory().create_model("resnet32", **BASIC)
    gen = torch.Generator().manual_seed(0)
    params = bundle.init(gen)
    batch = bundle.example_batch(4, torch.Generator().manual_seed(1))
    assert batch["input"].shape == (4, 32, 32, 3)
    assert batch["input"].dtype == torch.float32
    assert batch["target"].shape == (4,) and int(batch["target"].max()) < 10
    assert np.isfinite(float(bundle.loss(params, batch)))
    # A bf16 model computes in bf16 and returns f32 logits.
    bf = create_model("vgg11")
    logits = bf.apply(bf.init(gen), batch["input"][:1])
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    bad = _numpy_tree(jcreate_model("resnet32", **BASIC).init(
        jax.random.PRNGKey(0)))
    bad["blocks"][0]["conv9"] = bad["blocks"][0].pop("conv1")
    with pytest.raises(ValueError):
        convert.params_from_jax(bad)
    with pytest.raises(ValueError):
        convert.params_from_jax({"blocks": [], "head": {"w": 0, "b": 0}})
    with pytest.raises(ValueError):
        create_model("resnet18")
    with pytest.raises(ValueError):
        create_model("vgg19")


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------


def _assert_same_batches(ours, theirs, epochs=2):
    for _ in range(epochs):
        pairs = list(zip(ours, theirs))
        assert pairs and len(pairs) == len(ours) == len(theirs)
        for a, b in pairs:
            for key in ("input", "target"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("name,kw", [
    ("cifar10", dict(image_size=8)),
    ("cifar-10", dict(image_size=8, split="validation")),
    ("cifar100", dict(image_size=4)),
    ("synthetic_vision", dict(image_size=6, seed=3)),
])
def test_vision_loader_matches_jax(name, kw, monkeypatch, tmp_path):
    monkeypatch.setenv("TDDL_DATA_DIR", str(tmp_path))   # no file there
    kw = dict(batch_size=8, num_examples=40, **kw)
    ours = get_dataloader(name, **kw)
    _assert_same_batches(ours, jget_dataloader(name, **kw))
    side = kw["image_size"]
    first = next(iter(get_dataloader(name, **kw)))
    assert first["input"].shape == (8, side, side, 3)
    assert first["input"].dtype == np.float32


def test_vision_loader_reads_cifar10_npz_and_refuses_windows(tmp_path):
    rng = np.random.default_rng(5)
    (tmp_path / "cifar10").mkdir()
    np.savez(tmp_path / "cifar10" / "cifar10.npz",
             x_train=rng.integers(0, 256, (24, 32, 32, 3), dtype=np.uint8),
             y_train=rng.integers(0, 10, (24, 1), dtype=np.uint8),
             x_test=rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
             y_test=rng.integers(0, 10, (8, 1), dtype=np.uint8))
    for split in ("train", "validation"):
        kw = dict(batch_size=4, split=split, data_dir=str(tmp_path))
        ours = get_dataloader("cifar10", **kw)
        assert len(ours) == (6 if split == "train" else 2)
        _assert_same_batches(ours, jget_dataloader("cifar10", **kw))
        batch = next(iter(ours))
        assert -1.0 <= batch["input"].min() and batch["input"].max() <= 1.0
    for loader in (get_dataloader, jget_dataloader):
        with pytest.raises(ValueError, match="token-stream sampler"):
            loader("cifar10", sampling="windows")
        with pytest.raises(ValueError, match="unknown dataset"):
            loader("mnist")


# ---------------------------------------------------------------------------
# Poisoning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kinds", [["data_poisoning"], ["backdoor"],
                                   ["data_poisoning", "backdoor"]])
def test_float_poison_batch_bit_equal_to_jax(kinds):
    """The float branch with JAX's own Gaussian draw handed in: poisoned
    images and labels bit-equal, for [n, b, H, W, C] images (the trigger
    patch) and [n, b, d] features (no patch)."""
    n = 4
    cfg = dict(attack_types=kinds, target_nodes=[1, 3], intensity=0.7,
               start_step=2)
    jplan = jplan_from_config(JAttackConfig(**cfg), n, active=True)
    plan = plan_from_config(AttackConfig(**cfg), n, active=True)
    rng = np.random.default_rng(11)
    for shape in ((n, 2, 6, 6, 3), (n, 3, 5)):
        x = rng.standard_normal(shape).astype(np.float32)
        y = rng.integers(0, 10, shape[:2]).astype(np.int32)
        key = jax.random.PRNGKey(4)
        want = jpoison_batch(jplan, {"input": jnp.asarray(x),
                                     "target": jnp.asarray(y)},
                             jnp.asarray(5), key, 10)
        k_noise, _ = jax.random.split(key)
        gauss = np.array(jax.random.normal(k_noise, shape, jnp.float32))
        got = poison_batch(plan, {"input": torch.from_numpy(x),
                                  "target": torch.from_numpy(y).long()},
                           5, 10, noise={"gauss": torch.from_numpy(gauss)})
        np.testing.assert_array_equal(got["input"].numpy(),
                                      np.asarray(want["input"]))
        np.testing.assert_array_equal(got["target"].numpy(),
                                      np.asarray(want["target"]))
        clean = [0, 2]
        np.testing.assert_array_equal(got["input"].numpy()[clean], x[clean])
        if "backdoor" in kinds and len(shape) == 5:
            assert (got["input"].numpy()[1, :, :3, :3, :] == 2.0).all()
    # Without handed-in noise the draw comes from the generator.
    gen = torch.Generator().manual_seed(0)
    out = poison_batch(plan, {"input": torch.zeros(n, 2, 4, 4, 3),
                              "target": torch.zeros(n, 2, dtype=torch.long)},
                       5, 10, generator=gen)
    assert torch.isfinite(out["input"]).all()
    assert not out["input"][0].any()


# ---------------------------------------------------------------------------
# The runner's command line
# ---------------------------------------------------------------------------


def test_runner_main_trains_resnet32_on_cifar10(tmp_path):
    """The JAX test's command line (``tests/test_experiments.py``): full
    ResNet-32 on synthetic CIFAR-10 images, 4 nodes, one epoch of 4
    steps with the attack on; the results tree is written."""
    from trustworthy_dl_tpu_torch.experiments.runner import main

    rc = main(["--name", "cli_smoke", "--model", "resnet32", "--dataset",
               "cifar10", "--nodes", "4", "--epochs", "1", "--batch-size",
               "8", "--steps-per-epoch", "4", "--attack", "--output-dir",
               str(tmp_path), "--device", "cpu"])
    assert rc == 0
    out = tmp_path / "cli_smoke"
    assert (out / "experiment_results.json").exists()
    assert (out / "experiment_report.md").exists()
    assert (out / "training_metrics.csv").exists()


@pytest.mark.parametrize("preset,overrides", [
    ("resnet32_cifar10_clean", BASIC),
    ("vgg16_cifar10_poisoning", {}),
    ("resnet101_byzantine", dict(stage_sizes=(1, 1, 1, 1),
                                 widths=(4, 4, 4, 4), stem_width=8)),
])
def test_vision_presets_run(preset, overrides, tmp_path):
    """Each vision preset end to end at its 8 nodes, on 8x8 synthetic
    images at narrow widths (VGG at full width), 2 epochs of 2 steps with
    the attack (where the preset has one) from epoch 1; the Byzantine
    preset through ``run_threshold_sweep`` at two thresholds."""
    from trustworthy_dl_tpu_torch.experiments import ExperimentRunner, \
        preset_config
    from trustworthy_dl_tpu_torch.experiments.runner import \
        run_threshold_sweep

    cfg = preset_config(preset, num_epochs=2, batch_size=8,
                        steps_per_epoch=2, attack_start_epoch=1,
                        output_dir=str(tmp_path), experiment_name=preset)
    kwargs = dict(model_overrides=dict(overrides, image_shape=(8, 8, 3)),
                  data_overrides=dict(image_size=8), device="cpu")
    if preset == "resnet101_byzantine":
        sweep = run_threshold_sweep(cfg, [0.5, 0.7], **kwargs)
        assert sorted(sweep["thresholds"]) == ["0.5", "0.7"]
        for threshold in ("0.5", "0.7"):
            assert (tmp_path / f"{preset}_t{threshold}"
                    / "experiment_results.json").exists()
        return
    results = ExperimentRunner(cfg, **kwargs).run_experiment()
    assert results["experiment_summary"]["total_steps"] == 4
    assert np.isfinite([r["training_loss"] for r in results["epoch_records"]
                        ]).all()
    assert (tmp_path / preset / "experiment_results.json").exists()


def test_cli_train_takes_dataset(capsys, tmp_path):
    """``cli train --model resnet32 --dataset cifar10 --device cpu``: the
    loader by model kind (no token geometry for a vision model)."""
    from trustworthy_dl_tpu_torch.cli import main as cli_main

    rc = cli_main(["train", "--model", "resnet32", "--dataset", "cifar10",
                   "--device", "cpu", "--nodes", "4", "--batch-size", "8",
                   "--steps-per-epoch", "2", "--epochs", "1",
                   "--checkpoint-dir",
                   str(tmp_path / "ck")], )
    assert rc == 0
    out = capsys.readouterr().out
    assert "training resnet32" in out and "epoch 0: train_loss" in out
    assert "Training completed: 2 steps" in out


def test_work_units_are_samples_for_vision_and_tokens_for_lms():
    from trustworthy_dl_tpu_torch.core.config import TrainingConfig
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer

    vision = DistributedTrainer(
        TrainingConfig(model_name="resnet32", num_nodes=4, batch_size=8),
        model_overrides=dict(BASIC), device="cpu")
    images = {"input": np.zeros((8, 32, 32, 3), np.float32),
              "target": np.arange(8, dtype=np.int32)}
    batch = vision._node_batch(images)
    assert batch["input"].dtype == torch.float32      # images stay f32
    assert batch["target"].dtype == torch.long
    assert batch["input"].shape == (4, 2, 32, 32, 3)
    assert vision.work_units(batch) == 8
    lm = DistributedTrainer(
        TrainingConfig(model_name="gpt2", num_nodes=4, batch_size=8),
        model_overrides=dict(n_layer=1, n_embd=32, n_head=4, vocab_size=64,
                             n_positions=16, seq_len=16), device="cpu")
    tokens = {"input": np.zeros((8, 16), np.int32),
              "target": np.zeros((8, 16), np.int32)}
    assert lm.work_units(lm._node_batch(tokens)) == 8 * 16


def test_training_dtype_is_the_models_compute_dtype():
    """``TrainingConfig.dtype`` reaches the model config; a dtype in
    ``model_overrides`` wins; an unknown name is refused."""
    from trustworthy_dl_tpu_torch.core.config import TrainingConfig
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer

    def model_dtype(overrides, **kw):
        config = TrainingConfig(model_name="resnet32", num_nodes=4,
                                batch_size=8, **kw)
        return DistributedTrainer(config, model_overrides=overrides,
                                  device="cpu").model.config.dtype

    assert model_dtype(dict(BASIC)) == torch.bfloat16
    assert model_dtype(dict(BASIC), dtype="float32") == torch.float32
    assert model_dtype(dict(BASIC, dtype=torch.bfloat16),
                       dtype="float32") == torch.bfloat16
    with pytest.raises(ValueError, match="dtype must be one of"):
        TrainingConfig(dtype="float16")
