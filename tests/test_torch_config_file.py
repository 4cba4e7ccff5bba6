"""``core.config.load_config`` of the port against the JAX package's, on
the CPU.

The same files (YAML and JSON; the nested README schema and flat field
names) resolve to the same ``TrainingConfig`` values in both packages,
field for field over the port's fields.  Overrides that are not None win
over the file.  No key that JAX applies is dropped: every field of JAX's
``TrainingConfig`` is one of the port's, the mesh and sharding keys
(``mesh_shape``, ``dcn_mesh_shape``, ``shard_params``,
``shard_opt_state``) resolve to JAX's values, ``compilation_cache_dir``
(the port's kernel-build cache) loads without a warning, and a file of
JAX's defaults loads equal to the port's.  A ``parallelism`` other than
"data" passes through and the trainer builds its mesh;
``load_experiment_config`` keeps its behaviour.
"""

import dataclasses
import json
import logging

import pytest
import yaml

from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.core.config import load_config as jload_config
from trustworthy_dl_tpu.core.config import \
    load_experiment_config as jload_experiment_config
from trustworthy_dl_tpu_torch.core.config import TrainingConfig, \
    load_config, load_experiment_config

pytestmark = pytest.mark.torchport

NESTED = {
    "model": {"name": "gpt2", "size": "medium"},
    "training": {"batch_size": 16, "learning_rate": 3e-4, "num_epochs": 4,
                 "lr_schedule": "cosine", "warmup_steps": 5,
                 "lr_decay_steps": 40, "min_lr_ratio": 0.1,
                 "optimizer": "adam", "weight_decay": 0.01,
                 "grad_clip_norm": 1.0},
    "distributed": {"num_nodes": 8, "parallelism": "data",
                    "num_microbatches": 2},
    "security": {"trust_threshold": 0.6, "attack_detection": False,
                 "gradient_verification": False},
    "dataset": "wikitext",
}
FLAT = {"model_name": "gpt2-large", "dataset_name": "openwebtext",
        "batch_size": 24, "num_nodes": 6, "num_epochs": 3,
        "detector_warmup": 4, "remat": True, "remat_policy": "attention",
        "async_host_depth": 0, "prefetch_depth": 1, "seed": 7,
        "checkpoint_interval": 9, "profile_dir": "prof",
        "debug_nans": True, "dtype": "float32", "ml_detectors": False,
        "lm_head_chunk": 0, "moment_dtype": "bfloat16",
        "elastic_resharding": True, "readmit_after_steps": 12}


def _write(tmp_path, raw, fmt):
    path = tmp_path / f"config.{fmt}"
    path.write_text(yaml.safe_dump(raw) if fmt == "yaml"
                    else json.dumps(raw))
    return str(path)


def _fields(config):
    return {f.name: getattr(config, f.name)
            for f in dataclasses.fields(TrainingConfig)}


@pytest.mark.parametrize("fmt", ["yaml", "json"])
@pytest.mark.parametrize("schema", ["nested", "flat", "both"])
def test_files_resolve_to_jax_values(tmp_path, fmt, schema):
    raw = {"nested": NESTED, "flat": FLAT,
           "both": {**NESTED, **FLAT}}[schema]
    path = _write(tmp_path, raw, fmt)
    port, jax_ = load_config(path), jload_config(path)
    assert _fields(port) == {k: getattr(jax_, k) for k in _fields(port)}
    assert _fields(port) != _fields(TrainingConfig())
    if schema == "nested":
        assert port.model_name == "gpt2-medium"
        assert port.dataset_name == "wikitext"
        assert not port.attack_detection_enabled


def test_overrides_that_are_not_none_win(tmp_path):
    path = _write(tmp_path, NESTED, "json")
    kw = dict(num_epochs=1, batch_size=None, learning_rate=None,
              checkpoint_dir="ck")
    port, jax_ = load_config(path, **kw), jload_config(path, **kw)
    assert port.num_epochs == jax_.num_epochs == 1
    assert port.batch_size == jax_.batch_size == 16
    assert port.learning_rate == jax_.learning_rate == 3e-4
    assert port.checkpoint_dir == jax_.checkpoint_dir == "ck"


@pytest.mark.parametrize("raw", [
    {"distributed": {"mesh_shape": {"data": 2, "model": 2}}},
    {"distributed": {"dcn_mesh_shape": {"data": 2}}},
    {"mesh_shape": {"data": 4}},
    {"shard_params": True},
    {"shard_opt_state": True},
], ids=["mesh_shape", "dcn_mesh_shape", "flat_mesh_shape", "shard_params",
        "shard_opt_state"])
def test_slice_4_keys_are_refused(tmp_path, raw):
    """The mesh and sharding keys, refused until the port had the tensor,
    hybrid and expert modes and ZeRO-1 / FSDP placement, now resolve to
    JAX's values (the nested ``distributed`` section and flat names)."""
    path = _write(tmp_path, raw, "yaml")
    jax_ = jload_config(path)       # JAX applies the key ...
    key = next(iter(raw["distributed"])) if "distributed" in raw \
        else next(iter(raw))
    assert getattr(jax_, key) != getattr(JTrainingConfig(), key)
    port = load_config(path)        # ... and so does the port
    assert getattr(port, key) == getattr(jax_, key)
    assert _fields(port) == {k: getattr(jax_, k) for k in _fields(port)}


def test_other_jax_fields_are_refused_by_name(tmp_path):
    """``canary_tokens`` is the pipeline's canary width in both packages
    now: a file's 16 loads to 16 in each."""
    path = _write(tmp_path, {"canary_tokens": 16}, "json")
    assert jload_config(path).canary_tokens == 16
    assert load_config(path).canary_tokens == 16


def test_jax_only_fields_at_jax_defaults_load(tmp_path):
    """A file dumped from JAX's defaults asks for nothing the port lacks:
    every field of JAX's ``TrainingConfig`` is one of the port's, and the
    file loads, equal to the defaults."""
    raw = dataclasses.asdict(JTrainingConfig())
    assert set(raw) <= {f.name for f in dataclasses.fields(TrainingConfig)}
    path = _write(tmp_path, raw, "yaml")
    assert _fields(load_config(path)) == _fields(TrainingConfig())


def test_compilation_cache_dir_warns(tmp_path, caplog):
    """The field is the port's kernel-build cache now: it loads as JAX's
    does, and nothing warns about it."""
    path = _write(tmp_path, {"compilation_cache_dir": "jax_cache",
                             "num_epochs": 2}, "yaml")
    with caplog.at_level(logging.WARNING):
        config = load_config(path)
    warned = [r for r in caplog.records
              if "compilation_cache_dir" in r.getMessage()]
    assert warned == []
    assert config.num_epochs == 2
    assert config.compilation_cache_dir == "jax_cache"
    assert jload_config(path).compilation_cache_dir == "jax_cache"


def test_unknown_keys_are_ignored_like_jax(tmp_path):
    path = _write(tmp_path, {"num_nodes": 2, "not_a_field": 1,
                             "training": {"nonsense": 3}}, "json")
    assert load_config(path).num_nodes == jload_config(path).num_nodes == 2


def test_parallelism_passes_through_and_the_trainer_refuses(tmp_path):
    """A file's ``parallelism`` reaches the trainer, which builds the
    mode's mesh (tensor mode without positions: JAX's one-device
    layout) where it refused the mode before; a hybrid file's
    ``mesh_shape`` builds its positions."""
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer

    tiny = dict(n_layer=1, n_embd=16, n_head=2, vocab_size=64,
                n_positions=16, seq_len=8)
    path = _write(tmp_path, {"distributed": {"parallelism": "tensor"}},
                  "yaml")
    config = load_config(path)
    assert config.parallelism == jload_config(path).parallelism == "tensor"
    tr = DistributedTrainer(config, model_overrides=tiny, device="cpu")
    assert tr.mesh.shape == {"data": 1, "model": 1}
    path = _write(tmp_path, {"distributed": {
        "parallelism": "hybrid", "mesh_shape": {"data": 2, "model": 2}}},
        "json")
    config = load_config(path)
    assert config.mesh_shape == jload_config(path).mesh_shape
    tr = DistributedTrainer(config, model_overrides=tiny, device="cpu")
    assert tr.mesh.shape == {"data": 2, "model": 2}


def test_new_fields_default_as_in_jax():
    port, jax_ = TrainingConfig(), JTrainingConfig()
    assert (port.profile_dir, port.debug_nans) == \
        (jax_.profile_dir, jax_.debug_nans) == (None, False)


def test_load_experiment_config_keeps_its_behaviour(tmp_path):
    """The experiment loader ignores the TrainingConfig-only keys (the
    mesh included), as JAX's does."""
    raw = {**NESTED, "experiment_name": "exp", "steps_per_epoch": 7,
           "target_nodes": [2], "canary_tokens": 16,
           "distributed": {**NESTED["distributed"],
                           "mesh_shape": {"data": 2}}}
    path = _write(tmp_path, raw, "yaml")
    port = load_experiment_config(path, num_epochs=2, seed=None)
    jax_ = jload_experiment_config(path, num_epochs=2, seed=None)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_)
    assert port.num_epochs == 2 and port.steps_per_epoch == 7
