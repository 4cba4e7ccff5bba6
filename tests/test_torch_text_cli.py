"""The text-to-text path of the port's command line against the JAX
package's, on the CPU: ``prepare`` -> ``train --config`` -> ``serve`` /
``generate``; mirrors ``tests/test_experiments.py``'s generate tests.

Tiny GPT-2 in f32 (2 layers, 32 wide, 4 heads, vocab 257: a size no other
test file uses, so this file's JAX programs are its own).

* ``generate`` from no checkpoint samples from a random init and says so;
  the non-GPT-2 and MoE families and a pipeline sidecar are refused with
  rc 2 (``serve`` too); ``--prompt-text`` round-trips through the
  tokenizer; a bad or out-of-vocab prompt is refused before any restore.
* Cross-package: JAX params saved by each package's trainer (4 nodes);
  the port's ``generate`` and ``serve`` at temperature 0 restore them onto
  one node and give JAX's ``generate_main`` / ``serve_main`` tokens.
* A checkpoint of another shape, or one that lacks a weight, fails
  ``serve`` and ``generate`` loudly (rc 1) and never serves random or
  partly initialised weights.
* ``train --config`` on a prepared corpus against JAX's ``main`` with the
  same file: the file's values and the flags given applied alike, losses
  and trust within 1e-5, verdicts and statistics equal (the training
  contract), the batches the corpus's.
* The flags default to None, so ``cli train`` with no ``--epochs`` runs
  ``TrainingConfig``'s 10 epochs, as JAX's does.
* ``serve --spec-k`` past ``--max-new-tokens`` exits 2 with JAX's line;
  ``serve --no-spec-decode`` and ``serve --legacy-stripe`` give JAX's
  engine knobs and streams; ``train --parallelism data`` and
  ``sequence`` reach the config as in JAX and train, the modes the port
  has not got exit 2.
"""

import contextlib
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu import cli as jcli
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.engine import trainer as jtrainer_mod
from trustworthy_dl_tpu.serve import engine as jengine_mod
from trustworthy_dl_tpu_torch import cli
from trustworthy_dl_tpu_torch.core.config import TrainingConfig
from trustworthy_dl_tpu_torch.data.tokenizer import BPETokenizer
from trustworthy_dl_tpu_torch.engine import trainer as trainer_mod
from trustworthy_dl_tpu_torch.engine.checkpoint import CheckpointManager
from trustworthy_dl_tpu_torch.models import convert
from trustworthy_dl_tpu_torch.serve import engine as engine_mod

pytestmark = pytest.mark.torchport

TINY = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=257, n_positions=48,
            seq_len=16)
JTINY = dict(TINY, dtype=jnp.float32)
TTINY = dict(TINY, dtype=torch.float32)
SERVE = ["--num-requests", "4", "--max-seq", "32", "--max-new-tokens", "6",
         "--prompt-len", "6", "--block-size", "8", "--temperature", "0"]
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _generated(out):
    """The ``generated:`` line's ids."""
    line = [ln for ln in out.splitlines() if ln.startswith("generated:")]
    return json.loads(line[-1].split(":", 1)[1])


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The same params saved by each package's 4-node trainer."""
    root = tmp_path_factory.mktemp("ckpts")
    jtr = jtrainer_mod.DistributedTrainer(
        JTrainingConfig(num_nodes=4, batch_size=8,
                        checkpoint_dir=str(root / "jax")),
        model_overrides=dict(JTINY))
    jtr.initialize()
    jtr.state = jtr.state._replace(step=jnp.asarray(7, jtr.state.step.dtype))
    jtr.global_step = 7
    jtr.save_checkpoint()
    jtr.cleanup()
    # The params as JAX restores them.
    jtr = jtrainer_mod.DistributedTrainer(
        JTrainingConfig(num_nodes=4, batch_size=8,
                        checkpoint_dir=str(root / "jax")),
        model_overrides=dict(JTINY))
    jtr.load_checkpoint()
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.device_get(jtr.state.params))
    tr = trainer_mod.DistributedTrainer(
        TrainingConfig(num_nodes=4, batch_size=8,
                       checkpoint_dir=str(root / "port")),
        model_overrides=dict(TTINY), device="cpu")
    tr.initialize(params=convert.params_from_jax(params))
    tr.state = tr.state._replace(step=7)
    tr.global_step = 7
    tr.save_checkpoint()
    return {"jax": str(root / "jax"), "port": str(root / "port"),
            "params": params}


# ---------------------------------------------------------------------------
# generate and serve
# ---------------------------------------------------------------------------


def test_generate_from_no_checkpoint_and_refusals(tmp_path, capsys):
    none = str(tmp_path / "none")
    rc = cli.generate_main(["--device", "cpu", "--checkpoint-dir", none,
                            "--prompt", "5,6,7", "--max-new-tokens", "2",
                            "--temperature", "0.8", "--top-k", "10"],
                           model_overrides=dict(TTINY))
    out = capsys.readouterr().out
    assert rc == 0
    assert f"no checkpoint under {none!r}; sampling from random init" in out
    assert len(_generated(out)) == 2
    for model in ("resnet32", "gpt2-moe"):
        assert cli.generate_main(["--model", model]) == 2
        assert cli.serve_main(["--model", model]) == 2
    assert jcli.generate_main(["--model", "resnet32"]) == 2


def test_a_pipeline_sidecar_is_refused(tmp_path, capsys):
    mgr = CheckpointManager(str(tmp_path / "pp"))
    mgr.save_metadata(7, {"parallelism": "model", "num_nodes": 4})
    (tmp_path / "pp" / "checkpoint_step_7").mkdir()
    args = ["--device", "cpu", "--checkpoint-dir", str(tmp_path / "pp")]
    assert cli.generate_main(args, model_overrides=dict(TTINY)) == 2
    assert "generation needs a data-parallel checkpoint" in \
        capsys.readouterr().out
    assert cli.serve_main(args + SERVE, model_overrides=dict(TTINY)) == 2
    assert "serving needs a data-parallel checkpoint" in \
        capsys.readouterr().out


def test_generate_from_prompt_text(tmp_path, capsys):
    tok = BPETokenizer.train("hello world of tokens " * 80, 280)
    tok.save(str(tmp_path / "tok"))
    base = ["--device", "cpu", "--checkpoint-dir", str(tmp_path / "none")]
    # The model's 512 ids outrun the tokenizer's: a sampled id past
    # the tokenizer decodes to U+FFFD instead of raising.
    rc = cli.generate_main(base + ["--prompt-text", "hello world",
                                   "--tokenizer-dir", str(tmp_path / "tok"),
                                   "--max-new-tokens", "4"],
                           model_overrides=dict(TTINY, vocab_size=512))
    out = capsys.readouterr().out
    assert rc == 0 and "prompt:     hello world" in out
    assert "generated: " in out
    assert cli.generate_main(base + ["--prompt-text", "hello world",
                                     "--tokenizer-dir",
                                     str(tmp_path / "tok")],
                             model_overrides=dict(TTINY)) == 2
    assert f"the tokenizer (vocab {tok.vocab_size}) and model " \
        "vocabularies must be compatible" in capsys.readouterr().out
    assert cli.generate_main(base + ["--prompt-text", "hi"]) == 2
    assert cli.generate_main(base + ["--prompt", "1,x"]) == 2
    assert cli.generate_main(base + ["--prompt", "5,300"],
                             model_overrides=dict(TTINY)) == 2
    assert "--prompt needs at least one token id in [0, 257)" in \
        capsys.readouterr().out


def test_generate_matches_jax_generate_main(checkpoints, capsys):
    """Greedy in f32 from the same params: the port restores its 4-node
    checkpoint onto one node and gives JAX's tokens."""
    args = ["--prompt", "3,1,4,1,5", "--max-new-tokens", "12",
            "--temperature", "0"]
    assert jcli.generate_main(args + ["--checkpoint-dir",
                                      checkpoints["jax"]],
                              model_overrides=dict(JTINY)) == 0
    jout = capsys.readouterr().out
    assert cli.generate_main(args + ["--checkpoint-dir", checkpoints["port"],
                                     "--device", "cpu"],
                             model_overrides=dict(TTINY)) == 0
    out = capsys.readouterr().out
    assert "restored step 7" in jout and "restored step 7" in out
    assert _generated(out) == _generated(jout)
    assert len(_generated(out)) == 12
    # top-k 1 at the default temperature is greedy too.
    assert cli.generate_main(args[:4] + ["--top-k", "1", "--checkpoint-dir",
                                         checkpoints["port"], "--device",
                                         "cpu"],
                             model_overrides=dict(TTINY)) == 0
    assert _generated(capsys.readouterr().out) == _generated(jout)


def _capture_engines(monkeypatch, cls):
    engines = []
    original = cls.from_config.__func__

    def from_config(klass, *args, **kwargs):
        engine = original(klass, *args, **kwargs)
        engines.append(engine)
        return engine

    monkeypatch.setattr(cls, "from_config", classmethod(from_config))
    return engines


def test_serve_matches_jax_serve_main(checkpoints, capsys, monkeypatch):
    """The same synthetic requests (the same numpy draws) at temperature
    0 from the same params: every stream equal to JAX's engine's, and only
    the weights reach the port's engine (bit-equal to the checkpoint's)."""
    jengines = _capture_engines(monkeypatch, jengine_mod.ServingEngine)
    engines = _capture_engines(monkeypatch, engine_mod.ServingEngine)
    assert jcli.serve_main(SERVE + ["--checkpoint-dir", checkpoints["jax"]],
                           model_overrides=dict(JTINY)) == 0
    assert cli.serve_main(SERVE + ["--checkpoint-dir", checkpoints["port"],
                                   "--device", "cpu"],
                          model_overrides=dict(TTINY)) == 0
    out = capsys.readouterr().out
    assert out.count("restored step 7") == 2
    assert "requests_completed: 4" in out
    jres, res = jengines[0].results, engines[0].results
    assert sorted(res) == sorted(jres) == [0, 1, 2, 3]
    for rid in res:
        assert res[rid].tokens == list(jres[rid].tokens), rid
        assert res[rid].status == jres[rid].status == "completed"
    view = engines[0].scheduler.view
    np.testing.assert_array_equal(view["wte"].numpy(),
                                  checkpoints["params"]["wte"])


def test_a_checkpoint_of_another_shape_fails_loudly(checkpoints, capsys):
    wider = dict(TTINY, n_embd=64)
    deeper = dict(TTINY, n_layer=3)
    for overrides in (wider, deeper):
        rc = cli.serve_main(SERVE + ["--checkpoint-dir", checkpoints["port"],
                                     "--device", "cpu"],
                            model_overrides=overrides)
        out = capsys.readouterr().out
        assert rc == 1
        assert "does not fit this model" in out
        assert "random init" not in out and "served" not in out
        rc = cli.generate_main(["--checkpoint-dir", checkpoints["port"],
                                "--device", "cpu"],
                               model_overrides=overrides)
        assert rc == 1 and "does not fit this model" in \
            capsys.readouterr().out


def test_a_checkpoint_missing_a_weight_fails_loudly(tmp_path, capsys):
    """A checkpoint of another structure restores by name, keeping the
    template's values where it lacks a weight; the restore for serving
    compares the saved weights with the model's and refuses."""
    tr = trainer_mod.DistributedTrainer(
        TrainingConfig(num_nodes=4, batch_size=8,
                       checkpoint_dir=str(tmp_path)),
        model_overrides=dict(TTINY), device="cpu")
    tr.initialize()
    tr.save_checkpoint()
    step_dir = tmp_path / "checkpoint_step_0"
    meta = json.loads((step_dir / "meta.json").read_text())
    meta["leaves"] = {k: v for k, v in meta["leaves"].items()
                      if not k.startswith("params/ln_f")}
    (step_dir / "meta.json").write_text(json.dumps(meta))
    payload = torch.load(step_dir / "params.pt", weights_only=True)
    torch.save({k: v for k, v in payload.items()
                if not k.startswith("params/ln_f")}, step_dir / "params.pt")
    mgr = CheckpointManager(str(tmp_path))
    mgr._write_manifest(0, mgr.path_for(0))     # the edit, committed
    assert mgr.latest_step() == 0
    rc = cli.generate_main(["--checkpoint-dir", str(tmp_path), "--device",
                            "cpu"], model_overrides=dict(TTINY))
    out = capsys.readouterr().out
    assert rc == 1 and "does not fit this model" in out
    assert "ln_f/scale" in out and "generated" not in out


# ---------------------------------------------------------------------------
# train --config
# ---------------------------------------------------------------------------


def _corpus_text(words=24000):
    rng = np.random.default_rng(3)
    vocab = ["the", "trust", "node", "gradient", "poison", "détection",
             "naïve", "東京", "x²", "42", ",", ".", "model", "step",
             "über", "layer", "attack", "'s", "token", "card"]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    return " ".join(vocab[i] for i in rng.choice(len(vocab), words,
                                                 p=p / p.sum()))


def _summary(trainer):
    hist = trainer.metrics_collector.batch_metrics
    return {
        "steps": [h["step"] for h in hist],
        "loss": [h["loss"] for h in hist],
        "trust": [h["trust_scores"] for h in hist],
        "incidents": [(r["node_id"], r["attack_type"])
                      for r in trainer.attack_history],
        "reassignments": [(r["from_node"], r["to_node"])
                          for r in trainer.reassignment_history],
        "stats": {k: trainer.get_training_stats()[k]
                  for k in ("attack_count", "global_step",
                            "training_state")},
    }


def test_train_config_matches_jax_main(tmp_path, capsys, monkeypatch):
    data = tmp_path / "data"
    data.mkdir()
    (data / "openwebtext.txt").write_text(_corpus_text(), encoding="utf-8")
    assert cli.main(["prepare", str(data / "openwebtext.txt"),
                     "--vocab-size", "256"]) == 0
    assert "tokenizer files in" in capsys.readouterr().out
    tokens = np.fromfile(data / "openwebtext.bin", np.uint16)
    holdout = len(tokens) - int(len(tokens) * 0.95)
    assert holdout >= 8 * 128 + 1, "the holdout must hold a batch"
    monkeypatch.setenv("TDDL_DATA_DIR", str(data))
    config = {"model": {"name": "gpt2"},
              "training": {"batch_size": 16, "learning_rate": 0.003,
                           "num_epochs": 2},
              "distributed": {"num_nodes": 4},
              "security": {"attack_detection": True},
              "detector_warmup": 2, "checkpoint_dir": str(tmp_path / "f")}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    seen = {}
    model = dict(TINY, n_positions=128, seq_len=128)

    class JTrainer(jtrainer_mod.DistributedTrainer):
        def __init__(self, config, **kw):
            super().__init__(config, model_overrides=dict(
                model, dtype=jnp.float32))
            seen["jax"] = self

        def initialize(self, *a, **kw):
            state = super().initialize(*a, **kw)
            seen["params"] = jax.tree_util.tree_map(
                np.asarray, jax.device_get(state.params))
            return state

    class Trainer(trainer_mod.DistributedTrainer):
        def __init__(self, config, **kw):
            super().__init__(config, **kw)
            seen["port"] = self

        def initialize(self, seed=None, params=None):
            return super().initialize(seed, params=convert.params_from_jax(
                seen["params"]))

    monkeypatch.setattr(jtrainer_mod, "DistributedTrainer", JTrainer)
    monkeypatch.setattr(trainer_mod, "DistributedTrainer", Trainer)
    batches = []
    real_step = trainer_mod.DistributedTrainer._node_batch

    def node_batch(self, batch, for_eval=False):
        batches.append(np.asarray(batch["input"]))
        return real_step(self, batch, for_eval)

    monkeypatch.setattr(trainer_mod.DistributedTrainer, "_node_batch",
                        node_batch)
    flags = ["--config", str(path), "--batch-size", "8",
             "--steps-per-epoch", "3"]
    assert jcli.main(flags + ["--checkpoint-dir", str(tmp_path / "j")]) == 0
    assert cli.train_main(flags + ["--checkpoint-dir", str(tmp_path / "t"),
                                   "--device", "cpu", "--seq-len", "128"],
                          model_overrides=dict(model,
                                               dtype=torch.float32)) == 0
    out = capsys.readouterr().out
    assert "Training completed: 6 steps" in out
    jtr, tr = seen["jax"], seen["port"]
    for side in (jtr, tr):
        c = side.config
        assert (c.batch_size, c.learning_rate, c.num_epochs, c.num_nodes,
                c.detector_warmup) == (8, 0.003, 2, 4, 2)
    assert max(int(b.max()) for b in batches) >= 128      # the corpus's
    assert max(int(b.max()) for b in batches) < 256
    port, jax_ = _summary(tr), _summary(jtr)
    assert port["steps"] == jax_["steps"] == list(range(1, 7))
    np.testing.assert_allclose(port["loss"], jax_["loss"], atol=ATOL,
                               rtol=0)
    for got, want in zip(port["trust"], jax_["trust"], strict=True):
        assert got.keys() == want.keys()
        for node in got:
            assert abs(got[node] - want[node]) <= ATOL, node
    for key in ("incidents", "reassignments", "stats"):
        assert port[key] == jax_[key], key
    assert CheckpointManager(str(tmp_path / "t")).latest_step() == 6


def test_train_takes_its_defaults_from_the_config(tmp_path, capsys):
    """No ``--epochs``: ``TrainingConfig``'s 10 epochs, as in JAX (the
    port's flag used to default to 1)."""
    parsed, jparsed = cli.build_train_parser().parse_args([]), \
        jcli.build_parser().parse_args([])
    for name in ("model", "dataset", "nodes", "epochs", "batch_size",
                 "learning_rate", "checkpoint_dir", "config"):
        assert getattr(parsed, name) is None
        assert getattr(jparsed, name) is None
    assert parsed.seed is None
    assert TrainingConfig().num_epochs == JTrainingConfig().num_epochs == 10
    rc = cli.train_main(["--device", "cpu", "--batch-size", "8",
                         "--seq-len", "16", "--steps-per-epoch", "1",
                         "--checkpoint-dir", str(tmp_path / "ck")],
                        model_overrides={k: v for k, v in TTINY.items()
                                         if k != "seq_len"})
    out = capsys.readouterr().out
    assert rc == 0
    assert "Training completed: 10 steps" in out
    assert len(re.findall(r"epoch \d+: train_loss", out)) == 10
    assert "over 4 node(s)" in out


# ---------------------------------------------------------------------------
# The serve and train flags JAX has (ROADMAP Queue C 3) and --legacy-stripe
# ---------------------------------------------------------------------------


def test_spec_k_past_max_new_tokens_is_refused_as_jax(tmp_path, capsys):
    """``--spec-k 7 --max-new-tokens 6``: both exit 2 with the same line,
    before any model is built; ``--no-spec-decode`` forces spec off first,
    so the same depth then passes the check."""
    none = str(tmp_path / "none")
    argv = ["--spec-k", "7", "--max-new-tokens", "6", "--checkpoint-dir",
            none]
    assert jcli.serve_main(argv) == 2
    jout = capsys.readouterr().out
    assert cli.serve_main(argv + ["--device", "cpu"]) == 2
    out = capsys.readouterr().out
    assert out == jout
    assert "--spec-k 7 exceeds --max-new-tokens 6" in out
    parsed = cli.build_serve_parser().parse_args(argv + ["--no-spec-decode"])
    jparsed = jcli.build_serve_parser().parse_args(
        argv + ["--no-spec-decode"])
    assert parsed.no_spec_decode is jparsed.no_spec_decode is True
    assert parsed.legacy_stripe is jparsed.legacy_stripe is False


@pytest.mark.parametrize("flags", [["--spec-k", "2", "--no-spec-decode"],
                                   ["--legacy-stripe"]],
                         ids=["no_spec_decode", "legacy_stripe"])
def test_serve_flags_match_jax_serve_main(checkpoints, capsys, monkeypatch,
                                          flags):
    """The same requests through both packages' ``serve_main`` with the
    flag: the same engine knobs (spec off; the stripe pool), exit 0 and
    every greedy stream equal."""
    jengines = _capture_engines(monkeypatch, jengine_mod.ServingEngine)
    engines = _capture_engines(monkeypatch, engine_mod.ServingEngine)
    # --block-size on the stripe pool warns in both packages.
    with pytest.warns(UserWarning) if "--legacy-stripe" in flags else \
            contextlib.nullcontext():
        assert jcli.serve_main(SERVE + flags + ["--checkpoint-dir",
                                                checkpoints["jax"]],
                               model_overrides=dict(JTINY)) == 0
    with pytest.warns(UserWarning) if "--legacy-stripe" in flags else \
            contextlib.nullcontext():
        assert cli.serve_main(SERVE + flags + ["--checkpoint-dir",
                                               checkpoints["port"],
                                               "--device", "cpu"],
                              model_overrides=dict(TTINY)) == 0
    out = capsys.readouterr().out
    assert out.count("requests_completed: 4") == 2
    jengine, engine = jengines[0], engines[0]
    assert engine.spec_k == jengine.spec_k == 0
    assert engine.paged is jengine.paged is ("--legacy-stripe" not in flags)
    jres, res = jengine.results, engine.results
    assert sorted(res) == sorted(jres) == [0, 1, 2, 3]
    for rid in res:
        assert res[rid].tokens == list(jres[rid].tokens), rid


class _Stop(Exception):
    pass


def test_train_parallelism_flag(tmp_path, capsys, monkeypatch):
    """``--parallelism data``, ``model`` and ``sequence`` reach the config
    in both packages and the port trains all three (pipeline stages: 4
    stages of the tiny model's 2 layers do not divide, so 2 nodes here;
    sequence mode without a mesh: JAX's one-device layout on the port's
    one position, a ring of 1, where JAX's CLI builds its sequence
    trainer over its 8 devices, checked here on the tiny model); tensor
    mode, once refused, trains too (one position: a TP group of 1, where
    JAX's CLI builds its (4, 2) tensor trainer)."""
    seen = {}

    class JTrainer(jtrainer_mod.DistributedTrainer):
        def __init__(self, config, **kw):
            seen["jax"] = config.parallelism
            if config.parallelism in ("sequence", "tensor"):
                super().__init__(config, model_overrides=dict(JTINY))
                seen[f"jax_mesh_{config.parallelism}"] = dict(
                    self.mesh.shape)
                seen["jax_attn"] = self.model.config.attn_impl
            raise _Stop

    monkeypatch.setattr(jtrainer_mod, "DistributedTrainer", JTrainer)
    with pytest.raises(_Stop):
        jcli.main(["--parallelism", "data", "--nodes", "4",
                   "--batch-size", "8", "--checkpoint-dir",
                   str(tmp_path / "j")])
    assert seen["jax"] == "data"
    with pytest.raises(_Stop):
        jcli.main(["--parallelism", "sequence", "--nodes", "4",
                   "--batch-size", "8", "--checkpoint-dir",
                   str(tmp_path / "js")])
    assert seen["jax"] == "sequence" and seen["jax_attn"] == "ring"
    assert seen["jax_mesh_sequence"] == {"data": 4, "seq": 2}
    with pytest.raises(_Stop):
        jcli.main(["--parallelism", "tensor", "--nodes", "4",
                   "--batch-size", "8", "--checkpoint-dir",
                   str(tmp_path / "jt")])
    assert seen["jax"] == "tensor"
    assert seen["jax_mesh_tensor"] == {"data": 4, "model": 2}
    from trustworthy_dl_tpu.parallel.sequence import set_sequence_mesh

    set_sequence_mesh(None)     # JAX's trainer bound its global mesh
    tiny = {k: v for k, v in TTINY.items() if k != "seq_len"}
    rc = cli.train_main(["--parallelism", "data", "--device", "cpu",
                         "--batch-size", "8", "--seq-len", "16",
                         "--steps-per-epoch", "1", "--epochs", "1",
                         "--checkpoint-dir", str(tmp_path / "t")],
                        model_overrides=tiny)
    out = capsys.readouterr().out
    assert rc == 0 and "Training completed: 1 steps" in out
    rc = cli.train_main(["--parallelism", "model", "--nodes", "2",
                         "--device", "cpu", "--batch-size", "8",
                         "--seq-len", "16", "--steps-per-epoch", "1",
                         "--epochs", "1", "--checkpoint-dir",
                         str(tmp_path / "model")], model_overrides=tiny)
    out = capsys.readouterr().out
    assert rc == 0 and "Training completed: 1 steps" in out
    from trustworthy_dl_tpu_torch.parallel import sequence as tseq

    rc = cli.train_main(["--parallelism", "sequence", "--nodes", "4",
                         "--device", "cpu", "--batch-size", "8",
                         "--seq-len", "16", "--steps-per-epoch", "1",
                         "--epochs", "1", "--checkpoint-dir",
                         str(tmp_path / "sequence")], model_overrides=tiny)
    out = capsys.readouterr().out
    assert rc == 0 and "Training completed: 1 steps" in out
    assert tseq.get_sequence_mesh().shape == {"data": 1, "seq": 1}
    tseq.set_sequence_mesh(None)
    rc = cli.train_main(["--parallelism", "tensor", "--nodes", "4",
                         "--device", "cpu", "--batch-size", "8",
                         "--seq-len", "16", "--steps-per-epoch", "1",
                         "--epochs", "1", "--checkpoint-dir",
                         str(tmp_path / "tensor")], model_overrides=tiny)
    out = capsys.readouterr().out
    assert rc == 0 and "Training completed: 1 steps" in out
    parsed = cli.build_train_parser()._option_string_actions[
        "--parallelism"]
    jparsed = jcli.build_parser()._option_string_actions["--parallelism"]
    assert parsed.choices == jparsed.choices
