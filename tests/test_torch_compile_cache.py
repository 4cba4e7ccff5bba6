"""The port's persistent kernel-build cache (``utils/compile_cache.py``)
against the JAX package's compile cache, on the CPU.

The two functions keep JAX's names and contract: the directory is made,
a second call is a no-op, re-pointing logs the switch and libraries
already loaded stay loaded.  ``TrainingConfig.compilation_cache_dir`` is
a field of the port's config now (``load_config`` takes it without a
warning, as JAX's does) and ``DistributedTrainer`` enables it at
construction; ``cli train`` and ``cli serve`` take ``--compile-cache``,
which points the cache at ``<obs-dir or checkpoint-dir>/kernel_cache``.
Two fresh processes over one directory: the first builds the native
library (``gxx_build``) and loads it, the second only loads it — shown
here with the native library, since ``g++`` runs on the CPU (the card's
smoke shows it for the five CUDA kernel libraries).  The hash key over
``ops/csrc`` is read once per process per cache directory.  The port's
``train`` and ``serve`` parsers have every flag of JAX's.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from trustworthy_dl_tpu import cli as jcli
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu_torch import cli, native, ops
from trustworthy_dl_tpu_torch.core import config as C
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.utils import compile_cache

pytestmark = pytest.mark.torchport

REPO = Path(__file__).resolve().parents[1]
TINY = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=128,
            n_positions=32, seq_len=16, dtype=torch.float32)


@pytest.fixture
def fresh_cache(monkeypatch):
    """No cache enabled in this test; whatever it enables is undone."""
    monkeypatch.setattr(compile_cache, "_ENABLED_DIR", None)


def test_enable_makes_the_directory_and_is_idempotent(tmp_path, caplog,
                                                      fresh_cache):
    assert compile_cache.active_cache_dir() is None
    assert compile_cache.cache_dir() == compile_cache.DEFAULT_DIR
    assert compile_cache.DEFAULT_DIR == REPO / "build" / "torch_kernels"
    first = tmp_path / "a" / "kernel_cache"
    with caplog.at_level(logging.INFO, logger=compile_cache.__name__):
        got = compile_cache.enable_persistent_cache(str(first))
        assert compile_cache.enable_persistent_cache(str(first)) == got
    assert got == str(first) and first.is_dir()
    assert compile_cache.active_cache_dir() == got
    assert compile_cache.cache_dir() == first
    assert [r.getMessage() for r in caplog.records] == [
        f"persistent kernel cache enabled at {first}"]
    caplog.clear()
    second = tmp_path / "b"
    with caplog.at_level(logging.INFO, logger=compile_cache.__name__):
        compile_cache.enable_persistent_cache(str(second))
    assert [r.getMessage() for r in caplog.records] == [
        f"kernel cache re-pointed: {first} -> {second}"]
    assert ops.library_path("fused_stats").parent == second
    assert native.library_path().parent == second


def test_loaded_libraries_stay_loaded_when_re_pointed(tmp_path,
                                                      fresh_cache):
    lib = native.library()
    compile_cache.enable_persistent_cache(str(tmp_path))
    assert native.library() is lib
    assert not list(tmp_path.glob("*.so"))


def test_the_source_hash_is_read_once_per_cache_directory(tmp_path,
                                                          monkeypatch,
                                                          fresh_cache):
    reads = []
    real = Path.read_bytes
    monkeypatch.setattr(Path, "read_bytes",
                        lambda self: reads.append(self.name) or real(self))
    compile_cache.enable_persistent_cache(str(tmp_path / "one"))
    paths = {name: ops.library_path(name) for name in ops.SIGNATURES}
    sources = sorted(p.name for p in ops.CSRC.iterdir()
                     if p.suffix in (".cu", ".cuh"))
    assert sorted(reads) == sources
    assert paths == {name: ops.library_path(name)
                     for name in ops.SIGNATURES}
    assert len(reads) == len(sources)
    compile_cache.enable_persistent_cache(str(tmp_path / "two"))
    ops.library_path("fused_stats")
    assert len(reads) == 2 * len(sources)
    # Same sources and flags, same key, in either directory.
    assert ops.library_path("fused_stats").name == paths["fused_stats"].name


def test_config_field_and_load_config_take_the_cache_without_a_warning(
        tmp_path, caplog):
    assert C.TrainingConfig().compilation_cache_dir is None \
        is JTrainingConfig().compilation_cache_dir
    assert C.TrainingConfig(
        compilation_cache_dir="kc").compilation_cache_dir == "kc"
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"compilation_cache_dir": str(tmp_path / "k"),
                                "num_nodes": 2}))
    with caplog.at_level(logging.WARNING):
        config = C.load_config(str(path))
    assert caplog.records == []
    assert config.compilation_cache_dir == str(tmp_path / "k")


def test_trainer_enables_the_cache_at_construction(tmp_path, fresh_cache):
    directory = tmp_path / "run" / "kernel_cache"
    config = C.TrainingConfig(model_name="gpt2", batch_size=8, num_nodes=4,
                              compilation_cache_dir=str(directory))
    DistributedTrainer(config, model_overrides=TINY, device="cpu")
    assert compile_cache.active_cache_dir() == str(directory)
    assert directory.is_dir()


def test_cli_flags_point_the_cache_under_the_run_directory(tmp_path,
                                                           fresh_cache):
    ck = tmp_path / "ck"
    assert cli.train_main(["--device", "cpu", "--nodes", "4",
                           "--batch-size", "8", "--seq-len", "16",
                           "--steps-per-epoch", "2", "--epochs", "1",
                           "--checkpoint-dir", str(ck), "--compile-cache"],
                          model_overrides=TINY) == 0
    assert compile_cache.active_cache_dir() == str(ck / "kernel_cache")
    obs = tmp_path / "obs"
    assert cli.serve_main(["--device", "cpu", "--checkpoint-dir", str(ck),
                           "--obs-dir", str(obs), "--max-seq", "32",
                           "--block-size", "8", "--prompt-len", "6",
                           "--max-new-tokens", "4", "--num-requests", "2",
                           "--compile-cache"],
                          model_overrides=TINY) == 0
    assert compile_cache.active_cache_dir() == str(obs / "kernel_cache")


def _warm(directory):
    proc = subprocess.run(
        [sys.executable, "-m", "trustworthy_dl_tpu_torch.utils.compile_cache",
         str(directory), "--native-only"], cwd=str(REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_second_process_over_a_warm_directory_builds_nothing(tmp_path):
    first = _warm(tmp_path)
    second = _warm(tmp_path)
    assert first["cache_dir"] == second["cache_dir"] == str(tmp_path)
    assert first["events"] == {"gxx_build": ["tddl_native"],
                               "library_load": ["tddl_native"]}
    assert second["events"] == {"library_load": ["tddl_native"]}
    assert [p.name for p in tmp_path.glob("*.so")] == \
        [native.library_path().name]
    assert not list(tmp_path.glob("*.tmp"))


_TRAIN = (
    "import sys, torch\n"
    "from trustworthy_dl_tpu_torch import cli\n"
    "tiny = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=128,\n"
    "            n_positions=32, seq_len=16, dtype=torch.float32)\n"
    "sys.exit(cli.train_main(['--device', 'cpu', '--nodes', '4',\n"
    "    '--batch-size', '8', '--seq-len', '16', '--steps-per-epoch', '2',\n"
    "    '--epochs', '1', '--compile-cache', '--obs-dir', sys.argv[1]],\n"
    "    model_overrides=tiny))\n")


def _stages(obs_dir):
    snap = json.loads((obs_dir / "metrics_snapshot.json").read_text())
    return {s["labels"]["stage"]: s["value"]
            for s in snap["metrics"]["tddl_compile_seconds"]["series"]}


def test_cli_train_compile_cache_in_two_processes(tmp_path):
    """``cli train --compile-cache --obs-dir`` twice over one run
    directory: the compile watcher of the first records the native
    library's build and load, the second's only its load."""
    obs = tmp_path / "obs"
    stages = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", _TRAIN, str(obs)],
                              cwd=str(REPO), capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "compiles: 1 " in proc.stdout
        stages.append(set(_stages(obs)))
    assert stages == [{"gxx_build", "library_load"}, {"library_load"}]
    assert len(list((obs / "kernel_cache").glob("*.so"))) == 1


def _flags(parser):
    return {opt for action in parser._actions
            for opt in action.option_strings}


@pytest.mark.parametrize("command", ["train", "serve"])
def test_train_and_serve_parsers_have_every_jax_flag(command):
    jax_parser, port_parser = {
        "train": (jcli.build_parser, cli.build_train_parser),
        "serve": (jcli.build_serve_parser, cli.build_serve_parser),
    }[command]
    jflags, flags = _flags(jax_parser()), _flags(port_parser())
    assert jflags <= flags, sorted(jflags - flags)
    extras = {"train": {"--device", "--seq-len", "--remat", "--seed"},
              "serve": {"--device"}}[command]
    assert flags - jflags == extras
    assert "--compile-cache" in flags


def test_compile_cache_flag_parses_like_jax():
    for jax_parser, port_parser in ((jcli.build_parser,
                                     cli.build_train_parser),
                                    (jcli.build_serve_parser,
                                     cli.build_serve_parser)):
        jargs = jax_parser().parse_args(["--compile-cache"])
        args = port_parser().parse_args(["--compile-cache"])
        assert args.compile_cache is jargs.compile_cache is True
        assert port_parser().parse_args([]).compile_cache is False
    # JAX names its directory jax_cache (XLA's cache); the port's holds
    # kernel libraries.
    assert cli._kernel_cache_dir("run") == os.path.join("run",
                                                        "kernel_cache")
