"""The port's corpus lookup and host prefetch against the JAX package's.

``get_dataloader`` reads ``data_dir``, else ``$TDDL_DATA_DIR``: a
``<name>.bin`` of uint16 tokens first, else a ``<name>.txt`` whose raw
UTF-8 bytes are the ids (``vocab_size`` >= 256), each split 95/5 into
train and validation.  The corpora are written here, into ``tmp_path``;
both packages' loaders must yield equal windows over two epochs, in both
sampling modes, and refuse a byte-level corpus under vocab 256 alike.
``PrefetchLoader`` must keep its loader's order, stop its thread when the
consumer leaves early, and raise the loader's error in the consumer; and
``ArrayDataLoader`` must take a live re-size (an elastic eviction's) on
the next batch, as JAX's does.
"""

import threading

import numpy as np
import pytest

from trustworthy_dl_tpu.data.loader import PrefetchLoader as JPrefetchLoader
from trustworthy_dl_tpu.data.loader import get_dataloader as jget_dataloader
from trustworthy_dl_tpu_torch.data.loader import ArrayDataLoader, \
    PrefetchLoader, get_dataloader

pytestmark = pytest.mark.torchport

TEXT = ("It is a truth universally acknowledged, that a single man in "
        "possession of a good fortune, must be in want of a wife. ") * 40


def _write_bin(tmp_path, name="openwebtext", n=6000):
    tokens = (1000 + np.arange(n) % 40000).astype(np.uint16)
    tokens.tofile(tmp_path / f"{name}.bin")
    return tokens


def _write_txt(tmp_path, name="wikitext"):
    (tmp_path / f"{name}.txt").write_bytes(TEXT.encode("utf-8"))


def _assert_same_batches(dl, jdl, epochs=2):
    n = 0
    for _ in range(epochs):
        for b, jb in zip(dl, jdl, strict=True):
            np.testing.assert_array_equal(b["input"], jb["input"])
            np.testing.assert_array_equal(b["target"], jb["target"])
            n += 1
    assert n > 0


@pytest.mark.parametrize("sampling", ["epoch", "windows"])
@pytest.mark.parametrize("split", ["train", "validation"])
def test_bin_corpus_under_tddl_data_dir_matches_jax(tmp_path, monkeypatch,
                                                    sampling, split):
    tokens = _write_bin(tmp_path)
    monkeypatch.setenv("TDDL_DATA_DIR", str(tmp_path))
    kw = dict(split=split, batch_size=4, seq_len=16, vocab_size=50257,
              num_examples=12, seed=3, sampling=sampling)
    dl = get_dataloader("openwebtext", **kw)
    first = next(iter(get_dataloader("openwebtext", **kw)))["input"]
    assert first.min() >= 1000          # the corpus, not synthetic tokens
    cut = int(len(tokens) * 0.95)
    part = tokens[:cut] if split == "train" else tokens[cut:]
    row = first[0]
    start = int(np.nonzero(part == row[0])[0][0])
    np.testing.assert_array_equal(row, part[start:start + 16])
    _assert_same_batches(dl, jget_dataloader("openwebtext", **kw))


@pytest.mark.parametrize("sampling", ["epoch", "windows"])
def test_txt_corpus_is_byte_level_and_matches_jax(tmp_path, monkeypatch,
                                                  sampling):
    _write_txt(tmp_path)
    monkeypatch.setenv("TDDL_DATA_DIR", str(tmp_path))
    kw = dict(batch_size=4, seq_len=16, vocab_size=256, num_examples=16,
              seed=1, sampling=sampling)
    dl = get_dataloader("wikitext", **kw)
    batch = next(iter(get_dataloader("wikitext", **kw)))
    raw = np.frombuffer(TEXT.encode("utf-8"), np.uint8)
    row = batch["input"][0]
    assert row.max() < 256
    hits = [i for i in range(len(raw) - 16)
            if np.array_equal(raw[i:i + 16], row)]
    assert hits, "the window is not a slice of the corpus's bytes"
    _assert_same_batches(dl, jget_dataloader("wikitext", **kw))


def test_explicit_data_dir_wins_over_the_environment(tmp_path, monkeypatch):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    _write_bin(tmp_path / "a")
    monkeypatch.setenv("TDDL_DATA_DIR", str(tmp_path / "b"))
    kw = dict(batch_size=4, seq_len=16, num_examples=8)
    from_arg = next(iter(get_dataloader("openwebtext",
                                        data_dir=str(tmp_path / "a"), **kw)))
    from_env = next(iter(get_dataloader("openwebtext", **kw)))
    assert from_arg["input"].min() >= 1000 and from_env["input"].max() < 512
    _assert_same_batches(
        get_dataloader("openwebtext", data_dir=str(tmp_path / "a"), **kw),
        jget_dataloader("openwebtext", data_dir=str(tmp_path / "a"), **kw))


def test_byte_level_corpus_refuses_a_small_vocab_in_both(tmp_path,
                                                         monkeypatch):
    _write_txt(tmp_path)
    monkeypatch.setenv("TDDL_DATA_DIR", str(tmp_path))
    for loader in (get_dataloader, jget_dataloader):
        with pytest.raises(ValueError, match="needs vocab_size >= 256"):
            loader("wikitext", batch_size=4, seq_len=16, vocab_size=128)


def test_without_a_corpus_both_use_the_synthetic_source(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("TDDL_DATA_DIR", str(tmp_path))   # empty
    kw = dict(batch_size=4, seq_len=16, vocab_size=128, num_examples=16)
    _assert_same_batches(get_dataloader("openwebtext", **kw),
                         jget_dataloader("openwebtext", **kw))


def test_prefetch_keeps_order_and_matches_jax():
    kw = dict(batch_size=4, seq_len=16, vocab_size=128, num_examples=32)
    ref = [b["input"] for b in get_dataloader("openwebtext", **kw)]
    for depth in (1, 2, 5):
        got = PrefetchLoader(get_dataloader("openwebtext", **kw),
                             depth=depth)
        jgot = JPrefetchLoader(jget_dataloader("openwebtext", **kw),
                               depth=depth)
        assert len(got) == len(ref)
        for a, b, want in zip(got, jgot, ref, strict=True):
            np.testing.assert_array_equal(a["input"], want)
            np.testing.assert_array_equal(b["input"], want)


def test_prefetch_early_exit_stops_its_thread():
    before = threading.active_count()
    items = ({"input": np.full(2, i)} for i in range(1000))
    it = iter(PrefetchLoader(items, depth=2))
    assert int(next(it)["input"][0]) == 0
    assert int(next(it)["input"][0]) == 1
    it.close()                          # the consumer leaves, queue full
    assert threading.active_count() == before


def test_prefetch_raises_the_loaders_error_in_the_consumer():
    def broken():
        yield {"input": np.zeros(2)}
        yield {"input": np.ones(2)}
        raise OSError("disk went away")

    got = []
    with pytest.raises(OSError, match="disk went away"):
        for batch in PrefetchLoader(broken(), depth=1):
            got.append(float(batch["input"][0]))
    assert got == [0.0, 1.0]


def test_array_loader_takes_a_live_resize_like_jax():
    """An eviction re-sizes the loader mid-epoch: the next batch has the
    new size (the same rows as JAX's loader gives)."""
    from trustworthy_dl_tpu.data.loader import \
        ArrayDataLoader as JArrayDataLoader

    x = np.arange(40 * 3).reshape(40, 3)
    dl, jdl = ArrayDataLoader(x, x, 8, seed=2), JArrayDataLoader(x, x, 8,
                                                                 seed=2)
    sizes = []
    for i, (b, jb) in enumerate(zip(dl, jdl, strict=True)):
        np.testing.assert_array_equal(b["input"], jb["input"])
        sizes.append(len(b["input"]))
        if i == 1:
            dl.batch_size = jdl.batch_size = 6
    assert sizes == [8, 8, 6, 6, 6, 6]
