"""The port's C++ host tier (``trustworthy_dl_tpu_torch/native``) against
its numpy twins and the JAX package's tier, on the CPU.

Mirrors ``tests/test_native.py``: every C entry is bit-equal to its numpy
twin and to ``trustworthy_dl_tpu.native`` on inputs made from a seed
with numpy (splitmix streams, the synthetic chain, permutations, row and
window gathers, the BPE encoder through the tokenizer); the port's
loaders yield JAX's batches for the same seed; the tokenizer's batch
encoder gives the ids of JAX's ``BPETokenizer.encode`` and of the port's
Python loop, also when two tokenizers take turns with the encoder's one
merge table.  There is no fallback: a build that cannot find ``g++``, or
whose ``g++`` fails, raises with the reason.
"""

import numpy as np
import pytest

from trustworthy_dl_tpu import native as jnative
from trustworthy_dl_tpu.data import loader as jloader
from trustworthy_dl_tpu.data import tokenizer as J
from trustworthy_dl_tpu_torch import native
from trustworthy_dl_tpu_torch.data import loader
from trustworthy_dl_tpu_torch.data import tokenizer as T
from trustworthy_dl_tpu_torch.utils import compile_cache

pytestmark = pytest.mark.torchport

SEED = 20260


def _seeds(n):
    return np.random.default_rng(SEED).integers(0, 2**63, n).tolist()


@pytest.mark.parametrize("seed", _seeds(3))
@pytest.mark.parametrize("n", [0, 1, 4096])
def test_splitmix_fill_matches_twin_and_jax(seed, n):
    got = native.splitmix_fill(seed, n)
    np.testing.assert_array_equal(got, native.splitmix_fill_plain(seed, n))
    np.testing.assert_array_equal(got, jnative.splitmix_fill(seed, n))
    assert got.dtype == np.uint64 and got.shape == (n,)


@pytest.mark.parametrize("vocab", [2, 512, 50257])
def test_synthetic_tokens_match_twin_and_jax(vocab):
    got = native.synthetic_tokens(10_000, vocab, 7)
    np.testing.assert_array_equal(
        got, native.synthetic_tokens_plain(10_000, vocab, 7))
    np.testing.assert_array_equal(got, jnative.synthetic_tokens(10_000,
                                                                vocab, 7))
    if vocab == 512:
        # JAX's learnability check: mostly the affine chain, ~10% resets.
        follows = np.mean(got[1:] == (31 * got[:-1].astype(np.int64) + 7)
                          % vocab)
        assert 0.85 < follows < 0.95


@pytest.mark.parametrize("n", [1, 2, 1000])
def test_permutation_matches_twin_and_jax(n):
    got = native.permutation(99, n)
    np.testing.assert_array_equal(got, native.permutation_plain(99, n))
    np.testing.assert_array_equal(got, jnative.permutation(99, n))
    assert sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("shape,dtype", [((500, 17, 3), np.float32),
                                         ((400, 10), np.int32),
                                         ((64, 8, 8, 3), np.float32)])
def test_gather_rows_matches_twin_and_jax(shape, dtype):
    rng = np.random.default_rng(SEED)
    src = (rng.normal(size=shape) * 100).astype(dtype)
    for n_idx in (1, 63, 64, shape[0]):    # one thread below 64 rows
        idx = native.permutation(n_idx, shape[0])[:n_idx]
        got = native.gather_rows(src, idx)
        np.testing.assert_array_equal(got, native.gather_rows_plain(src,
                                                                    idx))
        np.testing.assert_array_equal(got, jnative.gather_rows(src, idx))


def test_gather_rows_copies_a_strided_source():
    src = np.arange(400, dtype=np.int32).reshape(40, 10)[:, ::2]
    idx = native.permutation(3, 40)[:16]
    np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])


@pytest.mark.parametrize("batch", [1, 32, 128])
@pytest.mark.parametrize("seq_len", [16, 1024])
def test_window_gather_matches_twin_and_jax(batch, seq_len):
    stream = np.random.default_rng(SEED).integers(0, 997, 10_000).astype(
        np.int32)
    got = native.window_gather(stream, seq_len, batch, 42)
    plain = native.window_gather_plain(stream, seq_len, batch, 42)
    jax_side = jnative.window_gather(stream, seq_len, batch, 42)
    for a, b, c in zip(got, plain, jax_side):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(got[0][:, 1:], got[1][:, :-1])


def test_window_gather_refuses_a_short_stream():
    stream = np.arange(16, dtype=np.int32)
    for fn in (native.window_gather, native.window_gather_plain):
        with pytest.raises(ValueError, match="too short"):
            fn(stream, 16, 2, 0)


def _batches(dl, epochs=2):
    return [(b["input"].copy(), b["target"].copy())
            for _ in range(epochs) for b in dl]


def _same(a, b):
    assert len(a) == len(b) > 0
    for (x, y), (jx, jy) in zip(a, b):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("sampling", ["epoch", "windows"])
@pytest.mark.parametrize("split", ["train", "validation"])
def test_synthetic_lm_loaders_yield_jax_batches(sampling, split):
    kw = dict(split=split, batch_size=4, seq_len=16, vocab_size=128,
              num_examples=32, seed=5, sampling=sampling)
    _same(_batches(loader.get_dataloader("openwebtext", **kw)),
          _batches(jloader.get_dataloader("openwebtext", **kw)))


def test_vision_loader_yields_jax_batches():
    kw = dict(batch_size=8, num_examples=64, seed=3, image_size=8)
    _same(_batches(loader.get_dataloader("cifar10", **kw)),
          _batches(jloader.get_dataloader("cifar10", **kw)))


def test_array_and_stream_loaders_yield_jax_batches():
    x = np.arange(320, dtype=np.int32).reshape(40, 8)
    _same(_batches(loader.ArrayDataLoader(x, x + 1, batch_size=8, seed=3)),
          _batches(jloader.ArrayDataLoader(x, x + 1, batch_size=8, seed=3)))
    stream = np.arange(5_000, dtype=np.int32) % 101
    kw = dict(batch_size=8, seq_len=16, steps_per_epoch=3, seed=7)
    _same(_batches(loader.TokenStreamLoader(stream, **kw)),
          _batches(jloader.TokenStreamLoader(stream, **kw)))


def test_loader_twins_stay_importable_from_the_loader():
    for name in ("splitmix_fill", "synthetic_tokens", "permutation",
                 "window_gather", "gather_rows"):
        assert getattr(loader, name) is getattr(native, name)
        assert getattr(loader, f"{name}_plain") is \
            getattr(native, f"{name}_plain")


CORPUS = ("the quick brown fox jumps over the lazy dog. héllo wörld! "
          "quick foxes and lazy dogs, 東京 x² ½ ٣٤ 42 — it's "
          "done.\n") * 30


def _text(seed, words=1500):
    rng = np.random.default_rng(seed)
    syll = ("ka", "to", "ri", "mu", "sen", "qua", "é", "ß", "東京", "x²",
            "'s", "!", "  ", "\n", "42")
    picks = (rng.integers(0, len(syll), rng.integers(1, 5))
             for _ in range(words))
    return " ".join("".join(syll[i] for i in p) for p in picks)


@pytest.fixture(scope="module")
def trained():
    text = CORPUS + _text(1)
    vocab, merges = T.train_bpe(text, 400)
    return vocab, merges, _text(2)


def test_batch_encoder_matches_jax_and_the_python_loop(trained):
    vocab, merges, probe = trained
    ids = T.BPETokenizer(vocab, merges).encode(probe)
    assert ids == T.BPETokenizer(vocab, merges).encode_plain(probe)
    assert ids == J.BPETokenizer(vocab, merges).encode(probe)
    assert T.BPETokenizer(vocab, merges).decode(ids) == probe


def test_batch_encoder_per_word_equals_the_merge_loop(trained):
    """``native.bpe_encode`` straight, against the tokenizer's
    ``_bpe_ids`` word by word (its Python twin)."""
    vocab, merges, probe = trained
    tok = T.BPETokenizer(vocab, merges)
    words = [tuple(tok.vocab[u] for u in T._word_to_units(m))
             for m in dict.fromkeys(T._PAT.findall(probe))]
    assert tok._encode_words(words) == [tok._bpe_ids(w) for w in words]
    flat = np.fromiter((u for w in words for u in w), np.int32)
    offsets = np.concatenate([[0], np.cumsum([len(w) for w in words])])
    try:
        native.bpe_load(*tok._merge_arrays)
        out, out_offsets = native.bpe_encode(flat, offsets)
        if jnative.bpe_load(*tok._merge_arrays):
            jout, joff = jnative.bpe_encode(flat, offsets)
            np.testing.assert_array_equal(out, jout)
            np.testing.assert_array_equal(out_offsets, joff)
    finally:
        # Both encoders now hold a table no tokenizer installed: the next
        # encode of either package installs its own again.
        T._NATIVE_TABLE_OWNER = None
        J._NATIVE_TABLE_OWNER = None
    got = [out[out_offsets[i]:out_offsets[i + 1]].tolist()
           for i in range(len(words))]
    assert got == [tok._bpe_ids(w) for w in words]


def test_merge_table_switch_between_two_tokenizers(trained):
    """The encoder holds one table a process: two tokenizers taking turns
    each re-install their own, and each keeps its own ids (fresh word
    caches every round, so every call reaches the encoder)."""
    vocab, merges, probe = trained
    small_vocab, small_merges = T.train_bpe(CORPUS, 300)
    expect = {
        "big": J.BPETokenizer(vocab, merges).encode(probe),
        "small": J.BPETokenizer(small_vocab, small_merges).encode(probe),
    }
    assert expect["big"] != expect["small"]
    for _ in range(2):
        for name, (v, m) in (("big", (vocab, merges)),
                             ("small", (small_vocab, small_merges))):
            tok = T.BPETokenizer(v, m)
            assert tok.encode(probe) == expect[name]
            assert T._NATIVE_TABLE_OWNER == tok._table_gen


def test_a_build_without_gxx_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(compile_cache, "_ENABLED_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path / "no_compilers_here"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.splitmix_fill(1, 4)
    assert not native.native_available()
    assert not list(tmp_path.glob("*.so"))


def test_a_failing_gxx_raises_with_its_output(tmp_path, monkeypatch):
    broken = tmp_path / "dataloader.cpp"
    broken.write_text("extern \"C\" { void tddl_splitmix_fill( }\n")
    monkeypatch.setattr(compile_cache, "_ENABLED_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="gxx_build failed") as err:
        native.permutation(1, 4)
    assert "error" in str(err.value)
    assert not list(tmp_path.glob("*.so"))
