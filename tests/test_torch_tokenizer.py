"""The port's byte-level BPE tokenizer (``trustworthy_dl_tpu_torch/data/
tokenizer.py``) against the JAX package's, on the CPU; mirrors
``tests/test_tokenizer.py``.

Everything here is exact: the byte table, ``train_bpe``'s merge list and
vocabulary, ``encode``'s ids (the port's Python merge loop against JAX's
public ``encode``, which runs its native encoder where it is built),
``decode`` (unknown ids to U+FFFD), the saved files byte for byte, and
``prepare_data``'s ``.bin`` / ``_val.bin`` bytes and returned dict.  One
deliberate difference: the port's ``load`` keeps the merges whose left
token starts with "#", which JAX's drops with its header.  The
corpora are built from a seed with numpy and hold non-ASCII text: letters
with diacritics, CJK, combining marks, superscripts and vulgar fractions
(``\\p{N}`` but not ``\\d``) and Arabic-Indic digits.  Both pre-tokenizer
branches are held: the ``regex`` one in this process, the standard
library's ``re`` fallback in a subprocess where ``regex`` cannot be
imported, for both packages.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from trustworthy_dl_tpu.data import tokenizer as J
from trustworthy_dl_tpu_torch.data import tokenizer as T

pytestmark = pytest.mark.torchport

REPO = Path(__file__).resolve().parents[1]
JAX_CORPUS = (
    "the quick brown fox jumps over the lazy dog. "
    "the quick brown fox runs. lazy dogs sleep all day. "
    "quick foxes and lazy dogs — unicode too: héllo wörld! "
) * 40
SYLLABLES = ("ka", "to", "ri", "mu", "sen", "da", "lo", "vi", "ne", "qua",
             "é", "ö", "ß", "Ω", "東京", "ña", "x²", "½", "é",
             "٣٤", "42", "7", "'s", "'ll", "!", "—", ",", "...", "  ", "\n",
             "\t")


def seeded_text(seed: int, words: int = 3000) -> str:
    """Words of 1-4 syllables drawn from a numpy stream, Zipf-skewed so
    that pairs repeat, joined by single spaces (with the whitespace
    syllables giving runs)."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, len(SYLLABLES) + 1)
    weights /= weights.sum()
    out = []
    for _ in range(words):
        n = int(rng.integers(1, 5))
        out.append("".join(SYLLABLES[i] for i in
                           rng.choice(len(SYLLABLES), n, p=weights)))
    return " ".join(out)


CORPORA = {"jax_test": JAX_CORPUS, "seeded": seeded_text(0)}
PROBES = ("the quick brown fox", "héllo wörld — ünïcode",
          "unseen words zyzzyva qwfp!",
          "  leading and   multiple spaces\n\nnewlines\ttabs",
          "x² + ½ = é 東京 ٣٤ it's we'll 123,456", seeded_text(1, 200))


def test_byte_table_equals_jax():
    table = T.bytes_to_unicode()
    assert table == J.bytes_to_unicode()
    assert len(table) == 256 and len(set(table.values())) == 256


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("vocab_size", [300, 600])
def test_train_bpe_equals_jax(corpus, vocab_size):
    text = CORPORA[corpus]
    vocab, merges = T.train_bpe(text, vocab_size)
    jvocab, jmerges = J.train_bpe(text, vocab_size)
    assert merges == jmerges
    assert vocab == jvocab
    assert sorted(vocab.values()) == list(range(len(vocab)))
    assert len(merges) == len(vocab) - 256
    with pytest.raises(ValueError):
        T.train_bpe(text, 255)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_encode_ids_equal_jax(corpus):
    tok = T.BPETokenizer.train(CORPORA[corpus], 600)
    jtok = J.BPETokenizer.train(CORPORA[corpus], 600)
    assert T.PRETOKENIZER == "regex"
    for text in PROBES + (CORPORA[corpus],):
        assert tok.encode(text) == jtok.encode(text), text[:40]


_FALLBACK = r"""
import json, sys
sys.modules["regex"] = None          # the import fails: the re fallback
sys.path.insert(0, sys.argv[1])
from trustworthy_dl_tpu.data import tokenizer as J
from trustworthy_dl_tpu_torch.data import tokenizer as T
assert T.PRETOKENIZER == "re", T.PRETOKENIZER
args = json.loads(sys.stdin.read())
out = []
for text in args["corpora"]:
    tv, tm = T.train_bpe(text, 600)
    jv, jm = J.train_bpe(text, 600)
    tok, jtok = T.BPETokenizer(tv, tm), J.BPETokenizer(jv, jm)
    out.append({"merges_equal": tm == jm, "vocab_equal": tv == jv,
                "ids": [tok.encode(p) for p in args["probes"]],
                "jax_ids": [jtok.encode(p) for p in args["probes"]],
                "round_trip": all(tok.decode(tok.encode(p)) == p
                                  for p in args["probes"])})
print(json.dumps(out))
"""


def test_re_fallback_equals_jax_fallback():
    """Both packages without ``regex``: the same merges and ids, and the
    fallback's words differ from the ``regex`` branch's on this text, so
    that both branches are really held."""
    corpora = [CORPORA[k] for k in sorted(CORPORA)]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _FALLBACK, str(REPO)],
        input=json.dumps({"corpora": corpora, "probes": list(PROBES)}),
        capture_output=True, text=True, timeout=600, env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    results = json.loads(proc.stdout.strip().splitlines()[-1])
    for corpus, res in zip(sorted(CORPORA), results):
        assert res["merges_equal"] and res["vocab_equal"], corpus
        assert res["ids"] == res["jax_ids"], corpus
        assert res["round_trip"], corpus
    seeded = results[sorted(CORPORA).index("seeded")]
    tok = T.BPETokenizer.train(CORPORA["seeded"], 600)
    regex_ids = [tok.encode(p) for p in PROBES]
    assert regex_ids != seeded["ids"]


@pytest.mark.parametrize("text", PROBES)
def test_round_trip(text):
    tok = T.BPETokenizer.train(CORPORA["seeded"], 600)
    ids = tok.encode(text)
    assert all(0 <= i < tok.vocab_size for i in ids)
    assert tok.decode(ids) == text
    assert tok.decode(np.asarray(ids, np.uint16)) == text


def test_decode_maps_unknown_ids_like_jax():
    """Ids past the vocabulary (a model wider than the tokenizer samples
    them) decode to U+FFFD, as in JAX, never raise."""
    tok = T.BPETokenizer.train(JAX_CORPUS, 300)
    jtok = J.BPETokenizer.train(JAX_CORPUS, 300)
    ids = tok.encode("the lazy dog") + [300, 8191, 50256] + tok.encode("!")
    assert tok.decode(ids) == jtok.decode(ids)
    assert tok.decode(ids).count("�") == 3
    # Merges compress: a common phrase takes fewer tokens than bytes.
    assert len(tok.encode("the quick brown fox")) < len("the quick brown fox")


def test_save_files_equal_jax_byte_for_byte(tmp_path):
    tok = T.BPETokenizer.train(CORPORA["seeded"], 600)
    jtok = J.BPETokenizer.train(CORPORA["seeded"], 600)
    tok.save(str(tmp_path / "port"))
    jtok.save(str(tmp_path / "jax"))
    for name in ("vocab.json", "merges.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    lines = (tmp_path / "port" / "merges.txt").read_text(
        encoding="utf-8").splitlines()
    assert lines[0].startswith("#version") and len(lines) == 1 + len(
        tok.ranks)
    reloaded = T.BPETokenizer.load(str(tmp_path / "jax"))
    assert reloaded.vocab == tok.vocab and reloaded.ranks == tok.ranks
    assert reloaded.encode(PROBES[4]) == tok.encode(PROBES[4])


def test_load_keeps_merges_that_start_with_a_hash(tmp_path):
    """A deliberate difference: the port's ``load`` skips only the first
    line's "#version" header, so merges such as "# #" (Markdown, code)
    survive a save and a load; JAX's skips every line starting with "#"
    and loses them, so its reloaded tokenizer encodes such text otherwise
    than the one it trained."""
    text = "## Heading\n# note ## more\n### x #1\n" * 60 + CORPORA["seeded"]
    tok = T.BPETokenizer.train(text, 400)
    hashed = [m for m in tok.ranks if m[0].startswith("#")]
    assert hashed
    tok.save(str(tmp_path))
    port, jax_ = (T.BPETokenizer.load(str(tmp_path)),
                  J.BPETokenizer.load(str(tmp_path)))
    assert port.ranks == tok.ranks
    assert port.encode(text) == tok.encode(text) == \
        J.BPETokenizer.train(text, 400).encode(text)
    assert len(jax_.ranks) == len(tok.ranks) - len(hashed)
    assert jax_.encode(text) != tok.encode(text)


def _relative(info, root):
    return {k: (os.path.relpath(v, root) if isinstance(v, str) else v)
            for k, v in info.items()}


@pytest.mark.parametrize("val_fraction", [0.0, 0.1])
def test_prepare_data_equals_jax(tmp_path, val_fraction):
    """The same corpus through both packages' ``prepare_data``: the same
    dict, the same ``.bin`` and ``_val.bin`` bytes and tokenizer files;
    then a second corpus through the saved tokenizer (loaded, not
    trained)."""
    infos = {}
    for side, fn in (("port", T.prepare_data), ("jax", J.prepare_data)):
        root = tmp_path / side
        root.mkdir()
        (root / "corpus.txt").write_text(CORPORA["seeded"], encoding="utf-8")
        (root / "more.txt").write_text(PROBES[4] * 30, encoding="utf-8")
        first = fn(str(root / "corpus.txt"), vocab_size=600,
                   val_fraction=val_fraction)
        second = fn(str(root / "more.txt"),
                    tokenizer_dir=first["tokenizer_dir"])
        infos[side] = (_relative(first, root), _relative(second, root))
    assert infos["port"] == infos["jax"]
    first = infos["port"][0]
    assert (first["val_path"] is None) == (val_fraction == 0)
    for rel in ("corpus.bin", "more.bin", "tokenizer/vocab.json",
                "tokenizer/merges.txt") + (
                    ("corpus_val.bin",) if val_fraction else ()):
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel
    train = np.fromfile(tmp_path / "port" / "corpus.bin", np.uint16)
    assert len(train) == first["num_tokens"]
    assert train.max() < first["vocab_size"]
    tok = T.BPETokenizer.load(str(tmp_path / "port" / "tokenizer"))
    ids = tok.encode(CORPORA["seeded"])
    np.testing.assert_array_equal(
        train, np.asarray(ids, np.uint16)[:first["num_tokens"]])


def test_cache_cap_keeps_encode_whole(monkeypatch):
    """With the word cache full, encode still resolves every word (the
    per-call overlay) and never inserts past the cap; the ids stay
    JAX's."""
    monkeypatch.setattr(T, "_CACHE_CAP", 2)
    tok = T.BPETokenizer.train(JAX_CORPUS, 300)
    jtok = J.BPETokenizer.train(JAX_CORPUS, 300)
    text = "the quick brown fox jumps over the lazy dog"
    ids1 = tok.encode(text)
    assert len(tok._cache) <= 2
    ids2 = tok.encode(text)
    assert ids1 == ids2 == jtok.encode(text)
    assert tok.decode(ids1) == text


def test_prepared_corpus_feeds_both_loaders(tmp_path):
    """The prepared ``.bin`` through each package's loader: the same
    batches; and a validation holdout of fewer windows than one batch
    gives no batch in either (JAX's drop-last, kept)."""
    from trustworthy_dl_tpu.data import get_dataloader as jget
    from trustworthy_dl_tpu_torch.data import get_dataloader

    (tmp_path / "openwebtext.txt").write_text(CORPORA["seeded"] * 2,
                                              encoding="utf-8")
    info = T.prepare_data(str(tmp_path / "openwebtext.txt"), vocab_size=600)
    kw = dict(batch_size=8, seq_len=32, vocab_size=640, num_examples=64,
              data_dir=str(tmp_path))
    port = list(get_dataloader("openwebtext", split="train", **kw))
    jax_ = list(jget("openwebtext", split="train", **kw))
    assert len(port) == len(jax_) > 0
    for a, b in zip(port, jax_):
        np.testing.assert_array_equal(a["input"], np.asarray(b["input"]))
        np.testing.assert_array_equal(a["target"], np.asarray(b["target"]))
    assert max(int(b["input"].max()) for b in port) < info["vocab_size"]
    holdout = info["num_tokens"] - int(info["num_tokens"] * 0.95)
    big = dict(kw, batch_size=holdout // 32 + 1)
    assert list(get_dataloader("openwebtext", split="validation",
                               **big)) == []
    assert list(jget("openwebtext", split="validation", **big)) == []
