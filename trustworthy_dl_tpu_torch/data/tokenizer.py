"""Byte-level BPE tokenizer and the ``.txt`` to ``.bin`` preparation step.

Counterpart of ``trustworthy_dl_tpu/data/tokenizer.py``, host code only
(no torch): GPT-2's reversible byte-to-unicode table, the heap-based BPE
trainer with the same tie-breaking (so the same corpus gives the same
merge list), the encoder and decoder over GPT-2's ``vocab.json`` +
``merges.txt`` format, and :func:`prepare_data`, which writes the loader's
uint16 token memmap (``data/loader.py``) beside the tokenizer files.

The pre-tokenizer is GPT-2's pattern through the optional ``regex``
module, else the same shape in the standard library's ``re``
(``PRETOKENIZER`` says which one this process runs); both packages make
the same choice.  The JAX package hands batches of words to a prebuilt C++
encoder and keeps a Python merge loop as its fallback; the port runs that
Python loop (:meth:`BPETokenizer._bpe_ids`), which gives the same ids.
"""

from __future__ import annotations

import heapq
import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

try:  # GPT-2's exact pre-tokenizer needs \p classes (regex module).
    import regex as _re

    _PAT = _re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
        r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
    )
    PRETOKENIZER = "regex"
except ImportError:  # std-re fallback: same shape with unicode classes
    import re as _re

    _PAT = _re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+|"""
        r""" ?[^\s\w]+|\s+(?!\S)|\s+""",
        _re.UNICODE,
    )
    PRETOKENIZER = "re"

#: Word-cache bound per tokenizer (entries, matched string -> ids).
_CACHE_CAP = 262_144


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode table: the 188
    printable latin-1 bytes map to themselves, the rest shift into U+0100
    and up, so every byte sequence round-trips through a string."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_BYTE_ENCODER = bytes_to_unicode()
_BYTE_DECODER = {v: k for k, v in _BYTE_ENCODER.items()}


def _word_to_units(word: str) -> Tuple[str, ...]:
    """Pre-token -> tuple of byte units in the unicode alphabet."""
    return tuple(_BYTE_ENCODER[b] for b in word.encode("utf-8"))


def train_bpe(text: str, vocab_size: int = 8192, min_pair_count: int = 2
              ) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Learn a byte-level BPE vocabulary from ``text``: start from the 256
    byte units and merge the most frequent adjacent pair (over word types
    weighted by count) until ``vocab_size`` entries, or until no pair
    occurs ``min_pair_count`` times.  Returns (token -> id, the ordered
    merge list), ids dense from 0, a merge's rank its list position.

    The pair histogram is kept incrementally with an inverted index (pair
    -> words holding it) and a lazy max-heap of (-count, pair): a popped
    entry whose count went stale is pushed again at its live count.  Ties
    between equal counts break on the pair's strings, the heap's order,
    exactly as in the JAX package."""
    units = sorted(set(_BYTE_ENCODER.values()))
    if vocab_size < len(units):
        raise ValueError(
            f"vocab_size {vocab_size} < byte alphabet {len(units)}")
    word_counts: Counter = Counter()
    for m in _PAT.findall(text):
        word_counts[_word_to_units(m)] += 1
    words: Dict[Tuple[str, ...], int] = dict(word_counts)
    pair_counts: Counter = Counter()
    pair_words: Dict[Tuple[str, str], set] = {}
    for word, cnt in words.items():
        for pair in zip(word, word[1:]):
            pair_counts[pair] += cnt
            pair_words.setdefault(pair, set()).add(word)

    heap: List[Tuple[int, Tuple[str, str]]] = [
        (-c, p) for p, c in pair_counts.items()]
    heapq.heapify(heap)

    def _bump(pair: Tuple[str, str]) -> None:
        c = pair_counts.get(pair)
        if c:
            heapq.heappush(heap, (-c, pair))

    def _remove_word(word: Tuple[str, ...], cnt: int) -> None:
        for pair in zip(word, word[1:]):
            pair_counts[pair] -= cnt
            if pair_counts[pair] <= 0:
                del pair_counts[pair]
            ws = pair_words.get(pair)
            if ws is not None:
                ws.discard(word)
                if not ws:
                    del pair_words[pair]

    def _add_word(word: Tuple[str, ...], cnt: int) -> None:
        for pair in zip(word, word[1:]):
            pair_counts[pair] += cnt
            pair_words.setdefault(pair, set()).add(word)
            _bump(pair)

    merges: List[Tuple[str, str]] = []
    vocab: Dict[str, int] = {u: i for i, u in enumerate(units)}
    while len(vocab) < vocab_size and heap:
        neg, (a, b) = heapq.heappop(heap)
        cnt = pair_counts.get((a, b), 0)
        if -neg != cnt:     # stale entry: re-queue at the live count
            _bump((a, b))
            continue
        if cnt < min_pair_count:
            break
        merged = a + b
        merges.append((a, b))
        vocab[merged] = len(vocab)
        for word in list(pair_words.get((a, b), ())):
            c = words.pop(word)
            _remove_word(word, c)
            out = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            t = tuple(out)
            words[t] = words.get(t, 0) + c
            _add_word(t, c)
    return vocab, merges


class BPETokenizer:
    """GPT-2-style byte-level BPE encoder and decoder.  ``vocab`` maps
    token strings (in the byte-unicode alphabet) to ids, ``merges`` is the
    ordered merge list; OpenAI's published GPT-2 files load as they
    are."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]]):
        self.vocab = dict(vocab)
        self.decoder = {i: t for t, i in self.vocab.items()}
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        # The merge table in id space: (left id, right id) -> (rank,
        # product id), the first rank of a pair winning.  A merge whose
        # product is not in the vocabulary could never emit a token and
        # is left out.
        self._id_ranks: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for (a, b), rank in sorted(self.ranks.items(), key=lambda kv: kv[1]):
            ia, ib, ip = (self.vocab.get(a), self.vocab.get(b),
                          self.vocab.get(a + b))
            if ia is None or ib is None or ip is None:
                continue
            if (ia, ib) not in self._id_ranks:
                self._id_ranks[(ia, ib)] = (rank, ip)
        self._cache: Dict[str, List[int]] = {}   # matched word -> ids

    def _bpe_ids(self, word: Tuple[int, ...]) -> List[int]:
        """Merge a word's unit ids: the lowest-ranked adjacent pair first
        (the leftmost on a tie), until no pair of the table is left."""
        parts = list(word)
        while len(parts) > 1:
            best, best_i = None, None
            for i, pair in enumerate(zip(parts, parts[1:])):
                hit = self._id_ranks.get(pair)
                if hit is not None and (best is None or hit[0] < best[0]):
                    best, best_i = hit, i
            if best_i is None:
                break
            parts[best_i:best_i + 2] = [best[1]]
        return parts

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str) -> List[int]:
        words = _PAT.findall(text)
        cache = self._cache
        # Misses keyed on the matched string, in first-seen order: repeated
        # words (nearly all of them in natural text) skip the merge loop.
        fresh = [m for m in dict.fromkeys(words) if m not in cache]
        local: Dict[str, List[int]] = {}
        if fresh:
            local = {m: self._bpe_ids(tuple(self.vocab[u]
                                            for u in _word_to_units(m)))
                     for m in fresh}
            # Bounded cache: inserts stop at the cap (nothing is evicted:
            # entries of this call stay reachable through ``local``).
            budget = _CACHE_CAP - len(cache)
            if budget > 0:
                for m in fresh[:budget]:
                    cache[m] = local[m]
        out: List[int] = []
        for m in words:
            ids = cache.get(m)
            out.extend(local[m] if ids is None else ids)
        return out

    def decode(self, ids: Iterable[int]) -> str:
        """Ids -> text.  An id outside the vocabulary (a model whose
        embedding is wider than this tokenizer samples one) decodes to
        U+FFFD instead of raising."""
        data = bytearray()
        for i in ids:
            token = self.decoder.get(int(i))
            if token is None:
                data += b"\xef\xbf\xbd"     # U+FFFD
            else:
                data += bytes(_BYTE_DECODER[c] for c in token)
        return data.decode("utf-8", errors="replace")

    def save(self, directory: str) -> None:
        """GPT-2's file format: ``vocab.json`` and ``merges.txt``."""
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "vocab.json"), "w",
                  encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        with open(os.path.join(directory, "merges.txt"), "w",
                  encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in sorted(self.ranks.items(),
                                    key=lambda kv: kv[1]):
                f.write(f"{a} {b}\n")

    @classmethod
    def load(cls, directory: str) -> "BPETokenizer":
        with open(os.path.join(directory, "vocab.json"),
                  encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(directory, "merges.txt"),
                  encoding="utf-8") as f:
            for n, line in enumerate(f):
                line = line.rstrip("\n")
                # Only the first line's "#version" header is skipped: a
                # merge whose left token starts with "#" ("# #" in code or
                # Markdown) is a merge.  The JAX package skips every line
                # starting with "#", so its reloaded tokenizer loses those
                # merges and encodes such text otherwise than it trained.
                if not line or (n == 0 and line.startswith("#version")):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def train(cls, text: str, vocab_size: int = 8192) -> "BPETokenizer":
        vocab, merges = train_bpe(text, vocab_size)
        return cls(vocab, merges)


def prepare_data(txt_path: str, out_path: Optional[str] = None,
                 vocab_size: int = 8192,
                 tokenizer_dir: Optional[str] = None,
                 val_fraction: float = 0.0) -> Dict[str, object]:
    """A ``.txt`` corpus -> a uint16 token memmap (``out_path``, default
    beside the input) and the tokenizer files (``tokenizer_dir``, default
    ``tokenizer/`` beside the output).  A ``tokenizer_dir`` that already
    holds ``vocab.json`` is used as it is; otherwise a BPE vocabulary is
    trained on the corpus and saved there.  ``val_fraction`` > 0 also
    writes the corpus's tail as ``<out>_val.bin``."""
    with open(txt_path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    if out_path is None:
        out_path = os.path.splitext(txt_path)[0] + ".bin"
    if tokenizer_dir is None:
        tokenizer_dir = os.path.join(os.path.dirname(os.path.abspath(
            out_path)), "tokenizer")
    if os.path.exists(os.path.join(tokenizer_dir, "vocab.json")):
        tok = BPETokenizer.load(tokenizer_dir)
    else:
        tok = BPETokenizer.train(text, vocab_size)
        tok.save(tokenizer_dir)
    ids = tok.encode(text)
    if tok.vocab_size > np.iinfo(np.uint16).max + 1:
        raise ValueError(f"vocab {tok.vocab_size} exceeds uint16 memmap "
                         "range")
    arr = np.asarray(ids, np.uint16)
    if val_fraction > 0:
        cut = int(len(arr) * (1.0 - val_fraction))
        train_arr, val_arr = arr[:cut], arr[cut:]
        val_path = os.path.splitext(out_path)[0] + "_val.bin"
        val_arr.tofile(val_path)
    else:
        train_arr, val_path = arr, None
    train_arr.tofile(out_path)
    return {
        "out_path": out_path,
        "val_path": val_path,
        "tokenizer_dir": tokenizer_dir,
        # Tokens in out_path (the validation split is cut from it).
        "num_tokens": int(len(train_arr)),
        "val_tokens": int(len(arr) - len(train_arr)),
        "vocab_size": tok.vocab_size,
    }


__all__ = ["BPETokenizer", "PRETOKENIZER", "bytes_to_unicode",
           "prepare_data", "train_bpe"]
