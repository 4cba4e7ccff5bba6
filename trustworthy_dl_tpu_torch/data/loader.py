"""Training data: the learnable synthetic sources and the loaders.

Counterpart of ``trustworthy_dl_tpu/data/loader.py`` and of the numpy half
of ``trustworthy_dl_tpu/native`` (splitmix64 streams, the affine
next-token chain, Fisher-Yates permutations, window gathers), bit for
bit: the same seed gives the same batches as the JAX package.  Real
corpora load from ``data_dir`` or ``$TDDL_DATA_DIR``: ``<name>.bin`` (a
flat uint16 token memmap) first, else ``<name>.txt`` read as raw UTF-8
bytes (byte-level ids, ``vocab_size`` >= 256), each split 95/5 into train
and validation; otherwise the synthetic source stands in.  The vision
datasets (``cifar10``, ``cifar-10``, ``cifar100``, ``imagenet``,
``synthetic_vision``) read ``cifar10/cifar10.npz`` under the same
directory where it is present (CIFAR-10 only), else the class-conditional
synthetic images; nothing is fetched.  :class:`PrefetchLoader` assembles
the next batches on a background thread.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)

#: The dataset names of the two branches of :func:`get_dataloader`.
LM_DATASETS = ("openwebtext", "wikitext", "lm", "synthetic_lm")
VISION_DATASETS = ("cifar10", "cifar-10", "cifar100", "imagenet",
                   "synthetic_vision")


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorised splitmix64 finaliser on uint64 states (wrapping)."""
    with np.errstate(over="ignore"):
        z = x + _GOLDEN
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def splitmix_fill(seed: int, n: int) -> np.ndarray:
    """u64 [n]: splitmix64(seed + i * GOLDEN)."""
    with np.errstate(over="ignore"):
        states = np.uint64(seed) + np.arange(n, dtype=np.uint64) * _GOLDEN
    return _splitmix64(states)


def _splitmix_scalar(x: int) -> int:
    return int(_splitmix64(np.asarray([x], np.uint64))[0])


def synthetic_tokens(n: int, vocab: int, seed: int) -> np.ndarray:
    """i32 [n] affine next-token chain t -> (31 t + 7) mod V with 10 %
    uniform resets: low-entropy enough that a model visibly learns."""
    a, b = 31, 7
    noise_u = splitmix_fill(_splitmix_scalar(seed ^ 0xA5A5A5A5A5A5A5A5), n)
    reset = (noise_u >> np.uint64(48)) < np.uint64(6554)
    resets_tok = (splitmix_fill(_splitmix_scalar(seed ^ 0x5A5A5A5A5A5A5A5A),
                                n) % np.uint64(vocab)).astype(np.int64)
    out = np.empty(n, np.int32)
    t = _splitmix_scalar(seed) % vocab
    out[0] = t
    reset_l, tok_l = reset.tolist(), resets_tok.tolist()
    for i in range(1, n):
        t = tok_l[i] if reset_l[i] else (a * t + b) % vocab
        out[i] = t
    return out


def synthetic_images(num: int, num_classes: int, shape, seed: int
                     ) -> "tuple[np.ndarray, np.ndarray]":
    """(f32 [num, H, W, C] images, i32 [num] labels): a fixed normal
    prototype per class plus normal(0.7) noise, linearly separable, from
    the JAX package's numpy stream."""
    rng = np.random.default_rng(seed)
    h, w, c = shape
    prototypes = rng.normal(0, 1, size=(num_classes, h, w, c)).astype(
        np.float32)
    labels = rng.integers(0, num_classes, num).astype(np.int32)
    images = prototypes[labels] + rng.normal(
        0, 0.7, size=(num, h, w, c)).astype(np.float32)
    return images, labels


def permutation(seed: int, n: int) -> np.ndarray:
    """i64 [n] Fisher-Yates permutation from the splitmix stream."""
    out = np.arange(n, dtype=np.int64)
    if n:
        us = splitmix_fill(seed, n)
        for i in range(n - 1, 0, -1):
            j = int(us[i] % np.uint64(i + 1))
            out[i], out[j] = out[j], out[i]
    return out


def window_gather(stream: np.ndarray, seq_len: int, batch: int, seed: int
                  ) -> "tuple[np.ndarray, np.ndarray]":
    """(inputs, targets) i32 [batch, seq_len]: seq_len + 1 windows of a
    token stream at splitmix-derived offsets."""
    stream = np.ascontiguousarray(stream, np.int32)
    span = len(stream) - seq_len
    if span <= 0:
        raise ValueError(f"stream of {len(stream)} tokens too short for "
                         f"seq_len={seq_len}")
    offs = (splitmix_fill(seed, batch) % np.uint64(span)).astype(np.int64)
    windows = stream[offs[:, None] + np.arange(seq_len + 1)[None, :]]
    return windows[:, :-1].copy(), windows[:, 1:].copy()


class ArrayDataLoader:
    """Deterministic batched iterator over {'input', 'target'} arrays,
    reshuffled every epoch (drop_last)."""

    def __init__(self, inputs: np.ndarray, targets: np.ndarray,
                 batch_size: int, shuffle: bool = True, seed: int = 0):
        if len(inputs) != len(targets):
            raise ValueError("inputs and targets differ in length")
        self.inputs = np.ascontiguousarray(inputs)
        self.targets = np.ascontiguousarray(targets)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.inputs) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.shuffle:
            idx = permutation(self.seed + self._epoch, len(self.inputs))
        else:
            idx = np.arange(len(self.inputs), dtype=np.int64)
        self._epoch += 1
        # ``batch_size`` is read again for every batch, so a re-size after
        # an elastic topology change (``DistributedTrainer._resize_loader``)
        # takes effect on the next batch, as in the JAX package.
        start = 0
        while start < len(idx):
            bs = self.batch_size
            sel = idx[start:start + bs]
            start += bs
            if len(sel) < bs:
                break
            yield {"input": self.inputs[sel], "target": self.targets[sel]}


class TokenStreamLoader:
    """Random-window batches over a token stream: batch k of epoch e
    depends only on (seed, e, k); ``freeze_epoch`` pins every pass to
    epoch 0 (validation)."""

    def __init__(self, stream: np.ndarray, batch_size: int, seq_len: int,
                 steps_per_epoch: int, seed: int = 0,
                 freeze_epoch: bool = False):
        self.stream = np.ascontiguousarray(stream, np.int32)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.steps_per_epoch = steps_per_epoch
        self.seed = seed
        self.freeze_epoch = freeze_epoch
        self._epoch = 0

    def __len__(self) -> int:
        return self.steps_per_epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = 0 if self.freeze_epoch else self._epoch
        if not self.freeze_epoch:
            self._epoch += 1
        mask = (1 << 64) - 1
        k_epoch = int(splitmix_fill(
            ((self.seed & 0xFFFFFFFF) << 32 | (epoch & 0xFFFFFFFF)), 1)[0])
        for step in range(self.steps_per_epoch):
            seed = int(splitmix_fill((k_epoch + step) & mask, 1)[0])
            inputs, targets = window_gather(self.stream, self.seq_len,
                                            self.batch_size, seed)
            yield {"input": inputs, "target": targets}


class PrefetchLoader:
    """Background-thread prefetch over any batch iterable: batch k + 1 is
    assembled on the host while step k runs on the card.  The thread
    yields the wrapped loader's numpy batches and holds no torch state; at
    most ``depth`` batches wait in its bounded queue."""

    def __init__(self, loader: Any, depth: int = 2):
        self.loader = loader
        self.depth = max(1, depth)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        sentinel = object()
        errbox: list = []

        def put(item: Any) -> bool:
            """A bounded put that notices the consumer leaving: a plain
            ``q.put`` would block forever on a full queue nobody reads."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
            except BaseException as exc:  # re-raised in the consumer
                errbox.append(exc)
            finally:
                put(sentinel)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # Normal exhaustion and early exit alike: release the producer
            # and reap the thread.
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            worker.join(timeout=5)
        if errbox:
            raise errbox[0]


def get_dataloader(dataset_name: str, split: str = "train",
                   batch_size: int = 32, seq_len: int = 128,
                   vocab_size: int = 50257,
                   num_examples: Optional[int] = None, seed: int = 0,
                   data_dir: Optional[str] = None,
                   sampling: str = "epoch",
                   image_size: Optional[int] = None):
    """LM loaders: "epoch" partitions the stream into fixed shuffled
    windows, "windows" draws fresh random windows every batch.  Vision
    loaders shuffle images every epoch; ``image_size`` is the synthetic
    images' side (the real file keeps its own).  The data come from
    ``data_dir``, else ``$TDDL_DATA_DIR`` (module docstring)."""
    name = dataset_name.lower()
    if sampling not in ("epoch", "windows"):
        raise ValueError(f"sampling must be 'epoch' or 'windows', got "
                         f"{sampling!r}")
    if name in VISION_DATASETS:
        return _vision_loader(name, split, batch_size, num_examples, seed,
                              data_dir, sampling, image_size)
    if name not in LM_DATASETS:
        raise ValueError(f"unknown dataset {dataset_name!r}")
    data_dir = data_dir or os.environ.get("TDDL_DATA_DIR", "")
    split_seed = seed + (0 if split == "train" else 10_000)
    n = num_examples or (2048 if split == "train" else 256)
    bin_path = os.path.join(data_dir, f"{name}.bin") if data_dir else ""
    txt_path = os.path.join(data_dir, f"{name}.txt") if data_dir else ""
    if bin_path and os.path.exists(bin_path):
        tokens = np.memmap(bin_path, dtype=np.uint16, mode="r")
        cut = int(len(tokens) * 0.95)
        tokens = np.asarray(tokens[:cut] if split == "train"
                            else tokens[cut:], np.int32)
    elif txt_path and os.path.exists(txt_path):
        # Byte-level tier: any plain-text corpus trains without a
        # tokenizer, its ids the raw UTF-8 bytes.
        if vocab_size < 256:
            raise ValueError(
                f"byte-level corpus {txt_path} needs vocab_size >= 256 "
                f"(got {vocab_size}): byte ids would exceed the "
                "embedding table")
        raw = np.memmap(txt_path, dtype=np.uint8, mode="r")
        cut = int(len(raw) * 0.95)
        tokens = np.asarray(raw[:cut] if split == "train" else raw[cut:],
                            np.int32)
    else:
        tokens = synthetic_tokens(n * (seq_len + 1) + 1,
                                  min(vocab_size, 512), split_seed)
    if sampling == "windows":
        return TokenStreamLoader(tokens, batch_size, seq_len,
                                 steps_per_epoch=max(n // max(batch_size, 1),
                                                     1),
                                 seed=split_seed,
                                 freeze_epoch=(split != "train"))
    usable = min((len(tokens) - 1) // seq_len, n)
    window = tokens[: usable * seq_len + 1]
    inputs = np.stack([window[i * seq_len:(i + 1) * seq_len]
                       for i in range(usable)])
    targets = np.stack([window[i * seq_len + 1:(i + 1) * seq_len + 1]
                        for i in range(usable)])
    return ArrayDataLoader(inputs, targets, batch_size, shuffle=True,
                           seed=split_seed)


def _vision_loader(name: str, split: str, batch_size: int,
                   num_examples: Optional[int], seed: int,
                   data_dir: Optional[str], sampling: str,
                   image_size: Optional[int]) -> ArrayDataLoader:
    """The vision branch of :func:`get_dataloader`: CIFAR-10 from
    ``<data_dir>/cifar10/cifar10.npz`` (``x_train``/``y_train``,
    ``x_test``/``y_test``, scaled to [-1, 1]) where present, else
    synthetic images (100 classes for CIFAR-100, 1000 at side 224 for
    ImageNet, 10 at side 32 otherwise)."""
    if sampling == "windows":
        raise ValueError("sampling='windows' is a token-stream sampler; "
                         "vision datasets use epoch sampling")
    data_dir = data_dir or os.environ.get("TDDL_DATA_DIR", "")
    split_seed = seed + (0 if split == "train" else 10_000)
    num_classes = 100 if "100" in name else (
        1000 if "imagenet" in name else 10)
    side = image_size or (224 if "imagenet" in name else 32)
    n = num_examples or (2048 if split == "train" else 512)
    npz_path = os.path.join(data_dir, "cifar10", "cifar10.npz") \
        if data_dir else ""
    if name.startswith("cifar10") and npz_path and os.path.exists(npz_path):
        blob = np.load(npz_path)
        key = "train" if split == "train" else "test"
        images = blob[f"x_{key}"].astype(np.float32) / 127.5 - 1.0
        labels = blob[f"y_{key}"].reshape(-1).astype(np.int32)
    else:
        images, labels = synthetic_images(n, num_classes, (side, side, 3),
                                          split_seed)
    return ArrayDataLoader(images, labels, batch_size, shuffle=True,
                           seed=split_seed)


__all__ = ["ArrayDataLoader", "PrefetchLoader", "TokenStreamLoader",
           "LM_DATASETS", "VISION_DATASETS", "get_dataloader", "permutation",
           "splitmix_fill", "synthetic_images", "synthetic_tokens",
           "window_gather"]
