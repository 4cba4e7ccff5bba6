"""Checkpoint save and restore of the whole ``TrainState``, verified.

Counterpart of ``trustworthy_dl_tpu/engine/checkpoint.py`` in a format of
the port's own (the JAX package writes orbax; neither reads the other's).
The behaviour is the JAX package's, point for point:

* ``checkpoint_step_{N}/`` holds one ``torch.save`` file per top-level
  field of the state (``params.pt``, ``opt_state.pt``, ``trust.pt``, ...),
  each a flat dict of CPU tensors keyed by their path in the state
  ("params/blocks/attn/qkv/w").  Python scalars (``step``, ``epoch``)
  live in the payload's ``meta.json`` beside the list of every leaf's
  kind, shape and dtype; a ``torch.Generator`` (``rng``) is saved as its
  ``get_state()`` and restored into a fresh generator with ``set_state``.
* The COMMIT marker is ``manifest_{N}.json`` (per-file size and CRC32),
  written atomically and last; ``inflight_{N}`` marks a save before it.
  ``check_integrity`` tells legacy, uncommitted, unreadable, size and
  checksum failures apart.
* ``save`` skips a verified existing step, clears uncommitted or corrupt
  leftovers, and overwrites (``force``) through a staging directory
  swapped in only at commit.  Every save first copies the state to host
  memory (an explicit device-to-host copy: later steps replace the live
  state, and on the CPU a tensor's ``.cpu()`` would alias it);
  ``block=False`` then writes on one background thread, joined and
  committed at the next ``save``, ``restore``, ``wait``, ``latest_step``
  or ``verified_steps``.
* ``restore(template, step=None)`` walks newest-first past failed and
  unloadable steps; an explicit step that fails its check raises.  Files
  load with ``torch.load(weights_only=True, map_location="cpu")`` and move
  onto the template's devices and dtypes.  A structure difference between
  checkpoint and template (a state field added or removed) restores by
  name; a failure on a structure-identical checkpoint stays loud, and so
  does a leaf of another shape (topology drift).
* The topology sidecar ``topology_{N}.json``: ``save_metadata`` /
  ``load_metadata``.

``timings`` keeps the last operations' bytes and seconds (the host copy,
the write and the CRC of a save apart; a restore's read and its copy onto
the device; each integrity check), for the card's measurements.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from trustworthy_dl_tpu_torch.obs.events import EventType
from trustworthy_dl_tpu_torch.utils.io import atomic_write_json

logger = logging.getLogger(__name__)

FORMAT = "tddl-torch-checkpoint-v1"
META_FILE = "meta.json"
_SCALARS = (bool, int, float)


def _payload_steps(directory: str) -> List[int]:
    """Steps with a payload directory present (committed or not); staging
    directories fail the int parse and are ignored."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("checkpoint_step_"):
            try:
                steps.append(int(name.rsplit("_", 1)[1]))
            except ValueError:
                continue
    return steps


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(8 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def _is_leaf(node: Any) -> bool:
    return isinstance(node, (torch.Tensor, torch.Generator) + _SCALARS) \
        or node is None


def _leaves(node: Any, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a state: NamedTuples by field, dicts by key,
    sequences by stringified index."""
    if _is_leaf(node):
        yield prefix, node
        return
    fields = getattr(node, "_fields", None)
    if fields is not None:
        for f in fields:
            yield from _leaves(getattr(node, f), prefix + (f,))
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, prefix + (str(i),))
    else:
        raise TypeError(f"checkpoint: unsupported node {type(node)!r} at "
                        f"{'/'.join(prefix)}")


def leaf_shapes(tree: Any) -> Dict[str, Tuple[int, ...]]:
    """The shape of every tensor leaf of ``tree``, keyed by its "a/b/c"
    path, as :meth:`CheckpointManager.saved_shapes` keys a saved field."""
    return {"/".join(p): tuple(leaf.shape) for p, leaf in _leaves(tree)
            if isinstance(leaf, torch.Tensor)}


def _template_paths(node: Any) -> set:
    """Key paths of a live state (None leaves carry nothing)."""
    return {p for p, leaf in _leaves(node) if leaf is not None}


def _saved_paths(tree: Dict[str, Any]) -> set:
    """Key paths of a saved checkpoint ("a/b/c" keys: its leaf table or
    its loaded leaves), in ``_template_paths``' key space."""
    return {tuple(key.split("/")) for key in tree}


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a/b": v} -> {"a": {"b": v}}."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        node = out
        *head, last = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = value
    return out


def _adopt(template: Any, saved: Any) -> Any:
    """A saved leaf in the template leaf's kind, device and dtype.  A
    shape mismatch is topology drift (another node count), not structure
    drift, and raises."""
    if isinstance(template, torch.Generator):
        gen = torch.Generator(device=template.device)
        gen.set_state(torch.as_tensor(saved, dtype=torch.uint8).cpu())
        return gen
    if isinstance(template, torch.Tensor):
        saved = torch.as_tensor(saved)
        if tuple(saved.shape) != tuple(template.shape):
            raise ValueError(
                f"checkpoint leaf shape {tuple(saved.shape)} does not match "
                f"template {tuple(template.shape)}: topology drift, not "
                "structure drift (a resume onto another node count goes "
                "through DistributedTrainer.load_checkpoint, which adopts "
                "the saved topology first)")
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, _SCALARS):
        return type(template)(saved)
    return saved


def _rebuild(template: Any, leaf_fn, prefix: Tuple[str, ...] = ()) -> Any:
    """``template``'s structure with every leaf replaced by
    ``leaf_fn(path, leaf)``."""
    if _is_leaf(template):
        return leaf_fn(prefix, template)
    fields = getattr(template, "_fields", None)
    if fields is not None:
        return type(template)(**{
            f: _rebuild(getattr(template, f), leaf_fn, prefix + (f,))
            for f in fields})
    if isinstance(template, dict):
        return {k: _rebuild(v, leaf_fn, prefix + (str(k),))
                for k, v in template.items()}
    items = [_rebuild(v, leaf_fn, prefix + (str(i),))
             for i, v in enumerate(template)]
    return items if isinstance(template, list) else tuple(items)


def _merge_into_template(template: Any, raw: Any) -> Any:
    """Graft a restored raw tree (nested dicts keyed like the saved paths,
    or sequences) onto ``template`` by name: same-named slots take the
    saved value, slots the checkpoint lacks keep the template's, and
    saved keys with no slot are dropped.  The forward/backward path for
    checkpoint structure drift."""
    if raw is None:
        return template
    if _is_leaf(template):
        if template is None or isinstance(raw, (dict, list, tuple)):
            return template
        return _adopt(template, raw)
    fields = getattr(template, "_fields", None)
    if fields is not None:
        raw_map = raw if isinstance(raw, dict) else {}
        return type(template)(**{
            f: _merge_into_template(getattr(template, f), raw_map.get(f))
            for f in fields})
    if isinstance(template, dict):
        raw_map = raw if isinstance(raw, dict) else {}
        return {k: _merge_into_template(v, raw_map.get(str(k)))
                for k, v in template.items()}
    if isinstance(raw, dict):   # sequences saved under stringified indices
        raw_seq = [raw.get(str(i)) for i in range(len(template))]
    elif isinstance(raw, (list, tuple)):
        raw_seq = list(raw) + [None] * (len(template) - len(raw))
    else:
        raw_seq = [None] * len(template)
    items = [_merge_into_template(v, r) for v, r in zip(template, raw_seq)]
    return items if isinstance(template, list) else tuple(items)


def _snapshot(state: Any) -> Tuple[Dict[str, Dict[str, torch.Tensor]],
                                   Dict[str, Any]]:
    """Host copy of ``state``: per file, {path: CPU tensor} (explicit
    copies, never views of the live state), and the leaf table with the
    scalars."""
    files: Dict[str, Dict[str, torch.Tensor]] = {}
    table: Dict[str, Any] = {}
    for path, leaf in _leaves(state):
        if leaf is None:
            continue
        if not path:
            raise TypeError("checkpoint: the state must be a container")
        key = "/".join(path)
        if isinstance(leaf, _SCALARS):
            table[key] = {"kind": type(leaf).__name__, "value": leaf}
            continue
        if isinstance(leaf, torch.Generator):
            kind, tensor = "generator", leaf.get_state()
        else:
            kind = "tensor"
            tensor = leaf.detach().to("cpu", copy=True)
        name = f"{path[0]}.pt"
        files.setdefault(name, {})[key] = tensor
        table[key] = {"kind": kind, "file": name,
                      "shape": list(tensor.shape),
                      "dtype": str(tensor.dtype).replace("torch.", "")}
    return files, table


class CheckpointManager:
    """Step-addressed, verified checkpoints under ``directory``
    (``checkpoint_step_{N}``, the reference's naming).  ``chaos``
    optionally wires a ``chaos.FaultInjector`` into the commit path;
    ``trace`` (an obs ``TraceBus``, set by the trainer's ``attach_obs``)
    receives each COMMIT outcome as a ``ckpt_commit`` event: only the
    manager knows whether the manifest landed."""

    def __init__(self, directory: str = "checkpoints", chaos: Any = None):
        self.directory = os.path.abspath(directory)
        self.chaos = chaos
        self.trace: Any = None
        # One in-flight save awaiting its COMMIT: the writer thread, its
        # error if it raised, and where it writes.
        self._pending: Optional[Dict[str, Any]] = None
        self.timings: collections.deque = collections.deque(maxlen=256)

    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_step_{step}")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"manifest_{step}.json")

    def _inflight_path(self, step: int) -> str:
        return os.path.join(self.directory, f"inflight_{step}")

    # -- topology sidecar -------------------------------------------------

    def _meta_path(self, step: int) -> str:
        return os.path.join(self.directory, f"topology_{step}.json")

    def save_metadata(self, step: int, meta: dict) -> None:
        os.makedirs(self.directory, exist_ok=True)
        atomic_write_json(self._meta_path(step), meta, indent=None)

    def load_metadata(self, step: int) -> Optional[dict]:
        path = self._meta_path(step)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    # -- save -------------------------------------------------------------

    def save(self, state: Any, step: int, force: bool = False,
             block: bool = True) -> str:
        """Save ``state`` as step ``step``.  ``block=False`` returns once
        the host copy is taken; the write overlaps the next steps and
        commits at the next join point.  ``force=True`` overwrites a good
        checkpoint through a staging directory swapped in at commit, so a
        failed overwrite never loses the last good state."""
        path = self.path_for(step)
        os.makedirs(self.directory, exist_ok=True)
        # Join (and commit) a previous in-flight save before inspecting
        # the destination.
        self._join()
        exists = os.path.exists(path)
        # A full check, not just the marker: a re-save at an existing step
        # (a post-rollback replay) replaces a committed-but-rotten one.
        usable, reason = self.check_integrity(step) if exists else (
            False, "missing payload")
        if exists and usable and not force:
            logger.info("Checkpoint already exists: %s", path)
            return path
        staging = None
        if exists and not usable:
            logger.warning("Clearing unusable checkpoint at step %d (%s): "
                           "%s", step, reason, path)
            shutil.rmtree(path)
            _unlink(self._manifest_path(step))
            _unlink(self._inflight_path(step))
        elif exists:
            staging = path + ".staging"
            if os.path.exists(staging):
                shutil.rmtree(staging)
        target = staging if staging is not None else path
        t0 = time.perf_counter()
        files, table = _snapshot(state)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        record = {"op": "save", "step": step,
                  "snapshot_s": time.perf_counter() - t0}
        # A presence-only marker: it tells a crashed save from a legacy
        # directory; the manifest is the COMMIT record.
        with open(self._inflight_path(step), "w") as f:
            f.write("save in flight; the manifest is the COMMIT marker\n")
        pending: Dict[str, Any] = {"step": step, "target": target,
                                   "final": path, "record": record,
                                   "error": None, "thread": None}
        if block:
            self._write_timed(target, files, table, record)
            self._pending = pending
            self._join()
        else:
            def write() -> None:
                try:
                    self._write_timed(target, files, table, record)
                except BaseException as exc:  # re-raised at the join
                    pending["error"] = exc

            pending["thread"] = threading.Thread(
                target=write, name=f"checkpoint-{step}", daemon=True)
            self._pending = pending
            pending["thread"].start()
        logger.info("Checkpoint %s: %s",
                    "saved" if block else "saving (async)", path)
        return path

    def _write_timed(self, target: str, files: Dict[str, Dict[str, Any]],
                     table: Dict[str, Any], record: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        self._write_payload(target, files, table)
        record["write_s"] = time.perf_counter() - t0

    def _write_payload(self, target: str, files: Dict[str, Dict[str, Any]],
                       table: Dict[str, Any]) -> None:
        """The payload: one ``torch.save`` file per top-level field, then
        the leaf table."""
        os.makedirs(target, exist_ok=True)
        for name, tensors in files.items():
            torch.save(tensors, os.path.join(target, name))
        atomic_write_json(os.path.join(target, META_FILE),
                          {"format": FORMAT, "leaves": table}, indent=None)

    def _join(self) -> None:
        """Join the in-flight save and COMMIT it: swap staging into place
        (force-overwrites), write the checksum manifest atomically, drop
        the in-flight marker.  Nothing before the manifest write is
        visible to restore: that order is the crash-safety contract."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        if pending["thread"] is not None:
            pending["thread"].join()
        if pending["error"] is not None:
            raise pending["error"]
        step, target, final = (pending["step"], pending["target"],
                               pending["final"])
        if self.chaos is not None and not self.chaos.on_checkpoint_commit(
                step):
            if self.trace is not None:
                self.trace.emit(EventType.CKPT_COMMIT, step=step,
                                committed=False,
                                reason="chaos_crash_before_commit")
            return  # drill: died before COMMIT, payload left uncommitted
        if target != final:
            # Retire the old checkpoint only now that its replacement is
            # on disk; the manifest goes first, so a crash in this window
            # demotes the old payload to uncommitted.
            _unlink(self._manifest_path(step))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(target, final)
        record = pending["record"]
        t0 = time.perf_counter()
        record["bytes"] = self._write_manifest(step, final)
        record["crc_s"] = time.perf_counter() - t0
        self.timings.append(record)
        _unlink(self._inflight_path(step))
        if self.trace is not None:
            self.trace.emit(EventType.CKPT_COMMIT, step=step,
                            committed=True)
        if self.chaos is not None:
            self.chaos.on_checkpoint_saved(step, final)

    def _write_manifest(self, step: int, path: str) -> int:
        files: Dict[str, Dict[str, int]] = {}
        total = 0
        for dirpath, _, names in os.walk(path):
            for name in sorted(names):
                p = os.path.join(dirpath, name)
                rel = os.path.relpath(p, path)
                size = os.path.getsize(p)
                files[rel] = {"size": size, "crc32": _crc32_file(p)}
                total += size
        atomic_write_json(self._manifest_path(step),
                          {"step": step, "files": files}, indent=None)
        return total

    # -- integrity --------------------------------------------------------

    def check_integrity(self, step: int, verify: bool = True
                        ) -> Tuple[bool, str]:
        """(ok, reason) for one step: committed (manifest present) and,
        with ``verify``, every manifest entry's size and CRC32 matching
        the bytes on disk.  A directory with neither manifest nor
        in-flight marker is legacy: accepted, unverifiable."""
        path = self.path_for(step)
        if not os.path.isdir(path):
            return False, "missing payload"
        mpath = self._manifest_path(step)
        if not os.path.exists(mpath):
            if os.path.exists(self._inflight_path(step)):
                return False, "uncommitted (save died before COMMIT)"
            return True, "legacy (pre-manifest, unverifiable)"
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as exc:
            return False, f"unreadable manifest ({exc})"
        if not verify:
            return True, "committed"
        t0 = time.perf_counter()
        total = 0
        for rel, meta in manifest.get("files", {}).items():
            p = os.path.join(path, rel)
            if not os.path.exists(p):
                return False, f"missing file {rel}"
            if os.path.getsize(p) != meta["size"]:
                return False, f"size mismatch on {rel}"
            if _crc32_file(p) != meta["crc32"]:
                return False, f"checksum mismatch on {rel}"
            total += meta["size"]
        self.timings.append({"op": "check", "step": step, "bytes": total,
                             "s": time.perf_counter() - t0})
        return True, "verified"

    def wait(self) -> None:
        """Join (and commit) any in-flight save."""
        self._join()

    # -- restore ----------------------------------------------------------

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure, devices and dtypes of ``template``.
        ``step=None`` walks the steps newest-first and restores the newest
        one that is committed, passes its checksums and loads; an
        explicit ``step`` that fails its check raises."""
        self._join()
        if step is None:
            skipped = []
            for s in sorted(_payload_steps(self.directory), reverse=True):
                ok, reason = self.check_integrity(s)
                if not ok:
                    logger.warning("Skipping checkpoint step %d: %s", s,
                                   reason)
                    skipped.append((s, reason))
                    continue
                try:
                    return self._restore_step(template, s)
                except Exception as exc:  # corrupt beyond the checksums
                    logger.warning(
                        "Restore of checkpoint step %d failed (%s: %s); "
                        "walking back to an older checkpoint", s,
                        type(exc).__name__, str(exc)[:200])
                    skipped.append((s, type(exc).__name__))
            if skipped:
                raise FileNotFoundError(
                    f"no restorable checkpoint under {self.directory} "
                    f"(skipped: {skipped})")
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        ok, reason = self.check_integrity(step)
        if not ok:
            raise RuntimeError(
                f"checkpoint step {step} failed its integrity check "
                f"({reason}); refusing an explicit-step restore: use "
                "restore(step=None) to fall back to the latest verified "
                "checkpoint")
        return self._restore_step(template, step)

    def _load_payload(self, path: str) -> Dict[str, Any]:
        """Every saved leaf, keyed by path: tensors on the CPU, scalars."""
        table = self._saved_tree(path)
        flat: Dict[str, Any] = {}
        for name in sorted({v["file"] for v in table.values()
                            if "file" in v}):
            flat.update(torch.load(os.path.join(path, name),
                                   weights_only=True, map_location="cpu"))
        for key, info in table.items():
            if "value" in info:
                flat[key] = info["value"]
        return flat

    def _restore_step(self, template: Any, step: int) -> Any:
        path = self.path_for(step)
        t0 = time.perf_counter()
        flat = self._load_payload(path)
        t1 = time.perf_counter()
        if _saved_paths(flat) == _template_paths(template):
            state = _rebuild(template, lambda p, leaf: None if leaf is None
                             else _adopt(leaf, flat["/".join(p)]))
        else:
            # Structure drift (a state field added or removed between
            # versions) restores by name; any failure on a
            # structure-identical checkpoint above stays loud.
            logger.warning(
                "Checkpoint step %d's structure differs from the template: "
                "restoring by name (fields missing from the checkpoint keep "
                "their initialised values)", step)
            state = _merge_into_template(template, _nest(flat))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.timings.append({
            "op": "restore", "step": step,
            "bytes": sum(v.numel() * v.element_size() for v in flat.values()
                         if isinstance(v, torch.Tensor)),
            "read_s": t1 - t0, "to_device_s": time.perf_counter() - t1})
        logger.info("Checkpoint restored: %s", path)
        return state

    def _saved_tree(self, path: str) -> Dict[str, Any]:
        """The saved leaf table: path -> kind, file, shape, dtype (or the
        scalar's value)."""
        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} checkpoint")
        return meta["leaves"]

    def saved_shapes(self, step: int, field: str
                     ) -> Dict[str, Tuple[int, ...]]:
        """The saved shapes of one state field's tensor leaves at
        ``step`` (``field="params"``: the weights), keyed by their path
        under the field, from the leaf table alone."""
        head = field + "/"
        return {key[len(head):]: tuple(info["shape"])
                for key, info in self._saved_tree(self.path_for(step))
                .items()
                if key.startswith(head) and info.get("kind") == "tensor"}

    def verified_steps(self) -> List[int]:
        """Every restorable step, newest first: the rollback candidates."""
        self._join()
        return [s for s in sorted(_payload_steps(self.directory),
                                  reverse=True)
                if self.check_integrity(s)[0]]

    def latest_step(self, verified: bool = True) -> Optional[int]:
        """The newest step a restore would land on (uncommitted and
        checksum-failing steps walked past); ``verified=False`` is the
        raw listing."""
        self._join()
        for s in sorted(_payload_steps(self.directory), reverse=True):
            if not verified:
                return s
            ok, reason = self.check_integrity(s)
            if ok:
                return s
            logger.warning("latest_step: skipping step %d: %s", s, reason)
        return None


__all__ = ["CheckpointManager", "FORMAT", "leaf_shapes"]
