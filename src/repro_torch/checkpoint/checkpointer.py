"""Atomic, asynchronous, verified checkpoints in the JAX package's on-disk
format (port of the single-process layout of ``repro.checkpoint``).

A committed step is a directory ``step_%010d`` holding ``arrays.npz`` and
``meta.json``, exactly as the JAX package writes them:

  - save(): the tree is copied to the host synchronously, then written
    off the step path (a thread by default): one uncompressed ``.npz``
    with path-flattened keys (``.Y``, ``.hd_idx``, ... for a
    ``FuncSNEState``; ``['key']`` for a dict; ``[i]`` for a sequence;
    nested paths joined by ``||``), committed by renaming a tmp dir;
  - integrity manifest: ``meta.json`` records the CRC32 of the file's
    bytes and the array manifest (key, dtype, shape), computed from the
    bytes about to be written;
  - verify_step(): re-reads the files and checks the CRC32, the exact
    array set with dtypes and shapes, row coverage and the n_hosts count,
    raising :class:`CheckpointCorrupt` before anything is loaded;
  - restore(): verify (on by default), check the writer's config
    fingerprint (:func:`cfg_compat`) when asked, then load each leaf with
    the dtype, shape and device of the like-tree's leaf;
  - restore_verified(): walk committed steps newest -> oldest until one
    verifies, returning the damaged boundaries skipped; ``keep_last``
    pruning never evicts the step that last verified;
  - an async write failure raises on the next ``wait()`` or ``save()``;
    ``close()`` (and ``__del__``) warn about an error nobody observed.

The port's ``FuncSNEState`` keeps its key as int64 words where the JAX
package keeps uint32: ``funcsne.fit`` saves the state through
``core.convert.state_to_numpy``, so its checkpoints carry the JAX dtypes,
and a restore casts each leaf to the like-tree's dtype, so a JAX
checkpoint restores into the port.  ``python -m repro.checkpoint.verify``
accepts the port's checkpoints and the JAX ``Checkpointer`` restores them.

The JAX package's multi-host layout (per-host ``shard*-of-*.npz`` files,
generation tags, ``restore(shardings=)``) is not ported: verify_step()
checks such a directory, and restore() refuses it with
:class:`CheckpointIncompatible`.

``python -m repro_torch.checkpoint.verify <dir>`` runs the same
verification over every committed step of a checkpoint directory.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import time
import warnings
import zlib
from pathlib import Path
from typing import Any, List, Optional

import numpy as np
import torch

_SEP = "||"
_ROWS = "@rows"     # key suffix of a host-sliced leaf: key||@rows<start>
_ARRAYS = "arrays.npz"


# --------------------------------------------------------------------------
# Structured errors


class CheckpointError(RuntimeError):
    """Base class for structured checkpoint failures."""


class CheckpointNotFound(CheckpointError, FileNotFoundError):
    """The requested step (or any step at all) is not committed.

    Attributes:
      step:      the step requested (None = latest).
      available: the committed steps actually present, oldest first.
    """

    def __init__(self, directory, step: Optional[int],
                 available: List[int]):
        what = "no checkpoints" if step is None \
            else f"no checkpoint for step {step}"
        super().__init__(
            f"{what} under {directory}; available steps: "
            f"{available if available else '(none)'}")
        self.step = step
        self.available = list(available)


class CheckpointCorrupt(CheckpointError):
    """A committed checkpoint failed integrity verification.

    Attributes:
      step:   the step that failed.
      path:   the step directory.
      reason: what exactly failed (missing file, CRC mismatch, row
              coverage gap/overlap, dtype/shape drift, ...).
    """

    def __init__(self, path, step: int, reason: str):
        super().__init__(
            f"checkpoint step {step} under {path} failed verification: "
            f"{reason}")
        self.step = step
        self.path = str(path)
        self.reason = reason


class CheckpointIncompatible(CheckpointError):
    """The checkpoint verifies but cannot continue this run: it was written
    under another config (n / dims / K / flag matrix), or in the
    multi-host layout this package does not restore.

    Attributes:
      step:       the step checked.
      mismatches: ``{field: (checkpoint_value, expected_value)}``.
    """

    def __init__(self, path, step: int, mismatches: dict):
        diffs = ", ".join(f"{k}: checkpoint={a!r} != expected={b!r}"
                          for k, (a, b) in sorted(mismatches.items()))
        super().__init__(
            f"checkpoint step {step} under {path} is incompatible with "
            f"the resuming config: {diffs}")
        self.step = step
        self.path = str(path)
        self.mismatches = mismatches


def cfg_compat(cfg) -> dict:
    """Restore-compatibility fingerprint of a ``FuncSNEConfig``-like
    object: the fields a resumed run must agree on for the restored state
    to mean the same thing (array geometry) and for the random streams to
    continue bit-identically (the fused-flag matrix).  Duck-typed, so the
    checkpoint layer never imports ``core``; equal to the JAX package's
    for the same config."""
    return {
        "n": int(cfg.n_points), "dim_hd": int(cfg.dim_hd),
        "dim_ld": int(cfg.dim_ld), "k_hd": int(cfg.k_hd),
        "k_ld": int(cfg.k_ld), "c_hd_rev": int(cfg.c_hd_rev),
        "flags": {
            "gather_fused": bool(cfg.gather_fused),
            "scatter_fused": bool(cfg.scatter_fused),
            "merge_fused": bool(cfg.merge_fused),
            "cand_fused": bool(cfg.cand_fused),
        },
    }


def _compat_mismatches(recorded: dict, expected: dict, prefix="") -> dict:
    out = {}
    for k, want in expected.items():
        have = recorded.get(k) if isinstance(recorded, dict) else None
        if isinstance(want, dict):
            out.update(_compat_mismatches(have or {}, want,
                                          prefix=f"{prefix}{k}."))
        elif have != want:
            out[f"{prefix}{k}"] = (have, want)
    return out


# --------------------------------------------------------------------------
# Trees: NamedTuples, dicts, lists and tuples of tensors or arrays


def _children(tree):
    """``[(path entry, child)]`` of a node, or None for a leaf; the path
    entries print as JAX's key paths do."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix="") -> dict:
    kids = _children(tree)
    if kids is None:
        return {prefix: _to_numpy(tree)}
    flat = {}
    for entry, child in kids:
        flat.update(_flatten(child, f"{prefix}{_SEP}{entry}" if prefix
                             else entry))
    return flat


def _like_leaf(like, arr: np.ndarray):
    """``arr`` with the dtype and shape of ``like`` (and its device, for a
    tensor)."""
    if isinstance(like, torch.Tensor):
        want = torch.empty((), dtype=like.dtype).numpy().dtype
        # np.array copies C-contiguous and keeps 0-d shapes
        a = np.array(arr, dtype=want).reshape(tuple(like.shape))
        return torch.from_numpy(a).to(like.device)
    ref = np.asarray(like)
    return np.asarray(arr).astype(ref.dtype).reshape(ref.shape)


def _unflatten_into(like, flat: dict, prefix=""):
    kids = _children(like)
    if kids is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        return _like_leaf(like, flat[prefix])
    vals = [_unflatten_into(child, flat, f"{prefix}{_SEP}{entry}"
                            if prefix else entry) for entry, child in kids]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*vals)
    if isinstance(like, dict):
        return dict(zip(like.keys(), vals))
    return type(like)(vals)


# --------------------------------------------------------------------------
# Checkpointer


class Checkpointer:
    def __init__(self, directory, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        # last step that PASSED verification: pruning never evicts it, so
        # the fallback chain always has a floor to land on
        self._verified_step: Optional[int] = None

    # -- save ------------------------------------------------------------

    def save(self, step: int, tree: Any, metadata: dict = None,
             blocking: bool = False):
        """The tree is copied to the host now; the write runs on a thread
        unless ``blocking``.  A step already committed is overwritten."""
        self.wait()
        flat = _flatten(tree)
        meta = dict(metadata or {})
        meta["step"] = int(step)
        meta["time"] = time.time()
        meta["n_hosts"] = 1
        arrays_meta = {key: {"dtype": str(a.dtype), "shape": list(a.shape)}
                       for key, a in flat.items()}

        def write():
            try:
                # serialise in memory first: the manifest's CRC32 is over
                # the exact bytes that reach the disk
                buf = io.BytesIO()
                np.savez(buf, **flat)
                blob = buf.getvalue()
                file_meta = {"crc32": zlib.crc32(blob) & 0xFFFFFFFF,
                             "arrays": arrays_meta}
                tmp = self.dir / f".tmp-{step}"
                final = self.dir / f"step_{step:010d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                (tmp / _ARRAYS).write_bytes(blob)
                meta["manifest"] = {"n_hosts": 1,
                                    "files": {_ARRAYS: file_meta}}
                (tmp / "meta.json").write_text(json.dumps(meta))
                if final.exists():
                    shutil.rmtree(final)
                os.rename(tmp, final)          # atomic commit
                self._prune()
            except BaseException as e:        # surfaced on next wait()
                self.last_error = e

        if blocking:
            write()
            if self.last_error is not None:   # blocking callers want it now
                err, self.last_error = self.last_error, None
                raise err
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def close(self):
        """Join any write in flight; WARN (never raise) on an error that no
        ``wait()`` observed.  Safe on error-handling paths, where raising
        would mask the exception in flight."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            warnings.warn(
                f"[checkpoint] async write under {self.dir} failed and the "
                f"error was never observed by wait(): {err!r} -- the last "
                f"checkpoint of this run may be missing", RuntimeWarning,
                stacklevel=2)

    def __del__(self):
        # a Checkpointer dropped with a pending failure must not take the
        # evidence with it; never join or raise during interpreter teardown
        err = getattr(self, "last_error", None)
        if err is not None:
            self.last_error = None      # deliver once
            try:
                warnings.warn(
                    f"[checkpoint] Checkpointer({self.dir}) garbage-"
                    f"collected with an unobserved write error: {err!r}",
                    RuntimeWarning, stacklevel=2)
            except Exception:       # pragma: no cover - teardown races
                pass

    def _prune(self):
        steps = self.all_steps()
        # keep_last=0 keeps nothing: guard the [:-0] slice that would keep
        # everything
        drop = steps if self.keep_last <= 0 else steps[:-self.keep_last]
        for s in drop:
            if s == self._verified_step:
                # never evict the boundary the fallback chain last landed
                # on: newer steps have not been verified
                continue
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------

    def all_steps(self):
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if (p / "meta.json").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- verify ----------------------------------------------------------

    def verify_step(self, step: int) -> dict:
        """Full integrity check of one committed step without loading it
        into a tree: CRC32 of every file, the exact array set with dtypes
        and shapes, row coverage of host-sliced leaves (each covered once,
        no gaps or overlaps) and the n_hosts count.  Returns the metadata;
        raises :class:`CheckpointCorrupt` naming the failure otherwise."""
        d = self.dir / f"step_{step:010d}"
        if not (d / "meta.json").exists():
            raise CheckpointNotFound(self.dir, step, self.all_steps())
        try:
            meta = json.loads((d / "meta.json").read_text())
        except (OSError, ValueError) as e:
            raise CheckpointCorrupt(d, step, f"meta.json unreadable: {e}")
        man = meta.get("manifest")
        if not isinstance(man, dict) or "files" not in man:
            raise CheckpointCorrupt(
                d, step, "meta.json carries no integrity manifest "
                "(checkpoint predates verification?)")
        want_files = man["files"]
        have = sorted(p.name for p in d.glob("*.npz"))
        missing = sorted(set(want_files) - set(have))
        stray = sorted(set(have) - set(want_files))
        if missing:
            raise CheckpointCorrupt(
                d, step, f"missing shard file(s): {missing}")
        if stray:
            raise CheckpointCorrupt(
                d, step, f"file(s) not in manifest: {stray}")
        if int(man.get("n_hosts", len(want_files))) != len(want_files):
            raise CheckpointCorrupt(
                d, step, f"manifest n_hosts={man.get('n_hosts')} but "
                f"{len(want_files)} shard file(s) recorded")

        coverage = {}   # base key -> [(start, stop, full_rows, fname)]
        plain_seen = {}  # base key -> fname (unsliced leaves)
        for fname, fman in sorted(want_files.items()):
            try:
                blob = (d / fname).read_bytes()
            except OSError as e:
                raise CheckpointCorrupt(d, step, f"{fname}: unreadable: {e}")
            crc = zlib.crc32(blob) & 0xFFFFFFFF
            if crc != int(fman["crc32"]):
                raise CheckpointCorrupt(
                    d, step, f"{fname}: CRC32 mismatch "
                    f"(file {crc:#010x} != manifest "
                    f"{int(fman['crc32']) & 0xFFFFFFFF:#010x})")
            try:
                with np.load(io.BytesIO(blob), allow_pickle=False) as z:
                    info = {k: (str(z[k].dtype), list(z[k].shape))
                            for k in z.files}
            except Exception as e:
                raise CheckpointCorrupt(
                    d, step, f"{fname}: unloadable npz despite matching "
                    f"CRC: {e}")
            want_arrays = fman.get("arrays", {})
            if set(want_arrays) != set(info):
                gone = sorted(set(want_arrays) - set(info))
                extra = sorted(set(info) - set(want_arrays))
                raise CheckpointCorrupt(
                    d, step, f"{fname}: array set drifted from manifest "
                    f"(missing {gone}, unexpected {extra})")
            for key, am in want_arrays.items():
                dt, shp = info[key]
                if dt != am["dtype"] or shp != list(am["shape"]):
                    raise CheckpointCorrupt(
                        d, step, f"{fname}: {key}: {dt}{shp} != manifest "
                        f"{am['dtype']}{list(am['shape'])}")
                if "rows" in am:
                    lo, hi = int(am["rows"][0]), int(am["rows"][1])
                    if hi - lo != shp[0]:
                        raise CheckpointCorrupt(
                            d, step, f"{fname}: {key}: row range "
                            f"[{lo}, {hi}) disagrees with leading dim "
                            f"{shp[0]}")
                    base = key.rpartition(_SEP + _ROWS)[0]
                    coverage.setdefault(base, []).append(
                        (lo, hi, int(am["full_rows"]), fname))
                else:
                    if key in plain_seen:
                        raise CheckpointCorrupt(
                            d, step, f"leaf {key} written whole by both "
                            f"{plain_seen[key]} and {fname}")
                    plain_seen[key] = fname
        for base, parts in coverage.items():
            if base in plain_seen:
                raise CheckpointCorrupt(
                    d, step, f"leaf {base} written both whole "
                    f"({plain_seen[base]}) and row-sliced")
            full = {p[2] for p in parts}
            if len(full) != 1:
                raise CheckpointCorrupt(
                    d, step, f"leaf {base}: shards disagree on full row "
                    f"count: {sorted(full)}")
            n_rows = full.pop()
            pos = 0
            for lo, hi, _, fname in sorted(parts):
                if lo > pos:
                    raise CheckpointCorrupt(
                        d, step, f"leaf {base}: rows [{pos}, {lo}) "
                        f"uncovered")
                if lo < pos:
                    raise CheckpointCorrupt(
                        d, step, f"leaf {base}: rows [{lo}, {pos}) "
                        f"covered twice ({fname})")
                pos = hi
            if pos != n_rows:
                raise CheckpointCorrupt(
                    d, step, f"leaf {base}: rows [{pos}, {n_rows}) "
                    f"uncovered")
        return meta

    def restore(self, like_tree: Any, step: Optional[int] = None,
                verify: bool = True, expect_compat: Optional[dict] = None):
        """Returns (tree, metadata): the checkpoint's leaves with the dtype,
        shape and device of ``like_tree``'s.

        ``verify=True`` (default) runs :meth:`verify_step` first, raising
        :class:`CheckpointCorrupt` before anything is loaded.
        ``expect_compat`` (a :func:`cfg_compat` dict) raises
        :class:`CheckpointIncompatible` when the checkpoint was written under
        another config fingerprint, as does a step in the multi-host
        layout.  A missing step (or an empty directory) raises
        :class:`CheckpointNotFound` naming the available steps."""
        steps = self.all_steps()
        if step is None:
            if not steps:
                raise CheckpointNotFound(self.dir, None, [])
            step = steps[-1]
        elif step not in steps:
            raise CheckpointNotFound(self.dir, step, steps)
        d = self.dir / f"step_{step:010d}"
        if verify:
            meta = self.verify_step(step)
            self._verified_step = step
        else:
            meta = json.loads((d / "meta.json").read_text())
        man = meta.get("manifest") or {}
        files = sorted(man.get("files") or (p.name for p in d.glob("*.npz")))
        if files != [_ARRAYS] or int(meta.get("n_hosts", 1)) != 1:
            raise CheckpointIncompatible(d, step, {"layout": (
                f"{len(files)} file(s) {files}, n_hosts="
                f"{meta.get('n_hosts')}", f"one {_ARRAYS}, n_hosts=1")})
        if expect_compat is not None:
            mism = _compat_mismatches(meta.get("compat") or {},
                                      expect_compat)
            if mism:
                raise CheckpointIncompatible(d, step, mism)
        with np.load(d / _ARRAYS, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten_into(like_tree, flat), meta

    def restore_verified(self, like_tree: Any, step: Optional[int] = None,
                         expect_compat: Optional[dict] = None):
        """Fallback-chain restore: walk committed steps newest -> oldest (at
        most ``step``, when given) until one passes verification.

        Returns ``(tree, metadata, fallbacks)``, where ``fallbacks`` lists
        ``{"step", "reason"}`` for every damaged boundary skipped (callers
        log one ``checkpoint_fallback`` event each).  Raises
        :class:`CheckpointNotFound` when nothing is committed,
        :class:`CheckpointCorrupt` when every committed step is damaged,
        and :class:`CheckpointIncompatible` at once on a config mismatch
        (every boundary of a run shares its config, so falling back would
        only mask the user's error)."""
        steps = self.all_steps()
        if step is not None:
            steps = [s for s in steps if s <= step]
        if not steps:
            raise CheckpointNotFound(self.dir, step, self.all_steps())
        fallbacks = []
        for s in reversed(steps):
            try:
                tree, meta = self.restore(like_tree, step=s,
                                          expect_compat=expect_compat)
            except CheckpointCorrupt as e:
                fallbacks.append({"step": s, "reason": e.reason})
                continue
            return tree, meta, fallbacks
        raise CheckpointCorrupt(
            self.dir, steps[-1],
            "every committed step failed verification: " + "; ".join(
                f"step {f['step']}: {f['reason']}" for f in fallbacks))
