"""Atomic, asynchronous, verified checkpoints in the JAX package's on-disk
format, one host or many (port of ``repro.checkpoint``).

A committed step is a directory ``step_%010d`` holding ``meta.json`` and
either ``arrays.npz`` (one writer) or one ``shard<h>-of-<H>[-g<G>].npz`` a
host, exactly as the JAX package writes them:

  - save(): the tree is copied to the host synchronously, then written
    off the step path (a thread by default): one uncompressed ``.npz``
    with path-flattened keys (``.Y``, ``.hd_idx``, ... for a
    ``FuncSNEState``; ``['key']`` for a dict; ``[i]`` for a sequence;
    nested paths joined by ``||``), committed by renaming a tmp dir;
  - many hosts: each writes only its part (``host_shard_filter``, e.g.
    :func:`row_shard_filter`: host ``h``'s rows of every row-indexed leaf,
    host 0 the rest) with ``host_id`` / ``n_hosts``.  Parts are staged
    with a ``.manifest.json`` sidecar under the shared ``.tmp-<step>``;
    the writer that completes the set claims the commit with an
    ``O_EXCL`` marker ``.tmp-<step>.claim[-g<G>]`` and renames the
    directory, so a step is only ever visible whole, and a writer that
    loses the race never deletes the committed step.  A ``generation``
    (the pod incarnation a control plane bumps on every relaunch) tags the
    parts; the completing writer evicts every other file still staged
    (recorded in ``evicted_stale``), so a dead generation's parts never
    merge into a relaunch's boundary;
  - integrity manifest: ``meta.json`` records each file's CRC32 and its
    array manifest (key, dtype, shape, row range), computed from the bytes
    about to be written;
  - verify_step(): re-reads the files and checks the CRC32, the exact
    array set with dtypes and shapes, row coverage (each row-sliced leaf
    covered once, no gap or overlap) and the n_hosts count, raising
    :class:`CheckpointCorrupt` before anything is loaded;
  - restore(): verify (on by default), check the writer's config
    fingerprint (:func:`cfg_compat`) when asked, load only the files the
    committing generation's manifest names, merge row slices by offset,
    then give each leaf the dtype, shape and device of the like-tree's
    leaf;
  - restore_verified(): walk committed steps newest -> oldest until one
    verifies, returning the damaged boundaries skipped; ``keep_last``
    pruning never evicts the step that last verified;
  - an async write failure raises on the next ``wait()`` or ``save()``;
    ``close()`` (and ``__del__``) warn about an error nobody observed.

The reference's ``restore(shardings=)`` lays the merged arrays out on a
target JAX mesh.  The port has no counterpart: every rank of a grid holds
a whole replica, so each rank restores the merged tree onto its own device
(the like-tree's), whatever grid or host count wrote it.

The port's ``FuncSNEState`` keeps its key as int64 words where the JAX
package keeps uint32: ``funcsne.fit`` saves the state through
``core.convert.state_to_numpy``, so its checkpoints carry the JAX dtypes,
and a restore casts each leaf to the like-tree's dtype, so a JAX
checkpoint restores into the port.  ``python -m repro.checkpoint.verify``
accepts the port's checkpoints and the JAX ``Checkpointer`` restores them.

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
from typing import Any, Callable, List, Optional

import numpy as np
import torch

_SEP = "||"
_ROWS = "@rows"     # key suffix of a host-sliced leaf: key||@rows<start>
_ARRAYS = "arrays.npz"
_MANIFEST_SUFFIX = ".manifest.json"     # staged sidecar of a part (tmp only)


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
    """The checkpoint verifies but was written under an incompatible config
    (another n / dims / K / flag matrix): restoring it would poison the
    resumed run rather than continue it.

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
    """A host copy of ``leaf``: the write thread serialises it while the
    caller goes on updating the tree in place, so a CPU tensor's memory is
    never shared (``.cpu()`` already copies a card's)."""
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().cpu().numpy()
        return arr.copy() if leaf.device.type == "cpu" else arr
    return np.array(leaf)


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


def row_shard_filter(host_id: int, n_hosts: int, n_rows: int) -> Callable:
    """The standard per-host filter: host ``h`` writes rows
    ``[h*n/H, (h+1)*n/H)`` of every leaf whose leading dim is ``n_rows``;
    host 0 also writes every other (replicated or scalar) leaf.  Pass it to
    :meth:`Checkpointer.save` as ``host_shard_filter``."""
    def filt(key: str, arr: np.ndarray):
        if arr.ndim >= 1 and arr.shape[0] == n_rows:
            lo = host_id * n_rows // n_hosts
            hi = (host_id + 1) * n_rows // n_hosts
            return lo, arr[lo:hi]
        return (None, arr) if host_id == 0 else None
    return filt


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
             blocking: bool = False, host_shard_filter: Callable = None,
             host_id: int = 0, n_hosts: int = 1,
             generation: Optional[int] = None):
        """The tree is copied to the host now; the write runs on a thread
        unless ``blocking``.

        ``host_shard_filter(key, array)`` selects what this host writes:
        ``None`` skips the leaf (another host owns it), ``(None, arr)``
        writes it whole, ``(start, rows)`` a row slice merged back by offset
        on restore (:func:`row_shard_filter`).  With ``n_hosts > 1`` or a
        ``generation`` each host stages ``shard<h>-of-<H>[-g<G>].npz`` under
        the shared tmp dir and the one completing the set commits (see the
        module docstring); with one host and no generation the step is
        ``arrays.npz``, and a step already committed is overwritten."""
        self.wait()
        meta = dict(metadata or {})
        meta["step"] = int(step)
        meta["time"] = time.time()
        meta["n_hosts"] = int(n_hosts)
        if generation is not None:
            meta["generation"] = int(generation)
        flat, arrays_meta = {}, {}
        for key, arr in _flatten(tree).items():
            picked = (None, arr) if host_shard_filter is None \
                else host_shard_filter(key, arr)
            if picked is None:
                continue
            start, part = picked
            entry = {"dtype": str(part.dtype), "shape": list(part.shape)}
            if start is not None:
                entry["rows"] = [int(start), int(start) + int(part.shape[0])]
                entry["full_rows"] = int(arr.shape[0])
                key = f"{key}{_SEP}{_ROWS}{int(start)}"
            flat[key] = part
            arrays_meta[key] = entry

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
                if n_hosts == 1 and generation is None:
                    # one writer: no commit race, so overwriting is safe
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
                elif not self._stage_and_commit(
                        step, tmp, final, blob, file_meta, meta, host_id,
                        n_hosts, generation):
                    return      # another writer completes or committed
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

    def _stage_and_commit(self, step, tmp, final, blob, file_meta, meta,
                          host_id, n_hosts, generation) -> bool:
        """Stage this host's part; commit if it completes the set.  True
        when this writer committed the step."""
        gen_tag = "" if generation is None else f"-g{int(generation):06d}"
        # the sidecar lands before the part is visible, so a visible part
        # always has its manifest on disk
        tmp.mkdir(parents=True, exist_ok=True)
        part = tmp / f"shard{host_id:03d}-of-{n_hosts:03d}{gen_tag}.npz"
        (tmp / (part.name + _MANIFEST_SUFFIX)).write_text(
            json.dumps(file_meta))
        part_tmp = part.with_suffix(".npz.tmp")
        part_tmp.write_bytes(blob)
        os.replace(part_tmp, part)
        parts = sorted(tmp.glob(f"shard*-of-{n_hosts:03d}{gen_tag}.npz"))
        if len(parts) < n_hosts:
            return False        # another host completes the set
        # Writers on separate processes reach a boundary nearly together,
        # so both can see a full set: exactly one claims the commit with an
        # O_EXCL marker beside the staging dir, and the other backs off
        # instead of renaming (or deleting) the committed step.  The claim
        # carries the generation, so one left by a writer that died
        # mid-commit never blocks a relaunch from committing the step.
        claim = self.dir / f".tmp-{step}.claim{gen_tag}"
        try:
            os.close(os.open(str(claim),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        except FileExistsError:
            return False        # the other completing writer commits
        try:
            files = {}
            for p in parts:
                side = tmp / (p.name + _MANIFEST_SUFFIX)
                files[p.name] = json.loads(side.read_text())
                side.unlink()
            if generation is not None:
                # anything still staged outside this generation's set is a
                # part (or a torn tmp / sidecar) of a generation that died
                # mid-checkpoint: evict it
                keep = {p.name for p in parts}
                evicted = []
                for f in sorted(tmp.iterdir()):
                    if f.name not in keep:
                        f.unlink()
                        evicted.append(f.name)
                if evicted:
                    meta["evicted_stale"] = evicted
            meta["manifest"] = {"n_hosts": n_hosts, "files": files}
            (tmp / "meta.json").write_text(json.dumps(meta))
            # never delete `final` first: a straggling writer can still get
            # here once the claim is released, and deleting would destroy
            # the boundary a resume depends on.  The rename is the commit;
            # its failure with the boundary present means the other won.
            os.rename(tmp, final)
        except OSError:
            if (final / "meta.json").exists():
                claim.unlink(missing_ok=True)
                return False    # lost the race: the boundary is committed
            raise
        for c in self.dir.glob(f".tmp-{step}.claim*"):
            try:
                c.unlink()
            except OSError:     # pragma: no cover
                pass
        return True

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
        another config fingerprint.  A missing step (or an empty
        directory) raises :class:`CheckpointNotFound` naming the available
        steps.  Per-host shard files merge by row offset
        (:meth:`_load_merged`), whatever host count wrote them."""
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
        if expect_compat is not None:
            mism = _compat_mismatches(meta.get("compat") or {},
                                      expect_compat)
            if mism:
                raise CheckpointIncompatible(d, step, mism)
        return _unflatten_into(like_tree, self._load_merged(d, meta)), meta

    def _load_merged(self, d: Path, meta: Optional[dict] = None) -> dict:
        """The flat arrays of one committed step directory: plain keys as
        they are, ``key||@rows<start>`` slices concatenated by offset.  The
        one-host ``arrays.npz`` is the n_hosts = 1 case of the same reader.

        Where ``meta`` has a manifest, only the files it names are read:
        the committing generation wrote it, so a stale-generation part that
        survived into the directory is left out rather than merged (the
        verifying reader flags it as a stray)."""
        man = (meta or {}).get("manifest")
        if isinstance(man, dict) and man.get("files"):
            files = [d / name for name in sorted(man["files"])]
        else:
            files = sorted(d.glob("shard*-of-*.npz")) or [d / _ARRAYS]
        flat, sliced = {}, {}
        for f in files:
            with np.load(f, allow_pickle=False) as z:
                for key in z.files:
                    if _SEP + _ROWS in key:
                        base, _, start = key.rpartition(_SEP + _ROWS)
                        sliced.setdefault(base, []).append(
                            (int(start), z[key]))
                    else:
                        flat[key] = z[key]
        for base, parts in sliced.items():
            parts.sort(key=lambda p: p[0])
            flat[base] = np.concatenate([a for _, a in parts], axis=0) \
                if len(parts) > 1 else parts[0][1]
        return flat

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
