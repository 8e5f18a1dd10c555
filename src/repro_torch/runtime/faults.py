"""Deterministic fault injection for the resilient runtime (port of
``repro.runtime.faults``).

Every recovery path of ``funcsne.fit``'s resilience layer is exercised by
scripted faults rather than by waiting for a card to misbehave:

  :class:`NaNChunk`          poisons the state handed to one chunk (the
                             rollback anchor stays clean), so the chunk's
                             health telemetry sees an optimisation that
                             blew up mid-flight; with ``shard=s`` only
                             rank ``s``'s replica, as a fault local to
                             one card would;
  :class:`IndexCorruption`   poisons an index table (``hd_idx`` /
                             ``ld_idx`` / ``rev_idx``) with out-of-range but
                             finite values, which only the chunk-boundary
                             audit (``ResiliencePolicy(audit_every=)``) sees;
  :class:`KernelLaunchFault` raises in place of one guarded launch of a
                             kernel family (``repro_torch.kernels.fallback``
                             consults this module right before the launch),
                             driving the sticky demotion to the plain
                             version on the CPU and the logged raise on
                             the card;
  :class:`Preemption`        raises :class:`Preempted` at a chunk boundary
                             (a kill between chunks); ``fit(resume_from=)``
                             must then reproduce the uninterrupted run bit
                             for bit;
  :class:`HostLoss`          raises :class:`HostLost` at a chunk boundary:
                             one simulated host (its block of ranks) drops
                             out; ``runtime.coordinator.fit_elastic``
                             quiesces the survivors, remeshes over the ranks
                             left and resumes from the last committed
                             boundary;
  :class:`ProcessKill`       SIGKILLs the worker process itself at a chunk
                             boundary, the real death :class:`HostLoss`
                             only simulates; recovery is the supervisor's
                             (``runtime.control``: kill the generation,
                             remesh over the survivors, relaunch from the
                             last committed generation-tagged boundary);
  :class:`CorruptShard`      damages the newest committed checkpoint on disk
                             (truncate / bit flip / delete), so that the
                             verified restore must fall back one boundary.

Faults are one-shot by default (``fired`` latches), so the retry of a
rolled-back chunk does not trip again: the script models a transient
fault, which is what rollback and retry are for.  ``once=False`` models
real divergence and spends the retry budget instead.

Usage::

    script = FaultScript(NaNChunk(at_step=40))
    with faults.active(script):
        st, _ = funcsne.fit(X, resilience=ResiliencePolicy(), ...)

``python -m repro_torch.runtime.faults --smoke [--device cpu]`` runs the
seven recovery scenarios end to end on tiny data (``host_loss`` on two
ranks of ``launch.mesh.run_ranks``, ``process_kill`` with two worker
processes under the supervisor).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional


class Preempted(RuntimeError):
    """Simulated preemption: the run was killed between chunks."""

    def __init__(self, step: int):
        super().__init__(f"simulated preemption at step {step}")
        self.step = step


class InjectedKernelFault(RuntimeError):
    """Raised in place of a kernel launch by :class:`KernelLaunchFault`."""


class HostLost(RuntimeError):
    """Simulated host loss: one host's ranks dropped out of the grid."""

    def __init__(self, step: int, host: int):
        super().__init__(f"simulated loss of host {host} at step {step}")
        self.step = step
        self.host = host


def _poison_rows(st, field: str, rows: int, value):
    """``st`` with the first ``rows`` rows of ``field`` set to ``value``
    (a new tensor: the caller's state is untouched)."""
    arr = getattr(st, field).clone()
    arr[:min(rows, arr.shape[0])] = value
    return st._replace(**{field: arr})


def _poison_one_replica(st, field: str, shard: int, rows: int, value):
    """``st`` with poison in rank ``shard``'s replica only: rows ``[shard *
    n_loc, shard * n_loc + rows)`` of ``field`` (its own row slice, ``n_loc
    = n // world``) on rank ``shard``, every other rank's replica untouched.
    This models a fault local to one card (a bad memory row, a kernel gone
    wrong on one device): the replicas no longer agree, yet every
    collective still runs.  Needs a process group of two or more ranks
    (``repro_torch.launch.mesh.run_ranks``); shard ``s`` is rank ``s``, in
    the grid's rank order."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() < 2:
        raise ValueError("poisoning one replica needs a process group of "
                         ">= 2 ranks (run_ranks)")
    world = dist.get_world_size()
    if not 0 <= shard < world:
        raise ValueError(f"shard {shard} out of range for {world} ranks")
    if dist.get_rank() != shard:
        return st
    arr = getattr(st, field).clone()
    n_loc = max(1, arr.shape[0] // world)
    lo = shard * n_loc
    arr[lo:lo + min(rows, n_loc)] = value
    return st._replace(**{field: arr})


@dataclasses.dataclass
class NaNChunk:
    """Poison the state entering the first chunk whose start step is
    ``>= at_step``: the first ``rows`` rows of ``field`` become NaN, as if
    the optimiser diverged mid-chunk.  The caller's rollback anchor (taken
    before injection) stays clean, so rollback and retry recover.

    ``shard=s`` poisons only rank ``s``'s replica, rows of its own slice
    (:func:`_poison_one_replica`).  With ``field="vel"`` the NaN reaches
    that rank's Y through the momentum update alone, which no collective
    touches within the step, so only a probe reduced over the grid sees it
    (poisoning Y instead spreads to every replica through the force sum
    within one step)."""
    at_step: int
    rows: int = 8
    once: bool = True
    fired: bool = False
    shard: Optional[int] = None
    field: str = "Y"

    def apply(self, st, it: int):
        if (self.fired and self.once) or it < self.at_step:
            return st
        self.fired = True
        if self.shard is not None:
            return _poison_one_replica(st, self.field, self.shard, self.rows,
                                       float("nan"))
        return _poison_rows(st, self.field, self.rows, float("nan"))


@dataclasses.dataclass
class IndexCorruption:
    """Poison an index table of the state entering the first chunk whose
    start step is ``>= at_step``: the first ``rows`` rows of ``field``
    (``hd_idx`` / ``ld_idx`` / ``rev_idx``) become ``n + 12345``, out of
    range but finite and below SENTINEL.  The finite-fraction and max-|Y|
    probes cannot see it; ``funcsne.audit_state`` can.  ``shard=s``
    confines the poison to rank ``s``'s replica (the audit's counts are
    reduced over the grid, so it still trips)."""
    at_step: int
    field: str = "hd_idx"
    rows: int = 8
    once: bool = True
    fired: bool = False
    shard: Optional[int] = None

    def apply(self, st, it: int):
        if (self.fired and self.once) or it < self.at_step:
            return st
        self.fired = True
        bad = st.active.shape[0] + 12345
        if self.shard is not None:
            return _poison_one_replica(st, self.field, self.shard, self.rows,
                                       bad)
        return _poison_rows(st, self.field, self.rows, bad)


@dataclasses.dataclass
class CorruptShard:
    """Damage the newest committed checkpoint on disk at the first chunk
    boundary ``>= at_step``, after the write in flight lands, as a torn
    write, a flipped bit or a lost file would.  ``shard`` indexes the
    sorted ``shard*-of-*.npz`` set (default -1: the last); a one-host
    checkpoint damages ``arrays.npz``.  ``damaged`` records the file hit."""
    at_step: int
    mode: str = "bitflip"       # "truncate" | "bitflip" | "delete"
    shard: int = -1
    once: bool = True
    fired: bool = False
    damaged: Optional[str] = None

    def check(self, it: int, ck):
        if ck is None or (self.fired and self.once) or it < self.at_step:
            return
        ck.wait()       # the write in flight commits first: this models
        #                 damage to a good checkpoint, not a crash mid-write
        #                 (the tmp-dir rename covers that)
        step = ck.latest_step()
        if step is None:
            return
        self.fired = True
        d = ck.dir / f"step_{step:010d}"
        files = sorted(d.glob("shard*-of-*.npz")) or [d / "arrays.npz"]
        target = files[self.shard % len(files)]
        if self.mode == "delete":
            target.unlink()
        elif self.mode == "truncate":
            blob = target.read_bytes()
            target.write_bytes(blob[:max(1, len(blob) // 2)])
        elif self.mode == "bitflip":
            blob = bytearray(target.read_bytes())
            blob[len(blob) // 2] ^= 0x01
            target.write_bytes(bytes(blob))
        else:
            raise ValueError(f"unknown CorruptShard mode {self.mode!r}")
        self.damaged = str(target)


@dataclasses.dataclass
class KernelLaunchFault:
    """Raise :class:`InjectedKernelFault` in place of the ``at_launch``-th
    guarded launch of ``family`` (see ``repro_torch.kernels.fallback``)."""
    family: str
    at_launch: int = 0
    once: bool = True
    fired: bool = False
    _count: int = 0

    def check(self, family: str):
        if family != self.family or (self.fired and self.once):
            return
        launch, self._count = self._count, self._count + 1
        if launch >= self.at_launch:
            self.fired = True
            raise InjectedKernelFault(
                f"injected launch failure: {self.family} "
                f"(launch {launch})")


@dataclasses.dataclass
class Preemption:
    """Raise :class:`Preempted` at the first chunk boundary ``>= at_step``,
    after the state advanced past the chunk, like a kill signal landing
    between chunks."""
    at_step: int
    once: bool = True
    fired: bool = False

    def check(self, it: int):
        if (self.fired and self.once) or it < self.at_step:
            return
        self.fired = True
        raise Preempted(it)


@dataclasses.dataclass
class ProcessKill:
    """SIGKILL this process at the first chunk boundary ``>= at_chunk``, iff
    it runs as pod ``pod``: the real death :class:`HostLoss` simulates.
    ``os.kill(getpid(), SIGKILL)`` on purpose: no atexit, no flush, no
    teardown, as ``kill -9`` of a worker.  Nothing in the process survives
    it; recovery is the supervisor's (``repro_torch.runtime.control``).
    Checked from the worker's ``on_boundary`` hook through
    :func:`maybe_process_kill`, after the boundary's checkpoint write was
    started, so the kill races a write in flight as a real signal would
    (generation-tagged shards make its leftovers harmless)."""
    at_chunk: int
    pod: int = 1
    once: bool = True
    fired: bool = False

    def check(self, it: int, pod: int):
        if pod != self.pod or (self.fired and self.once) \
                or it < self.at_chunk:
            return
        self.fired = True
        import os
        import signal
        os.kill(os.getpid(), signal.SIGKILL)


@dataclasses.dataclass
class HostLoss:
    """Raise :class:`HostLost` at the first chunk boundary ``>= at_step``:
    the simulated death of host ``host`` (its block of ranks).  Unlike
    :class:`Preemption` the process survives: the elastic loop catches it,
    drops the host's ranks, remeshes and resumes from the last committed
    checkpoint on the smaller grid."""
    at_step: int
    host: int = 1
    once: bool = True
    fired: bool = False

    def check(self, it: int):
        if (self.fired and self.once) or it < self.at_step:
            return
        self.fired = True
        raise HostLost(it, self.host)


class FaultScript:
    """An ordered bag of fault objects consulted by the runtime hooks."""

    def __init__(self, *faults):
        self.faults: List = list(faults)

    def corrupt_state(self, st, it: int):
        for f in self.faults:
            if isinstance(f, (NaNChunk, IndexCorruption)):
                st = f.apply(st, it)
        return st

    def maybe_preempt(self, it: int):
        for f in self.faults:
            if isinstance(f, Preemption):
                f.check(it)

    def maybe_corrupt_checkpoint(self, it: int, ck):
        for f in self.faults:
            if isinstance(f, CorruptShard):
                f.check(it, ck)

    def maybe_host_loss(self, it: int):
        for f in self.faults:
            if isinstance(f, HostLoss):
                f.check(it)

    def maybe_process_kill(self, it: int, pod: int):
        for f in self.faults:
            if isinstance(f, ProcessKill):
                f.check(it, pod)

    def check_kernel(self, family: str):
        for f in self.faults:
            if isinstance(f, KernelLaunchFault):
                f.check(family)


_ACTIVE: Optional[FaultScript] = None


@contextlib.contextmanager
def active(script: FaultScript):
    """Install ``script`` as the process-wide fault source."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, script
    try:
        yield script
    finally:
        _ACTIVE = prev


def current() -> Optional[FaultScript]:
    return _ACTIVE


# -- hooks the runtime calls (all no-ops when no script is active) ---------


def corrupt_state(st, it: int):
    return _ACTIVE.corrupt_state(st, it) if _ACTIVE is not None else st


def maybe_preempt(it: int):
    if _ACTIVE is not None:
        _ACTIVE.maybe_preempt(it)


def maybe_corrupt_checkpoint(it: int, ck):
    if _ACTIVE is not None and ck is not None:
        _ACTIVE.maybe_corrupt_checkpoint(it, ck)


def maybe_host_loss(it: int):
    if _ACTIVE is not None:
        _ACTIVE.maybe_host_loss(it)


def maybe_process_kill(it: int, pod: int):
    if _ACTIVE is not None:
        _ACTIVE.maybe_process_kill(it, pod)


def check_kernel(family: str):
    if _ACTIVE is not None:
        _ACTIVE.check_kernel(family)


# --------------------------------------------------------------------------
# Smoke scenarios (`python -m repro_torch.runtime.faults --smoke`)


def _smoke_setup(n=64, dim=6, seed=0):
    from repro_torch.core import funcsne
    from repro_torch.data.synthetic import blobs

    X, _ = blobs(n=n, dim=dim, n_centers=2, center_std=5.0, seed=seed)
    cfg = funcsne.FuncSNEConfig(n_points=n, dim_hd=dim, n_negatives=4)
    return X, cfg


def _equal_states(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def scenario_nan_rollback(device="cuda") -> dict:
    """Injected NaN chunk -> telemetry trip -> rollback + backoff ->
    finite final embedding."""
    from repro_torch.core import funcsne
    from repro_torch.core.resilience import ResiliencePolicy

    X, cfg = _smoke_setup()
    policy = ResiliencePolicy(max_retries=2)
    with active(FaultScript(NaNChunk(at_step=8))):
        st, _ = funcsne.fit(X, cfg=cfg, n_iter=16, chunk_size=4,
                            resilience=policy, device=device)
    assert bool(st.Y.isfinite().all()), "embedding not finite"
    kinds = [e["kind"] for e in policy.events]
    assert "rollback" in kinds, kinds
    assert int(st.step) == 16, int(st.step)
    return {"events": len(policy.events), "retries": kinds.count("rollback")}


def scenario_kernel_fallback(device="cuda") -> dict:
    """Injected launch failure.  On the CPU: sticky demotion to the plain
    version -> the run completes, bit-identical to a run with the family
    demoted beforehand.  On the card, where no plain version stands in
    for a kernel: the fault surfaces from ``fit`` as a ``kernel_fault``
    event, nothing is demoted, and ``fit(resume_from=)`` of its last
    checkpoint ends bit-identical to the uninterrupted run."""
    import shutil
    import tempfile
    import warnings

    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import funcsne
    from repro_torch.core.resilience import ResiliencePolicy
    from repro_torch.kernels import fallback

    X, cfg = _smoke_setup()
    fallback.reset()
    if torch.device(device).type != "cpu":
        # two knn_merge calls a step: launch 18 is in step 9, the third
        # chunk, after the boundaries at steps 4 and 8 are committed
        kw = dict(cfg=cfg, n_iter=12, chunk_size=4, device=device)
        tmp = tempfile.mkdtemp(prefix="faults-kernel-")
        try:
            policy = ResiliencePolicy(checkpoint_dir=tmp, checkpoint_every=1)
            try:
                with active(FaultScript(KernelLaunchFault("knn_merge",
                                                          at_launch=18))):
                    funcsne.fit(X, resilience=policy, **kw)
                raise AssertionError("the kernel fault did not surface")
            except InjectedKernelFault:
                pass
            assert fallback.demotions() == {}, fallback.demotions()
            kinds = [(e["kind"], e.get("family")) for e in policy.events]
            assert ("kernel_fault", "knn_merge") in kinds, kinds
            committed = Checkpointer(tmp).all_steps()
            assert committed == [4, 8], committed
            st_res, _ = funcsne.fit(X, resilience=ResiliencePolicy(),
                                    resume_from=tmp, **kw)
            st_ref, _ = funcsne.fit(X, **kw)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            fallback.reset()
        assert _equal_states(st_res, st_ref), "resumed run differs"
        return {"raised": ["knn_merge"], "resumed_at": committed[-1]}

    kw = dict(cfg=cfg, n_iter=8, chunk_size=4, device=device)
    with active(FaultScript(KernelLaunchFault("knn_merge"))):
        st_fault, _ = funcsne.fit(X, resilience=ResiliencePolicy(), **kw)
    assert "knn_merge" in fallback.demotions(), fallback.demotions()

    fallback.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        fallback.demote("knn_merge", "pre-demoted (smoke parity reference)")
    with fallback.enabled():
        st_ref, _ = funcsne.fit(X, resilience=ResiliencePolicy(), **kw)
    fallback.reset()
    assert _equal_states(st_fault, st_ref), "demoted runs differ"
    return {"demoted": ["knn_merge"]}


def scenario_preempt_resume(device="cuda", tmpdir=None) -> dict:
    """Kill between chunks, restore from disk: the resumed run is
    bit-identical to the uninterrupted one."""
    import shutil
    import tempfile

    from repro_torch.core import funcsne
    from repro_torch.core.resilience import ResiliencePolicy

    X, cfg = _smoke_setup()
    own = tmpdir is None
    if own:
        tmpdir = tempfile.mkdtemp(prefix="funcsne-faults-")
    kw = dict(cfg=cfg, n_iter=16, chunk_size=4, device=device)
    try:
        st_ref, _ = funcsne.fit(X, resilience=ResiliencePolicy(), **kw)
        policy = ResiliencePolicy(checkpoint_dir=tmpdir, checkpoint_every=1)
        try:
            with active(FaultScript(Preemption(at_step=8))):
                funcsne.fit(X, resilience=policy, **kw)
            raise AssertionError("preemption did not fire")
        except Preempted as e:
            killed_at = e.step
        st_res, _ = funcsne.fit(X, resilience=ResiliencePolicy(
            checkpoint_dir=tmpdir, checkpoint_every=1),
            resume_from=tmpdir, **kw)
        assert _equal_states(st_res, st_ref), "resumed run differs"
        assert int(st_res.step) == 16
    finally:
        if own:
            shutil.rmtree(tmpdir, ignore_errors=True)
    return {"killed_at": killed_at}


def scenario_corrupt_restore(device="cuda") -> dict:
    """Damage the newest committed checkpoint (truncate / bit flip /
    delete) right after it lands, then kill the run: the resume detects
    the damage, falls back to the previous verified boundary with a
    ``checkpoint_fallback`` event, and still reproduces the uninterrupted
    run bit for bit (chunk boundaries are bit-neutral, so replaying from
    one further back is exact)."""
    import shutil
    import tempfile

    from repro_torch.core import funcsne
    from repro_torch.core.resilience import ResiliencePolicy

    X, cfg = _smoke_setup()
    kw = dict(cfg=cfg, n_iter=16, chunk_size=4, device=device)
    st_ref, _ = funcsne.fit(X, resilience=ResiliencePolicy(), **kw)

    out = {}
    for mode in ("truncate", "bitflip", "delete"):
        tdir = tempfile.mkdtemp(prefix=f"funcsne-corrupt-{mode}-")
        try:
            fault = CorruptShard(at_step=8, mode=mode)
            try:
                with active(FaultScript(fault, Preemption(at_step=8))):
                    funcsne.fit(X, resilience=ResiliencePolicy(
                        checkpoint_dir=tdir, checkpoint_every=1), **kw)
                raise AssertionError("preemption did not fire")
            except Preempted:
                pass
            assert fault.damaged is not None, "CorruptShard never fired"
            policy = ResiliencePolicy(checkpoint_dir=tdir,
                                      checkpoint_every=1)
            st_res, _ = funcsne.fit(X, resilience=policy, resume_from=tdir,
                                    **kw)
            fbs = [e for e in policy.events
                   if e["kind"] == "checkpoint_fallback"]
            assert fbs and fbs[0]["step"] == 8, policy.events
            assert _equal_states(st_res, st_ref), "resumed run differs"
            assert int(st_res.step) == 16
            out[mode] = {"fell_back_from": fbs[0]["step"]}
        finally:
            shutil.rmtree(tdir, ignore_errors=True)
    return out


def scenario_index_audit(device="cuda") -> dict:
    """Poisoned ``hd_idx`` (out of range but finite, invisible to the NaN
    probes) trips the chunk-boundary audit and the rollback path, and the
    run ends with a clean state.  Positive control: with ``audit_every=0``
    the same fault survives to the end and fails an offline audit."""
    import torch

    from repro_torch.core import funcsne
    from repro_torch.core.resilience import ResiliencePolicy

    X, cfg = _smoke_setup()
    kw = dict(cfg=cfg, n_iter=16, chunk_size=4, device=device)
    Xt = torch.from_numpy(X).to(device)

    policy = ResiliencePolicy(max_retries=2, audit_every=1)
    with active(FaultScript(IndexCorruption(at_step=8, field="hd_idx"))):
        st, _ = funcsne.fit(X, resilience=policy, **kw)
    kinds = [e["kind"] for e in policy.events]
    assert "audit_violation" in kinds and "rollback" in kinds, kinds
    assert int(st.step) == 16, int(st.step)
    final = policy.audit_check(funcsne.audit_state(st, cfg, Xt))
    assert final is None, f"final state dirty after rollback: {final}"
    viol = next(e for e in policy.events if e["kind"] == "audit_violation")

    # positive control: with the audit off nothing notices, and the damage
    # survives to the end of the run
    ctrl = ResiliencePolicy(max_retries=2, audit_every=0)
    with active(FaultScript(IndexCorruption(at_step=8, field="hd_idx"))):
        st0, _ = funcsne.fit(X, resilience=ctrl, **kw)
    kinds0 = [e["kind"] for e in ctrl.events]
    assert "rollback" not in kinds0 and "audit_violation" not in kinds0, \
        kinds0
    missed = ctrl.audit_check(funcsne.audit_state(st0, cfg, Xt))
    assert missed is not None, \
        "control run: the corruption disappeared without an audit"
    return {"tripped": viol["reason"][:48], "control_missed": missed[:48]}


def _host_loss_rank(rank, world, dev, tmpdir):
    """One rank of :func:`scenario_host_loss`: an uninterrupted
    ``fit_elastic`` on two simulated hosts, then one whose host 1 is lost
    at step 8.  Rank 0 returns what the scenario checks; the rank lost
    with its host returns its events."""
    import torch

    from repro_torch.core.resilience import ResiliencePolicy
    from repro_torch.runtime.coordinator import fit_elastic

    X, cfg = _smoke_setup()
    X = torch.from_numpy(X)
    kw = dict(cfg=cfg, n_iter=16, chunk_size=4, n_hosts=2, device=dev)
    st_ref = fit_elastic(X, resilience=ResiliencePolicy(), **kw)
    policy = ResiliencePolicy(checkpoint_dir=tmpdir, checkpoint_every=1)
    with active(FaultScript(HostLoss(at_step=8, host=1))):
        st = fit_elastic(X, resilience=policy, **kw)
    if st is None:
        return {"events": policy.events}
    return {"events": policy.events, "step": int(st.step),
            "finite": bool(st.Y.isfinite().all()),
            "ref_std": float(st_ref.Y.std()), "std": float(st.Y.std())}


def scenario_host_loss(device="cuda", tmpdir=None) -> dict:
    """One simulated host (rank 1 of two ``launch.mesh.run_ranks`` ranks,
    gloo) dies mid-run; the elastic loop quiesces, remeshes over the
    survivor and resumes from the last committed chunk boundary.  The run
    finishes every iteration on the smaller grid with an embedding whose
    spread matches the uninterrupted run's (bitwise parity is not expected:
    the smaller grid regroups the force sum)."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import run_ranks

    own = tmpdir is None
    if own:
        tmpdir = tempfile.mkdtemp(prefix="funcsne-hostloss-")
    try:
        got, lost = run_ranks(_host_loss_rank, 2, (tmpdir,), device=device,
                              timeout=300.0)
    finally:
        if own:
            shutil.rmtree(tmpdir, ignore_errors=True)
    assert got["step"] == 16, got["step"]
    assert got["finite"], "embedding not finite after remesh"
    kinds = [e["kind"] for e in got["events"]]
    assert "host_lost" in kinds and "remesh" in kinds, kinds
    assert [e["kind"] for e in lost["events"]] == ["host_lost", "rank_idle"]
    # the layout kept optimising after the remesh instead of resetting or
    # freezing: its spread is within 2x of the uninterrupted run's
    ref, std = got["ref_std"], got["std"]
    assert 0.5 * ref <= std <= 2.0 * ref, (ref, std)
    return {"host_lost": 1, "resumed_at": next(
        e["step"] for e in got["events"] if e["kind"] == "remesh"),
        "spread_ratio": round(std / max(ref, 1e-9), 3)}


def check_process_kill(sup, report: dict, n_iter: int) -> dict:
    """Every assertion of :func:`scenario_process_kill` on a finished
    supervised run (``sup.run()``'s ``report``) in which pod 1 of two was
    killed: the result, the generations, the committed steps, the trail's
    causal order, no orphaned pid, no stale-generation shard.  Returns the
    relaunched generation's ``restore`` event."""
    import errno
    import json as _json
    import os

    from repro_torch.runtime import control

    # the survivor finished every iteration and committed the boundary
    assert report["result"]["step"] == n_iter, report["result"]
    assert report["result"]["finite"], report["result"]
    assert report["generations"] == 2, report["generations"]
    steps = control.committed_steps(sup.ckpt_dir)
    assert steps and steps[-1] == n_iter, steps

    # the trail, in causal order:
    # heartbeat_lost -> generation_killed -> remesh -> restore
    kinds = [e["kind"] for e in report["trail"]]
    order = [kinds.index(k) for k in
             ("heartbeat_lost", "generation_killed", "remesh",
              "restore")]
    assert order == sorted(order), kinds
    lost = next(e for e in report["trail"]
                if e["kind"] == "heartbeat_lost")
    assert lost["pod"] == 1, lost
    rem = next(e for e in report["trail"] if e["kind"] == "remesh")
    assert rem["survivors"] == [0] and rem["n_processes"] == 1, rem
    restore = next(e for e in report["trail"]
                   if e["kind"] == "restore")
    assert restore["generation"] == 1, restore
    assert 0 < restore["step"] < n_iter, restore

    # no orphaned process: every pid the supervisor spawned is gone
    # (the supervisor waits for every worker it kills)
    for pid in report["pids"]:
        try:
            os.kill(pid, 0)
            raise AssertionError(f"orphaned worker pid {pid}")
        except OSError as e:
            assert e.errno == errno.ESRCH, e

    # no stale-generation shard: every committed step holds only the
    # files its own manifest names, and the final boundary belongs to
    # the surviving generation
    for s in steps:
        d = sup.ckpt_dir / f"step_{s:010d}"
        meta = _json.loads((d / "meta.json").read_text())
        want = set(meta["manifest"]["files"])
        have = {p.name for p in d.glob("*.npz")}
        assert have == want, (s, have, want)
        gen = meta.get("generation")
        tag = f"-g{gen:06d}.npz"
        assert all(f.endswith(tag) for f in want), (s, gen, want)
    final_meta = _json.loads(
        (sup.ckpt_dir / f"step_{steps[-1]:010d}" / "meta.json")
        .read_text())
    assert final_meta.get("generation") == 1, final_meta
    return restore


def scenario_process_kill(device="cuda", tmpdir=None) -> dict:
    """The real death: a pod of two worker processes (a gloo process group
    under ``runtime.control``'s supervisor), one SIGKILLs itself mid-run,
    and the supervisor finishes the embedding anyway: heartbeat loss
    detected, the generation killed, a remesh over the survivor, resume
    from the last committed generation-tagged boundary.  Asserts the event
    trail, the final committed step, no orphaned worker process and no
    stale-generation shard on disk."""
    import os

    if os.environ.get("FUNCSNE_NO_MULTIPROCESS") == "1":
        return {"skipped": "FUNCSNE_NO_MULTIPROCESS=1"}

    from repro_torch.runtime import control

    if not control.gloo_available():
        return {"skipped": "no gloo collectives in this torch"}

    import shutil
    import tempfile

    own = tmpdir is None
    if own:
        tmpdir = tempfile.mkdtemp(prefix="funcsne-prockill-")
    n_iter, chunk = 16, 4
    try:
        sup = control.Supervisor(
            tmpdir, n_pods=2, n_iter=n_iter, chunk_size=chunk, n=64, dim=6,
            device=device, kill_pod=1, kill_at_chunk=8,
            heartbeat_timeout=20.0, total_timeout=480.0)
        report = sup.run()
        restore = check_process_kill(sup, report, n_iter)
    finally:
        if own:
            shutil.rmtree(tmpdir, ignore_errors=True)
    return {"resumed_at": restore["step"],
            "final_step": report["result"]["step"],
            "generations": report["generations"]}


SCENARIOS = {
    "nan_rollback": scenario_nan_rollback,
    "kernel_fallback": scenario_kernel_fallback,
    "preempt_resume": scenario_preempt_resume,
    "host_loss": scenario_host_loss,
    "corrupt_restore": scenario_corrupt_restore,
    "index_audit": scenario_index_audit,
    "process_kill": scenario_process_kill,
}


def main(argv=None) -> int:
    import argparse
    import time

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.faults", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="run the recovery scenarios on tiny data")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--only", default=None,
                    help="comma-separated scenario names")
    ap.add_argument("--no-skip", action="store_true",
                    help="fail any scenario that reports itself skipped")
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.print_help()
        return 0
    names = list(SCENARIOS)
    if args.only:
        names = [n for n in names if n in args.only.split(",")]
    failed = 0
    for name in names:
        t0 = time.time()
        try:
            info = SCENARIOS[name](device=args.device)
            if isinstance(info, dict) and "skipped" in info:
                if args.no_skip:
                    failed += 1
                    print(f"[faults] {name}: FAILED: required scenario "
                          f"skipped: {info['skipped']}", flush=True)
                else:
                    print(f"[faults] {name}: skipped: {info['skipped']}",
                          flush=True)
                continue
            print(f"[faults] {name}: OK in {time.time() - t0:.1f}s {info}",
                  flush=True)
        except Exception as e:
            failed += 1
            print(f"[faults] {name}: FAILED: {e!r}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    # re-dispatch through the canonical import, so that the scenarios share
    # the one _ACTIVE cell fit consults (`python -m` loads this file as
    # `__main__`, a second module object)
    from repro_torch.runtime import faults as _canonical
    raise SystemExit(_canonical.main())
