"""Elastic coordinator of the resilient embedding runtime (port of
``repro.runtime.coordinator``).

:func:`fit_elastic` is ``funcsne.fit``'s rollback / checkpoint loop on the
distributed step: every rank of the grid runs it, SPMD, on its replica of
the state, and every host decision must come out the same on every rank,
or the next collective waits forever:

  * the health telemetry is reduced over the grid inside the chunk runner
    (``health_reduce``), so one bad replica trips every rank's rollback;
  * the audit's counts are reduced over the grid (max; the count of
    non-finite X entries is summed over the column blocks first);
  * the straggler alarm is decided by one rank's clock, so it only logs
    (the reference's multi-process mode): no rank commits an early
    checkpoint on its own;
  * checkpoints are written per host (``Checkpointer.save(
    host_shard_filter=...)``), so their I/O scales with the pod, and every
    rank restores on ``resume_from`` (after a barrier, so no rank reads
    before the last write landed).

A host is what the reference calls one, in its two modes:

  * **simulated pod** (the ranks of one ``launch.mesh.run_ranks`` group,
    standing in for the devices of one JAX process): ``n_hosts`` splits
    the ranks into contiguous blocks, the first rank of each block writes
    its host's row shard, and a host loss is an injected
    ``faults.HostLost``: the survivors quiesce (every write in flight
    lands), ``elastic.remesh`` builds the grid over the ranks left, the
    last committed boundary is restored onto it and the schedule replays
    from its step (the lost ranks return None);
  * **real pod** (a process group started by ``runtime.control`` or
    ``launch.embed --num-processes``): every process writes its own
    generation-tagged row shard (``generation`` defaults to 0), and
    liveness goes through the ``on_boundary`` hook.  A process death is
    not handled here: the supervisor kills the whole generation and
    relaunches it over the survivors, which re-enter this function with
    ``resume_from`` at the last committed boundary.

Chunk boundaries are bit-neutral, so no iteration is lost or repeated
across a remesh; the replayed steps differ from an uninterrupted run only
by the smaller grid's grouping of the collective sums.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer, cfg_compat, row_shard_filter
from repro_torch.core import funcsne
from repro_torch.core.resilience import EmbeddingDiverged
from repro_torch.kernels import fallback
from repro_torch.launch.mesh import host_device_blocks, simulated_pod
from repro_torch.runtime import elastic, faults
from repro_torch.runtime.straggler import StepTimeMonitor

_ALL = ("data", "model")


def audit_on_grid(st, cfg, Xb, grid) -> "funcsne.AuditResult":
    """:func:`funcsne.audit_state` with the counts reduced over the grid:
    non-finite entries of X summed over the column blocks (``Xb`` is this
    rank's), then every count maxed over the ranks, so a violation in one
    replica shows on all of them."""
    aud = funcsne.audit_state(st, cfg)
    x_bad = (~torch.isfinite(Xb) & st.active[:, None]).sum(dtype=torch.int32)
    aud = aud._replace(x_nonfinite=grid.all_reduce(x_bad, "model", "sum",
                                                   tag="audit"))
    counts = grid.all_reduce(torch.stack(list(aud)), _ALL, "max",
                             tag="audit")
    return funcsne.AuditResult(*counts.unbind())


def fit_elastic(X, *, cfg: "funcsne.FuncSNEConfig" = None,
                n_iter: int = 750, chunk_size: int = None, seed: int = 0,
                hparams: "funcsne.HParams" = None,
                schedule: Callable = None, init: str = "pca",
                n_hosts: int = 1, model: int = 1,
                devices: Optional[int] = None, resilience=None, state=None,
                resume_from=None,
                on_boundary: Optional[Callable[[int], None]] = None,
                generation: Optional[int] = None, device="cuda"):
    """``funcsne.fit``'s rollback / checkpoint loop on the distributed step,
    with elastic resume across a simulated host loss; returns this rank's
    replica of the final state (None on a rank left out of the grid, or
    lost with its host).

    Called on every rank of the process group (``launch.mesh.run_ranks``,
    or a real pod; without one, as a grid of one rank) with the whole
    ``X``.  ``devices`` is the number of ranks to use (default: all of
    them) and ``model`` the requested model width: the grid is whatever
    :func:`repro_torch.runtime.elastic.remesh` finds feasible for the rank
    count and ``cfg.dim_hd`` (X is split by columns over the model axis),
    a ``devices_dropped`` event when ranks are left out.  Each rank starts
    from ``state`` or ``init_state(X, cfg, seed=seed)``, computed on every
    rank alike.

    ``n_hosts`` splits the ranks into contiguous blocks, the simulated
    pod: every rank of the world must then take part (``devices`` all of
    them), since the remesh after a loss builds its groups on every rank.
    A :class:`~repro_torch.runtime.faults.HostLost` raised at a chunk
    boundary is survived only when ``resilience.checkpoint_dir`` is set
    and a boundary is committed; otherwise it propagates.  In a real pod
    (a process group not started by ``run_ranks``) the process set is the
    pod: ``n_hosts`` stays 1, every process writes its own row shard, and
    ``generation`` defaults to 0.  A ``generation`` tags the shard files
    (``shard<h>-of-<H>-g<G>.npz``, one host included).

    ``resilience`` (a :class:`~repro_torch.core.resilience.ResiliencePolicy`)
    arms rollback with backoff, ``EmbeddingDiverged``, checkpoints every
    ``checkpoint_every`` healthy chunks, the audit every ``audit_every``
    and the straggler watchdog (logged only); ``resume_from`` restores the
    newest boundary that verifies on every rank.  ``on_boundary(it)`` is
    called at entry and after every chunk boundary, retries included (a
    liveness hook; cheap, must not raise).
    """
    dev = funcsne.resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32).to(dev).contiguous()
    if cfg is None:
        cfg = funcsne.FuncSNEConfig(n_points=X.shape[0], dim_hd=X.shape[1])
    if hparams is None:
        hparams = funcsne.default_hparams(cfg.n_points, device=dev)
    if schedule is None:
        schedule = funcsne.default_schedule
    if chunk_size is None:
        chunk_size = min(50, max(1, n_iter))
    on = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if on else 1
    me = dist.get_rank() if on else 0
    n_ranks = world if devices is None else int(devices)
    if not 1 <= n_ranks <= world:
        raise ValueError(f"devices={devices} for a world of {world} ranks")
    if not 1 <= n_hosts <= n_ranks:
        raise ValueError(f"n_hosts={n_hosts} for {n_ranks} devices")
    multiprocess = world > 1 and not simulated_pod()
    if multiprocess:
        if n_hosts != 1:
            raise ValueError(
                "n_hosts simulates pods on the ranks of run_ranks; in a "
                "real pod the process set IS the pod (n_hosts=1)")
        if generation is None:
            generation = 0
    if n_hosts > 1 and n_ranks < world:
        raise ValueError(
            f"n_hosts={n_hosts} needs every rank of the world in the grid "
            f"(devices={n_ranks} of {world}): a remesh after a host loss "
            "builds its groups on every rank")
    beat = on_boundary if on_boundary is not None else (lambda _it: None)

    policy = resilience
    log = policy.log if policy is not None else (lambda *a, **k: None)
    on_grid_event = (lambda e: policy.log(**e)) if policy is not None \
        else None

    def build(ranks):
        """The grid over ``ranks`` (every rank of the world calls this),
        or None on a rank left out of it, after its ``rank_idle`` event."""
        grid = elastic.remesh(len(ranks), model=model, ranks=ranks,
                              divides=(cfg.dim_hd,), on_event=on_grid_event)
        if not grid.member:
            log("rank_idle", rank=me, mesh=dict(grid.shape))
            warnings.warn(f"[elastic] rank {me} is outside the {grid.shape} "
                          "grid: it takes no step", RuntimeWarning)
            return None
        return grid

    ranks = list(range(n_ranks))
    grid = build(ranks)
    if grid is None:
        return None
    Xb = grid.column_block(X)
    ck = monitor = None
    if policy is not None:
        if policy.checkpoint_dir is not None:
            ck = Checkpointer(policy.checkpoint_dir,
                              keep_last=policy.keep_last)
        monitor = StepTimeMonitor(z_thresh=policy.straggler_z,
                                  hang_timeout=policy.hang_timeout,
                                  warmup_steps=policy.straggler_warmup)
    st = state if state is not None else funcsne.init_state(
        X, cfg, seed=seed, init=init, perplexity=hparams.perplexity,
        validate=False, device=dev)

    def restore_chain(rck):
        """The newest boundary of ``rck`` that verifies, onto this rank's
        device, with one ``checkpoint_fallback`` event per damaged
        boundary skipped."""
        tree, meta, fbs = rck.restore_verified(
            st, expect_compat=cfg_compat(cfg))
        for fb in fbs:
            log("checkpoint_fallback", **fb)
        return tree, meta

    start_it = 0
    lr_scale = ex_scale = 1.0
    if resume_from is not None:
        grid.barrier()      # a write still landing on another rank
        rck = ck if (ck is not None
                     and str(ck.dir) == str(resume_from)) else \
            Checkpointer(resume_from)
        st, meta = restore_chain(rck)
        start_it = int(meta["step"])
        lr_scale = float(meta.get("lr_scale", 1.0))
        ex_scale = float(meta.get("ex_scale", 1.0))
        log("restore", step=start_it, source=str(resume_from),
            from_generation=meta.get("generation"))

    def save_all_hosts(it, st):
        """This rank's part of the boundary ``it``: in a real pod every
        process its own row shard; with simulated hosts the first rank of
        each host block its host's; with one host the grid's first rank
        the whole tree.  The writer completing the set commits."""
        if ck is None:
            return
        if multiprocess:
            host, hosts = grid.axis_index(_ALL), grid.size
        else:
            host = next((h for h, b in enumerate(
                host_device_blocks(ranks, n_hosts)) if b[0] == me), None)
            hosts = n_hosts
            if host is None:
                return
        meta = {"lr_scale": lr_scale, "ex_scale": ex_scale,
                "compat": cfg_compat(cfg)}
        tree = funcsne._checkpoint_state(st)
        if hosts == 1:
            ck.save(it, tree, metadata=meta, generation=generation)
        else:
            ck.save(it, tree, metadata=meta,
                    host_shard_filter=row_shard_filter(host, hosts,
                                                       cfg.n_points),
                    host_id=host, n_hosts=hosts, generation=generation)

    chunks = {}         # T -> the chunk runner on the current grid
    it = start_it
    retries = 0
    n_healthy = 0
    fb_seen = fallback.n_events()
    guard = fallback.enabled(policy.sticky_fallback) \
        if policy is not None else contextlib.nullcontext()
    with contextlib.ExitStack() as stack:
        stack.enter_context(guard)
        if ck is not None:
            stack.callback(ck.close)    # the write in flight lands on exit
        beat(it)
        while it < n_iter:
            T = min(chunk_size, n_iter - it)
            if T not in chunks:
                chunks[T], _ = funcsne.make_distributed_step(
                    cfg, grid, chunk=T, schedule=schedule, n_iter=n_iter,
                    health_metrics=policy is not None)
            hp_run = funcsne._scaled_hp(hparams, lr_scale, ex_scale)
            if policy is not None or faults.current() is not None:
                # `st` is the rollback anchor; a scripted fault poisons
                # the copy the chunk runs on
                st_in = faults.corrupt_state(funcsne._copy_state(st), it)
            else:
                st_in = st
            t0 = time.perf_counter()
            st_out, _, metrics = chunks[T](st_in, Xb, hp_run)
            if policy is not None:
                m = funcsne._read_host(metrics)   # reduced over the grid
                alarm = monitor.observe(time.perf_counter() - t0)
                if alarm is not None:
                    # one rank's clock: logged, never acted on alone
                    log("straggler", step=it, alarm=alarm)
                for e in fallback.events(fb_seen):
                    log(**e)
                fb_seen = fallback.n_events()
                reason = policy.check(m)
                if reason is None and policy.audit_every \
                        and (n_healthy + 1) % policy.audit_every == 0:
                    reason = policy.audit_check(funcsne._read_host(
                        audit_on_grid(st_out, cfg, Xb, grid)))
                    if reason is not None:
                        log("audit_violation", step=it, reason=reason)
                if reason is not None:
                    if retries >= policy.max_retries:
                        log("giving_up", step=it, reason=reason,
                            retries=retries)
                        raise EmbeddingDiverged(it, reason, retries,
                                                policy.events)
                    retries += 1
                    lr_scale *= policy.lr_backoff
                    ex_scale *= policy.exaggeration_backoff
                    log("rollback", step=it, reason=reason, retry=retries,
                        lr_scale=lr_scale, ex_scale=ex_scale)
                    beat(it)    # a run of retries is alive
                    continue
                retries = 0
            st = st_out
            it += T
            if policy is not None:
                n_healthy += 1
                if n_healthy % policy.checkpoint_every == 0:
                    save_all_hosts(it, st)
            beat(it)
            # one rank damages the committed boundary
            faults.maybe_corrupt_checkpoint(
                it, ck if grid.axis_index(_ALL) == 0 else None)
            faults.maybe_preempt(it)
            try:
                faults.maybe_host_loss(it)
            except faults.HostLost as e:
                # quiesce: every write in flight lands, on every rank, so
                # the directory every rank reads next is the same
                if ck is not None:
                    ck.wait()
                grid.barrier()
                if ck is None or ck.latest_step() is None:
                    raise   # nothing committed: the run is not resumable
                log("host_lost", step=e.step, host=e.host)
                lost = host_device_blocks(ranks, n_hosts)[e.host % n_hosts]
                ranks = [r for r in ranks if r not in lost]
                n_hosts = max(1, n_hosts - 1)
                grid = build(ranks)
                if grid is None:
                    return None     # this rank went with its host
                Xb = grid.column_block(X)
                chunks.clear()      # the runners hold the old grid
                # the fallback chain: the newest boundary may be one the
                # lost host's write tore
                st, meta = restore_chain(ck)
                it = int(meta["step"])
                lr_scale = float(meta.get("lr_scale", 1.0))
                ex_scale = float(meta.get("ex_scale", 1.0))
                retries = 0
                log("remesh", step=it, host_lost=e.host,
                    n_devices=len(ranks), n_hosts=n_hosts,
                    mesh=dict(grid.shape))
        if ck is not None:
            ck.wait()   # an async write failure surfaces before returning
    return st
