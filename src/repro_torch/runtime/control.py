"""Multi-process elastic control plane: a supervisor and disposable
workers (port of ``repro.runtime.control``).

``runtime.coordinator.fit_elastic`` survives a simulated host loss among
the ranks of one group.  This module makes the real thing survivable -- a
worker process SIGKILLed mid-run -- by splitting the runtime in two:

  **supervisor** (:class:`Supervisor`; long-lived): spawns the workers,
  watches their liveness, and on a failure kills the whole generation and
  relaunches it over the survivors.  It imports neither torch nor anything
  that does (``runtime.elastic``'s liveness is pure Python), so it never
  initialises CUDA or a process group, and nothing about a generation's
  death can wedge it;

  **workers** (one a pod; disposable, one *generation* at a time): each
  joins a ``torch.distributed`` process group (``init_process_group`` over
  ``tcp://<coordinator>``, the backend of ``launch.mesh.pick_backend``:
  NCCL where every worker has a card of its own, gloo on the CPU or where
  workers share a card) and runs ``fit_elastic``.  A process group cannot
  be re-formed in-process after a peer dies, so recovery is always: kill
  the generation, relaunch, with a fresh coordinator port each generation
  (``base + generation``) so that a socket of the dead generation never
  collides.  A worker whose collective fails because a peer died (gloo
  fails it at once, where the reference's survivors stay blocked in it)
  logs ``collective_failed`` and blocks until the supervisor kills it, so
  it counts as a survivor, as in the reference; after
  ``launch.mesh.COLLECTIVE_TIMEOUT_S`` it raises, so a worker whose
  supervisor is gone ends on its own.

Liveness is the observer-stamped beat-counter contract of
``runtime.elastic``: each worker bumps a counter in its per-pod heartbeat
file at every chunk boundary (``fit_elastic(on_boundary=)``); the
supervisor stamps counter changes with its own ``time.monotonic()`` and
feeds the records to ``elastic.surviving_pods``.  A worker that exits
abnormally is the fast path of the same signal (its counter can never
change again): ``heartbeat_lost`` with ``via="process_exit"``.

On a detected death the supervisor:

  1. logs ``heartbeat_lost`` for every dead or stale pod and takes the
     survivors (fresh and alive at detection time);
  2. SIGKILLs and reaps every remaining worker of the generation
     (``generation_killed``);
  3. re-forms the pod over the survivors (``remesh``) and relaunches a new
     generation on a fresh port; the workers restore the last committed
     chunk boundary (``restore_verified``).  Checkpoint shards are
     generation-tagged (``shardNNN-of-MMM-gGGGGGG.npz``), so what the dead
     generation left half-staged is evicted by the new generation's
     completing writer instead of merging into a boundary.

Every control-plane event, and through ``ResiliencePolicy.on_event`` every
worker runtime event, is appended as one JSON line to
``<workdir>/events.jsonl``: the trail ``heartbeat_lost ->
generation_killed -> remesh -> restore`` the ``process_kill`` scenario
asserts.  Each event carries ``t``, the ``time.monotonic()`` of the process
that logged it (one clock on one machine, so a trail's costs can be read
off it; liveness itself never compares clocks).  Besides the reference's
events the trail has ``pod_started`` (a pod's first beat past the resume
boundary, where the startup grace hands over to the heartbeat timeout),
``process_kill`` (a worker about to SIGKILL itself) and
``worker_failed`` / ``collective_failed``.

CLI::

    # supervised 2-process run (the supervisor spawns the workers)
    PYTHONPATH=src python -m repro_torch.runtime.control \\
        --workdir /tmp/run --pods 2 --device cpu --n-iter 200 --chunk-size 25

    # one worker (spawned by the supervisor, not by hand)
    PYTHONPATH=src python -m repro_torch.runtime.control --worker \\
        --workdir /tmp/run --pod 0 --process-id 0 --num-processes 2 \\
        --coordinator 127.0.0.1:29618 --generation 0 ...

Workers run on the card (``--device cuda``, the default) and raise without
one unless given ``--device cpu``.  ``python -m repro_torch.launch.embed
--num-processes N --process-id I --coordinator H:P`` is the manual launch
(no supervisor) of the same worker loop.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.runtime import elastic

DEFAULT_BASE_PORT = 29618


class SupervisorError(RuntimeError):
    """The control plane gave up: no survivors, nothing committed to resume
    from, the generation budget spent, or the total deadline passed.
    Carries the structured event trail."""

    def __init__(self, reason: str, events: List[dict]):
        super().__init__(reason)
        self.reason = reason
        self.events = events


def gloo_available() -> bool:
    """True when this torch has gloo collectives (the CPU transport, and
    the one for workers sharing a card).  Imports torch lazily: the
    supervisor itself stays free of it."""
    try:
        import torch.distributed as dist
        return dist.is_available() and dist.is_gloo_available()
    except Exception:
        return False


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _append_event(path: Path, event: dict) -> None:
    # one line an event, one write: concurrent appends from the supervisor
    # and every worker interleave whole lines on Linux
    with open(path, "a") as f:
        f.write(json.dumps(event) + "\n")


def _read_events(path: Path) -> List[dict]:
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:      # a torn tail line of a killed writer
            continue
    return out


def _write_json_atomic(path: Path, obj: dict) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


def committed_steps(ckpt_dir: Path) -> List[int]:
    """Committed boundary steps, oldest first: a directory listing (the
    supervisor's torch-free stand-in for ``Checkpointer.all_steps``)."""
    return sorted(int(p.name.split("_")[1])
                  for p in Path(ckpt_dir).glob("step_*")
                  if (p / "meta.json").exists())


# --------------------------------------------------------------------------
# Worker side


def _beat_writer(hb_dir: Path, pod: int, generation: int):
    """Returns ``beat(it)``: atomically publish one heartbeat tick.

    The counter is worker-local and monotone within the generation; the
    observer treats ``(generation, counter)`` as an opaque value and stamps
    changes with its own clock, so the absolute numbers (and this process's
    clock, which is never written) do not matter."""
    path = hb_dir / f"pod{pod}.beat"
    state = {"k": 0}

    def beat(it: int) -> None:
        state["k"] += 1
        _write_json_atomic(path, {
            "pod": pod, "generation": generation,
            "counter": state["k"], "step": int(it)})
    return beat


def _peer_failure(e: BaseException) -> bool:
    """Whether ``e`` is a collective that failed (a peer died, a transport
    error), as gloo and NCCL raise it."""
    import torch.distributed as dist
    if isinstance(e, getattr(dist, "DistError", ())):
        return True
    msg = str(e)
    return isinstance(e, RuntimeError) and any(
        s in msg for s in ("gloo", "NCCL", "Connection"))


def worker_main(args) -> int:
    """One disposable worker: join the process group, then ``fit_elastic``
    with heartbeats, generation-tagged checkpoint shards, and resume from
    the last committed boundary when one exists."""
    workdir = Path(args.workdir)
    hb_dir = workdir / "hb"
    ckpt_dir = workdir / "ckpt"
    events_path = workdir / "events.jsonl"
    for d in (hb_dir, ckpt_dir):
        d.mkdir(parents=True, exist_ok=True)

    def log_event(event: dict) -> None:
        _append_event(events_path, {
            **event, "src": "worker", "pod": args.pod,
            "generation": args.generation, "pid": os.getpid(),
            "t": time.monotonic()})

    beat = _beat_writer(hb_dir, args.pod, args.generation)
    beat(-1)            # publish before the runtime starts: the file exists
    #                     and the first counter change marks progress
    try:
        return _worker_run(args, ckpt_dir, workdir, beat, log_event)
    except Exception as e:
        log_event({"kind": "worker_failed", "error": repr(e)[:500]})
        raise


def _worker_run(args, ckpt_dir, workdir, beat, log_event) -> int:
    import contextlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import funcsne
    from repro_torch.core.resilience import ResiliencePolicy
    from repro_torch.data.synthetic import blobs
    from repro_torch.launch.mesh import COLLECTIVE_TIMEOUT_S, join_group
    from repro_torch.runtime import faults
    from repro_torch.runtime.coordinator import fit_elastic

    dev = funcsne.resolve_device(args.device)   # the card, or raises
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // args.num_processes))
    rdev = join_group(dev, args.num_processes, args.process_id,
                      f"tcp://{args.coordinator}")
    log_event({"kind": "worker_start", "process_id": args.process_id,
               "num_processes": args.num_processes,
               "coordinator": args.coordinator,
               "devices": dist.get_world_size(),
               "backend": dist.get_backend(), "device": str(rdev)})

    X, _ = blobs(n=args.n, dim=args.dim, n_centers=2, center_std=5.0,
                 seed=args.seed)
    Xt = torch.from_numpy(X).to(rdev)
    cfg = funcsne.FuncSNEConfig(n_points=args.n, dim_hd=args.dim,
                                n_negatives=4)
    policy = ResiliencePolicy(checkpoint_dir=str(ckpt_dir),
                              checkpoint_every=1, keep_last=args.keep_last,
                              on_event=log_event)
    resume = ckpt_dir if committed_steps(ckpt_dir) else None
    kill = None
    if args.kill_pod is not None:
        kill = faults.ProcessKill(at_chunk=args.kill_at_chunk,
                                  pod=args.kill_pod)

    def on_boundary(it: int) -> None:
        beat(it)
        if kill is not None and not kill.fired and args.pod == kill.pod \
                and it >= kill.at_chunk:
            log_event({"kind": "process_kill", "step": int(it)})
        faults.maybe_process_kill(it, args.pod)

    kernels.reset_launches()
    try:
        with (faults.active(faults.FaultScript(kill)) if kill is not None
              else contextlib.nullcontext()):
            st = fit_elastic(Xt, cfg=cfg, n_iter=args.n_iter,
                             chunk_size=args.chunk_size, model=args.model,
                             resilience=policy, resume_from=resume,
                             on_boundary=on_boundary,
                             generation=args.generation, device=rdev)
    except Exception as e:
        if args.num_processes > 1 and _peer_failure(e):
            # a peer died: stay blocked, as the reference's survivors do in
            # their collective, until the supervisor kills the generation;
            # a worker whose supervisor is gone raises after the collective
            # bound, as the reference's collective times out
            log_event({"kind": "collective_failed", "error": repr(e)[:500]})
            time.sleep(COLLECTIVE_TIMEOUT_S)
        raise
    Y = st.Y.cpu().numpy()
    final = {"step": int(st.step), "n_iter": args.n_iter,
             "generation": args.generation,
             "finite": bool(np.isfinite(Y).all()),
             "y_std": float(Y.std())}
    log_event({"kind": "worker_done", **final, "launches": {
        k: v for k, v in kernels.LAUNCHES.items() if v}})
    if args.process_id == 0:
        _write_json_atomic(workdir / "result.json", final)
    dist.destroy_process_group()
    return 0


# --------------------------------------------------------------------------
# Supervisor side


@dataclasses.dataclass
class _Worker:
    pod: int
    proc: subprocess.Popen
    log_path: Path


class Supervisor:
    """Spawns and watches worker generations (see the module docstring).

    ``heartbeat_timeout`` is the steady-state staleness bound; it takes
    over from ``startup_grace`` only once a pod publishes a beat from past
    the resume boundary, after the worker's start and its first chunk (the
    kernels' build and load), the slow part every relaunch repeats.  (Stale
    beat files are swept before each generation starts, so leftover
    counters never fake that progress.)  A pod whose beat file never
    appears is judged against ``startup_grace`` from the generation's
    spawn.  ``kill_pod`` / ``kill_at_chunk`` arm the deterministic
    :class:`repro_torch.runtime.faults.ProcessKill` in generation 0 only:
    the hook for a real SIGKILL mid-run.  Workers run on ``device``
    (``cuda``, the default, raises in them without a card).
    """

    def __init__(self, workdir, *, n_pods: int = 2, n_iter: int = 16,
                 chunk_size: int = 4, n: int = 64, dim: int = 6,
                 seed: int = 0, device: str = "cuda",
                 model: int = 1, keep_last: int = 3,
                 base_port: Optional[int] = None,
                 heartbeat_timeout: float = 15.0,
                 startup_grace: float = 300.0,
                 poll_interval: float = 0.1,
                 max_generations: Optional[int] = None,
                 total_timeout: Optional[float] = None,
                 kill_pod: Optional[int] = None,
                 kill_at_chunk: Optional[int] = None,
                 extra_env: Optional[Dict[str, str]] = None,
                 echo: bool = False):
        self.workdir = Path(workdir)
        self.hb_dir = self.workdir / "hb"
        self.ckpt_dir = self.workdir / "ckpt"
        self.log_dir = self.workdir / "logs"
        self.events_path = self.workdir / "events.jsonl"
        for d in (self.hb_dir, self.ckpt_dir, self.log_dir):
            d.mkdir(parents=True, exist_ok=True)
        self.n_pods = int(n_pods)
        self.n_iter = int(n_iter)
        self.chunk_size = int(chunk_size)
        self.n, self.dim, self.seed = int(n), int(dim), int(seed)
        self.device, self.model = str(device), int(model)
        self.keep_last = int(keep_last)
        self.base_port = _free_port() if base_port is None \
            else int(base_port)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.startup_grace = float(startup_grace)
        self.poll_interval = float(poll_interval)
        self.max_generations = (self.n_pods + 1 if max_generations is None
                                else int(max_generations))
        self.total_timeout = total_timeout
        self.kill_pod, self.kill_at_chunk = kill_pod, kill_at_chunk
        self.extra_env = dict(extra_env or {})
        self.echo = echo
        self.events: List[dict] = []
        self.all_pids: List[int] = []
        self._live: List[_Worker] = []

    # -- telemetry --------------------------------------------------------

    def log(self, kind: str, **info) -> dict:
        event = {"kind": kind, **info, "src": "supervisor",
                 "t": time.monotonic()}
        self.events.append(event)
        _append_event(self.events_path, event)
        if self.echo:
            print(f"[control] {kind}: {info}", flush=True)
        return event

    # -- process management ----------------------------------------------

    def _worker_argv(self, gen: int, pods: List[int], idx: int,
                     port: int) -> List[str]:
        pod = pods[idx]
        argv = [sys.executable, "-m", "repro_torch.runtime.control",
                "--worker", "--workdir", str(self.workdir),
                "--pod", str(pod), "--process-id", str(idx),
                "--num-processes", str(len(pods)),
                "--coordinator", f"127.0.0.1:{port}",
                "--generation", str(gen),
                "--n-iter", str(self.n_iter),
                "--chunk-size", str(self.chunk_size),
                "--n", str(self.n), "--dim", str(self.dim),
                "--seed", str(self.seed), "--device", self.device,
                "--model", str(self.model),
                "--keep-last", str(self.keep_last)]
        if gen == 0 and self.kill_pod is not None:
            argv += ["--kill-pod", str(self.kill_pod),
                     "--kill-at-chunk", str(self.kill_at_chunk or 0)]
        return argv

    def _spawn_generation(self, gen: int, pods: List[int]) -> List[_Worker]:
        port = self.base_port + gen
        # a fresh generation must not inherit beat files: a stale file of
        # the previous generation makes the new worker's first write read
        # as progress, swapping startup_grace for the steady-state timeout
        # while the worker still starts.  The previous generation is killed
        # and reaped before this, so no writer races the sweep.
        self._clear_beats()
        env = dict(os.environ)
        # workers resolve `repro_torch` exactly as the supervisor did
        import repro_torch
        src = os.path.dirname(list(repro_torch.__path__)[0])
        env["PYTHONPATH"] = src + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        env.update(self.extra_env)
        workers = []
        for idx in range(len(pods)):
            log_path = self.log_dir / f"gen{gen}-pod{pods[idx]}.log"
            with open(log_path, "ab") as lf:
                proc = subprocess.Popen(
                    self._worker_argv(gen, pods, idx, port),
                    stdout=lf, stderr=subprocess.STDOUT, env=env)
            workers.append(_Worker(pods[idx], proc, log_path))
            self.all_pids.append(proc.pid)
        self._live = workers
        self.log("generation_start", generation=gen, pods=list(pods),
                 n_processes=len(pods), port=port,
                 pids=[w.proc.pid for w in workers])
        return workers

    def _kill_generation(self, workers: List[_Worker],
                         generation: int) -> None:
        killed = []
        for w in workers:
            if w.proc.poll() is None:
                try:
                    w.proc.kill()
                except OSError:
                    pass
                killed.append(w.pod)
            w.proc.wait()           # reap: no zombies, no orphans
        self._live = []
        self.log("generation_killed", generation=generation,
                 killed_pods=killed)

    # -- the watch loop ---------------------------------------------------

    def _clear_beats(self) -> None:
        for f in self.hb_dir.glob("pod*.beat*"):    # .tmp strays too
            try:
                f.unlink()
            except OSError:     # pragma: no cover
                pass

    def _read_beat(self, pod: int):
        """``((generation, counter), step)`` from the pod's beat file, or
        None while it is absent or torn."""
        path = self.hb_dir / f"pod{pod}.beat"
        try:
            b = json.loads(path.read_text())
            return (b.get("generation"), b.get("counter")), b.get("step")
        except (OSError, ValueError):
            return None

    def _watch(self, gen: int, workers: List[_Worker], deadline):
        """Poll heartbeats and child exits until the generation finishes
        ("done") or a pod dies ("failed", survivors)."""
        obs = elastic.HeartbeatObserver()
        finished, dead = set(), {}
        spawn_t = time.monotonic()
        # startup_grace holds until the first beat past the resume point:
        # workers beat before their runtime starts and on entering the
        # loop (both before the first chunk), so counter changes alone do
        # not prove the slow part is over; a beat whose step is past
        # entry_step (the boundary this generation resumes from, 0 for a
        # fresh run) does
        entry_step = max([0] + committed_steps(self.ckpt_dir))
        started = set()
        while True:
            if deadline is not None and time.monotonic() > deadline:
                raise SupervisorError(
                    f"total_timeout={self.total_timeout}s exceeded in "
                    f"generation {gen}", self._trail())
            now = time.monotonic()
            for w in workers:
                if w.pod in finished or w.pod in dead:
                    continue
                rec = self._read_beat(w.pod)
                if rec is not None:
                    counter, step = rec
                    obs.observe(w.pod, counter, now)
                    if counter[0] == gen and step is not None \
                            and step > entry_step and w.pod not in started:
                        started.add(w.pod)
                        self.log("pod_started", generation=gen, pod=w.pod,
                                 step=step)
                rc = w.proc.poll()
                if rc is None:
                    continue
                if rc == 0:
                    finished.add(w.pod)
                else:
                    dead[w.pod] = rc
            if len(finished) == len(workers):
                return "done", []
            # per-pod staleness: the startup grace until the first beat past
            # entry, the steady-state bound after; a pod that never
            # published a beat file is judged against the grace from spawn
            stale = []
            for w in workers:
                if w.pod in finished or w.pod in dead:
                    continue
                b = obs.beats.get(w.pod)
                if b is None:
                    if now - spawn_t > self.startup_grace:
                        stale.append(w.pod)
                    continue
                timeout = self.heartbeat_timeout if w.pod in started \
                    else self.startup_grace
                if w.pod not in \
                        elastic.surviving_pods({w.pod: b}, timeout, now):
                    stale.append(w.pod)
            if dead or stale:
                for pod, rc in sorted(dead.items()):
                    sig = -rc if rc < 0 else None
                    self.log("heartbeat_lost", generation=gen, pod=pod,
                             via="process_exit", returncode=rc,
                             signal=sig)
                for pod in stale:
                    b = obs.beats.get(pod)
                    last = b.stamped if b is not None else spawn_t
                    self.log("heartbeat_lost", generation=gen, pod=pod,
                             via="timeout",
                             stale_s=round(now - last, 3))
                survivors = [w.pod for w in workers
                             if w.pod not in dead and w.pod not in stale]
                self._kill_generation(workers, gen)
                return "failed", survivors
            time.sleep(self.poll_interval)

    def _trail(self) -> List[dict]:
        return _read_events(self.events_path)

    # -- entry point ------------------------------------------------------

    def run(self) -> dict:
        """Drive worker generations to completion; returns the report
        (result, trail, pids).  Raises :class:`SupervisorError` when
        recovery is impossible."""
        deadline = None if self.total_timeout is None \
            else time.monotonic() + self.total_timeout
        pods = list(range(self.n_pods))
        gen = 0
        try:
            while True:
                if gen >= self.max_generations:
                    raise SupervisorError(
                        f"generation budget exhausted "
                        f"({self.max_generations})", self._trail())
                workers = self._spawn_generation(gen, pods)
                outcome, survivors = self._watch(gen, workers, deadline)
                if outcome == "done":
                    result_path = self.workdir / "result.json"
                    if not result_path.exists():
                        raise SupervisorError(
                            f"generation {gen} exited 0 without a "
                            f"result", self._trail())
                    result = json.loads(result_path.read_text())
                    self.log("run_done", generation=gen,
                             step=result.get("step"))
                    return {"ok": True, "generations": gen + 1,
                            "result": result, "pids": self.all_pids,
                            "checkpoint_dir": str(self.ckpt_dir),
                            "trail": self._trail()}
                if not survivors:
                    trail = self._trail()
                    errs = [e["error"] for e in trail
                            if e.get("kind") == "worker_failed"
                            and e.get("generation") == gen]
                    raise SupervisorError(
                        f"generation {gen}: no surviving pods"
                        + (f" (a worker raised {errs[0]})" if errs else ""),
                        trail)
                if not committed_steps(self.ckpt_dir):
                    raise SupervisorError(
                        f"generation {gen} died before any boundary "
                        f"committed: nothing to resume from",
                        self._trail())
                gen += 1
                self.log("remesh", generation=gen, survivors=survivors,
                         n_processes=len(survivors),
                         port=self.base_port + gen,
                         resume_step=committed_steps(self.ckpt_dir)[-1])
                pods = survivors
        finally:
            # no orphans on any exit path (SupervisorError and
            # KeyboardInterrupt included): kill and reap what still runs
            for w in self._live:
                if w.proc.poll() is None:
                    try:
                        w.proc.kill()
                    except OSError:
                        pass
                w.proc.wait()
            self._live = []


def run_supervised(workdir, **kw) -> dict:
    """One-call form of :class:`Supervisor` (see its docstring)."""
    return Supervisor(workdir, **kw).run()


# --------------------------------------------------------------------------
# CLI


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.control",
        description="supervisor/worker control plane for multi-process "
                    "elastic embedding runs")
    ap.add_argument("--workdir", required=True,
                    help="run directory (heartbeats, checkpoints, "
                         "events.jsonl, worker logs)")
    ap.add_argument("--worker", action="store_true",
                    help="run ONE worker process (normally only the "
                         "supervisor passes this)")
    # shared workload spec
    ap.add_argument("--n-iter", type=int, default=16)
    ap.add_argument("--chunk-size", type=int, default=4)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--dim", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--keep-last", type=int, default=3)
    # supervisor knobs
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--base-port", type=int, default=None)
    ap.add_argument("--heartbeat-timeout", type=float, default=15.0)
    ap.add_argument("--startup-grace", type=float, default=300.0)
    ap.add_argument("--max-generations", type=int, default=None)
    ap.add_argument("--total-timeout", type=float, default=None)
    ap.add_argument("--kill-pod", type=int, default=None,
                    help="test hook: arm faults.ProcessKill in this pod "
                         "(generation 0)")
    ap.add_argument("--kill-at-chunk", type=int, default=None)
    # worker identity (supervisor-provided)
    ap.add_argument("--pod", type=int, default=0)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--generation", type=int, default=0)
    args = ap.parse_args(argv)

    if args.worker:
        if args.coordinator is None:
            ap.error("--worker requires --coordinator")
        return worker_main(args)

    sup = Supervisor(args.workdir, n_pods=args.pods, n_iter=args.n_iter,
                     chunk_size=args.chunk_size, n=args.n, dim=args.dim,
                     seed=args.seed, device=args.device,
                     model=args.model, keep_last=args.keep_last,
                     base_port=args.base_port,
                     heartbeat_timeout=args.heartbeat_timeout,
                     startup_grace=args.startup_grace,
                     max_generations=args.max_generations,
                     total_timeout=args.total_timeout,
                     kill_pod=args.kill_pod,
                     kill_at_chunk=args.kill_at_chunk, echo=True)
    try:
        report = sup.run()
    except SupervisorError as e:
        print(f"[control] FAILED: {e}", file=sys.stderr)
        return 1
    r = report["result"]
    print(f"[control] done: step={r['step']}/{r['n_iter']} after "
          f"{report['generations']} generation(s), "
          f"finite={r['finite']}, y_std={r['y_std']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
