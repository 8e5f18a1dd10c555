"""The port's stand-in for a JAX device mesh: a (data, model) grid of ranks
on ``torch.distributed`` (port of ``repro.launch.mesh``).

JAX runs a mesh in one process under ``shard_map``; the port runs one
process a rank.  A :class:`Grid` is built on every rank of the world, in
the same order, and gives the collectives ``repro_torch.core.funcsne``
needs along named axes:

  * rank order is ``r = d * model + m``, the order in which
    ``jax.lax.axis_index(("data", "model"))`` and a tiled ``all_gather``
    over ``("data", "model")`` number devices;
  * the "feat" group of a rank holds the ranks of its ``d`` (its model
    axis), the "points" group the ranks of its ``m`` (its data axis), and
    the grid's own group all of them;
  * :meth:`Grid.all_gather` is the tiled all-gather along axis 0,
    :meth:`Grid.all_reduce` the sum / min / max all-reduce, both over any
    of those axis sets; along an axis of size 1 they return their input.
    A sum adds up in XLA's order and precision (see
    :meth:`Grid.all_reduce`), so every rank gets the same bits;
  * :meth:`Grid.column_block` is the rank's column block of X (the
    reference's ``P(None, "model")``).

:func:`run_ranks` starts W ranks on this machine (start method ``spawn``,
a free localhost port, ``init_process_group`` with a timeout so a dead
peer fails its siblings instead of hanging them) and joins them under a
hard time limit.  Its ranks stand in for the devices of one process, the
reference's simulated pod (:func:`simulated_pod`); a process group formed
otherwise (``runtime.control``'s workers, ``launch.embed
--num-processes``, each process joined by :func:`join_group`) is a real
pod, one process a host.  :func:`pick_backend` is its transport rule:
NCCL where every rank has a CUDA device of its own, gloo where the
tensors are on the CPU or ranks share one card.  The backend moves bytes only: every
rank's kernels run on its card either way.  The collectives are list
``all_gather`` and ``all_reduce``, which both torch 2.11 and 2.13 offer,
and gloo takes CUDA tensors for both.

The reference's ``make_production_mesh`` (a 16 x 16 TPU pod),
``sanitize_spec``, ``tree_shardings`` and ``replicated`` build JAX
``NamedSharding`` trees for the LM; they have no counterpart here.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_lib
import socket
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def host_device_blocks(devices, n_hosts: int) -> list:
    """Partition a flat device (or rank) list into ``n_hosts`` contiguous
    blocks: host ``h`` owns ``devices[h*n/H : (h+1)*n/H]``."""
    devices = list(devices)
    n = len(devices)
    if not 1 <= n_hosts <= n:
        raise ValueError(f"n_hosts={n_hosts} for {n} devices")
    return [devices[h * n // n_hosts:(h + 1) * n // n_hosts]
            for h in range(n_hosts)]


# True in a rank that run_ranks started: such ranks stand in for the devices
# of one process (the reference's simulated pod), where ranks joined in a
# process group of their own are the processes of a real pod
_IN_RUN_RANKS = [False]


def simulated_pod() -> bool:
    """Whether this process is a rank of :func:`run_ranks` (the ranks of one
    simulated pod) rather than a process of a real pod (a process group
    started by ``runtime.control`` or ``launch.embed --num-processes``)."""
    return _IN_RUN_RANKS[0]


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}

# Per-process collective counters, as ``kernels.LAUNCHES`` counts launches:
# tag of the call -> [calls, bytes, ms].  Bytes are what a call produces on
# this rank (the gathered tensor; for a sum, the summed buffer); ms are
# wall time around a synchronised call, kept only while timing is on
# (:func:`set_timed`: it synchronises the card around every collective).
COLLECTIVES = {}
_TIMED = [False]


def reset_collectives() -> None:
    COLLECTIVES.clear()


def set_timed(on: bool) -> None:
    _TIMED[0] = bool(on)


class Grid:
    """A ``(data, model)`` grid over ``ranks`` of the process group (see the
    module docstring).  Built collectively: every rank of the world
    constructs it, with the same arguments, in the same order.

    ``ranks`` defaults to ``0 .. data * model - 1``; a rank of the world
    outside it is not a :attr:`member` and takes no part in the grid's
    collectives.  Without an initialised process group the grid runs as
    rank 0 and its collectives along axes wider than 1 raise: start the
    ranks with :func:`run_ranks`.

    Every collective with a tag counts in :data:`COLLECTIVES`.
    """

    def __init__(self, shape=(1, 1), axis_names=("data", "model"),
                 ranks: Optional[Sequence[int]] = None):
        if len(shape) != 2 or len(axis_names) != 2:
            raise ValueError(f"a grid is (data, model); got {shape} over "
                             f"{axis_names}")
        data, model = (int(s) for s in shape)
        if data < 1 or model < 1:
            raise ValueError(f"grid shape {shape}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (data, model)))
        self.size = data * model
        self.ranks = list(range(self.size)) if ranks is None \
            else [int(r) for r in ranks]
        if len(self.ranks) != self.size:
            raise ValueError(f"{len(self.ranks)} ranks for a {data} x "
                             f"{model} grid")
        on = _initialized()
        world = dist.get_world_size() if on else 1
        me = dist.get_rank() if on else 0
        if on and max(self.ranks) >= world:
            raise ValueError(
                f"grid ranks {self.ranks} outside a world of {world}")
        self.backend = dist.get_backend() if on else None
        self.member = me in self.ranks
        pos = self.ranks.index(me) if self.member else None
        self.coords = {} if pos is None else {
            self.axis_names[0]: pos // model, self.axis_names[1]: pos % model}
        # subgroups, created in one order on every rank of the world:
        # the grid, then each data column (same m), then each model row
        # (same d); an axis set of size 1 needs none
        self._groups = {}
        if world > 1:
            dn, mn = self.axis_names
            if self.size > 1:
                self._add_group(self.axis_names, self.ranks,
                                whole=self.ranks == list(range(world)))
            if data > 1 and model > 1:
                for m in range(model):
                    self._add_group((dn,), self.ranks[m::model])
                for d in range(data):
                    self._add_group((mn,), self.ranks[d * model:
                                                      (d + 1) * model])

    def _add_group(self, axes, ranks, whole=False):
        group = None if whole else dist.new_group(ranks)
        if dist.get_rank() in ranks:
            self._groups[tuple(axes)] = group

    # -- axes ----------------------------------------------------------------

    def _axes(self, axes) -> tuple:
        if axes is None:
            return ()
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"unknown axis {a!r} of {self.axis_names}")
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order) or len(set(order)) != len(order):
            raise ValueError(f"axes {axes} out of the grid's order "
                             f"{self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        n = 1
        for a in self._axes(axes):
            n *= self.shape[a]
        return n

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes``, row-major in the given order
        (``jax.lax.axis_index``)."""
        if not self.member:
            raise RuntimeError("this rank is not a member of the grid")
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def _group(self, axes):
        """The process group of the ranks along ``axes`` (axes of size 1
        dropped): the grid's own when they span every rank of it."""
        live = tuple(a for a in self._axes(axes) if self.shape[a] > 1)
        if all(self.shape[a] == 1 for a in self.axis_names if a not in live):
            live = self.axis_names
        if live not in self._groups:
            raise RuntimeError(
                f"no process group for axes {live}: the grid's collectives "
                "need ranks started by run_ranks (torch.distributed)")
        return self._groups[live]

    # -- collectives ---------------------------------------------------------

    @staticmethod
    def _start(x):
        """The clock at a synchronised start while timing is on, else
        None."""
        if not _TIMED[0]:
            return None
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return time.perf_counter()

    @staticmethod
    def _account(tag, x, nbytes, t0):
        if t0 is not None and x.is_cuda:
            torch.cuda.synchronize(x.device)
        if tag is None:
            return
        rec = COLLECTIVES.setdefault(tag, [0, 0, 0.0])
        rec[0] += 1
        rec[1] += nbytes
        if t0 is not None:
            rec[2] += (time.perf_counter() - t0) * 1e3

    def _gather(self, x, axes, tag, nbytes=None):
        """The list of ``x`` of every rank along ``axes``, in axis-index
        order; counted under ``tag`` as ``nbytes`` (default: the gathered
        bytes)."""
        w = self.axis_size(axes)
        group = self._group(axes)
        x = x.contiguous()
        t0 = self._start(x)

        parts = [torch.empty_like(x) for _ in range(w)]
        dist.all_gather(parts, x, group=group)
        out = torch.stack(parts)
        self._account(tag, out, out.numel() * out.element_size()
                      if nbytes is None else nbytes, t0)
        return out.unbind(0)

    def all_gather(self, x, axes, tag=None):
        """``x`` of every rank along ``axes``, concatenated along dim 0 in
        axis-index order (a tiled ``jax.lax.all_gather``)."""
        if self.axis_size(axes) == 1:
            return x
        return torch.cat(self._gather(x, axes, tag))

    def all_reduce(self, x, axes, op: str = "sum", tag=None):
        """A new tensor: ``x`` reduced (``sum``, ``min`` or ``max``) over the
        ranks along ``axes`` (``jax.lax.psum`` / ``pmin`` / ``pmax``).

        A sum crosses the wire in ``x``'s dtype and is added up on every
        rank in axis-index order, in float32 for bf16 and float16 with one
        rounding at the end: what XLA's psum does on the CPU (sequential in
        device order; bf16 summed in float32, rounded once), where gloo and
        NCCL round a bf16 sum after every addition and add in an order of
        their own.  So every rank gets the same bits on any backend, and
        the bf16 force sum is the reference's.  Over two ranks it moves the
        bytes a ring all-reduce moves; min and max are exact in any order
        and use the backend's all-reduce."""
        if self.axis_size(axes) == 1:
            return x
        if op == "sum":
            parts = self._gather(x, axes, tag, x.numel() * x.element_size())
            low = x.dtype in (torch.bfloat16, torch.float16)
            acc = parts[0].float() if low else parts[0].clone()
            for p in parts[1:]:
                acc = acc + (p.float() if low else p)
            return acc.to(x.dtype)
        group = self._group(axes)
        t0 = self._start(x)
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=_OPS[op], group=group)
        self._account(tag, out, out.numel() * out.element_size(), t0)
        return out

    def barrier(self):
        """Wait for every rank of the grid (a no-op on one rank)."""
        if self.size > 1:
            dist.barrier(group=self._groups[self.axis_names])

    def column_block(self, X, feat_axis: str = "model"):
        """This rank's contiguous column block of ``X`` along ``feat_axis``
        (``P(None, feat_axis)``); the column count must divide evenly."""
        w = self.axis_size(feat_axis)
        m = X.shape[1]
        if m % w:
            raise ValueError(f"{m} columns do not split over {w} ranks of "
                             f"axis {feat_axis!r}")
        i = self.axis_index(feat_axis)
        if w == 1:
            return X.contiguous()
        return X[:, i * (m // w):(i + 1) * (m // w)].contiguous()


# --------------------------------------------------------------------------
# Starting ranks


def pick_backend(device, world: int) -> str:
    """The transport of ``world`` ranks on ``device``'s type: NCCL when
    every rank has a CUDA device of its own, gloo when the tensors are on
    the CPU or ranks share a card (NCCL takes no two ranks on one
    device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, or CUDA device ``rank`` modulo the
    cards present (ranks share a card when there are fewer cards)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


# the rendezvous and each collective of a process joined by join_group:
# jax.distributed.initialize's default, so that processes started by hand
# have time to meet, and a peer that hangs fails the others after it
COLLECTIVE_TIMEOUT_S = 300.0


def join_group(device, world: int, rank: int, init_method: str,
               timeout_s: float = COLLECTIVE_TIMEOUT_S,
               backend: Optional[str] = None) -> torch.device:
    """Join the process group as ``rank`` of ``world`` at ``init_method``
    (``tcp://host:port``) on this rank's device (:func:`rank_device`), with
    the backend of :func:`pick_backend` unless one is given, each collective
    bounded by ``timeout_s``; returns the rank's device."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or pick_backend(device, world), init_method=init_method,
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device, threads, timeout_s, fn,
               args, out_q):
    try:
        _IN_RUN_RANKS[0] = True
        if threads:
            torch.set_num_threads(threads)
        dev = join_group(device, world, rank, f"tcp://127.0.0.1:{port}",
                         timeout_s, backend)
        try:
            result = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        # pickled here, so that tensors travel as bytes and not as handles
        # to this process's memory, which ends before the parent reads them
        out_q.put(("ok", rank, pickle.dumps(result)))
    except BaseException:
        out_q.put(("error", rank, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, args: tuple = (), *, device="cuda",
              backend: Optional[str] = None,
              timeout: Optional[float] = 600.0,
              collective_timeout: float = 120.0, threads: int = None):
    """Run ``fn(rank, world, device, *args)`` on ``world`` spawned ranks and
    return their results, by rank.

    ``fn`` must be importable by name (a module-level function) and its
    results picklable (tensors come back as copies).  ``backend``
    defaults to :func:`pick_backend`.  A rank that raises makes this raise
    ``RuntimeError`` with its traceback (the other ranks are killed); past
    ``timeout`` seconds (None: no limit) every rank is killed and
    ``TimeoutError`` raised, so a deadlock fails the caller instead of
    hanging it.  ``collective_timeout`` bounds each collective inside the
    ranks.  ``threads`` sets each rank's torch threads (default
    on the CPU: the cores split over the ranks).  ``device`` is the card
    unless the caller asks for ``"cpu"``; without CUDA the card raises
    before any rank starts.
    """
    import torch.multiprocessing as mp

    from repro_torch.core.funcsne import resolve_device

    device = resolve_device(device)
    if backend is None:
        backend = pick_backend(device, world)
    if threads is None and device.type == "cpu":
        threads = max(1, (os.cpu_count() or 1) // world)
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, backend, str(device), threads,
                               collective_timeout, fn, args, out_q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + (float("inf") if timeout is None
                                   else timeout)
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world} ranks ({backend}) did not finish within "
                    f"{timeout:.0f}s; finished: {sorted(results)}")
            try:
                kind, rank, value = out_q.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in results and r not in errors]
                if dead:
                    # a rank died without reporting (a signal, a crash)
                    time.sleep(1.0)     # let a queued report land first
                    if out_q.empty():
                        raise RuntimeError(
                            f"rank(s) {dead} exited with codes "
                            f"{[procs[r].exitcode for r in dead]}")
                continue
            if kind == "ok":
                results[rank] = pickle.loads(value)
            else:
                errors[rank] = value
                break           # the other ranks cannot finish: kill them
        if errors:
            rank = min(errors)
            raise RuntimeError(f"rank {rank} of {world} ({backend}) failed:"
                               f"\n{errors[rank]}")
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        out_q.close()
    return [results[r] for r in range(world)]
