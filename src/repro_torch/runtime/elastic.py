"""Elastic scaling: the grid over the ranks present, and heartbeat
liveness (port of ``repro.runtime.elastic``).

:func:`remesh` picks the largest ``(data, model)`` grid over a rank count:
the model width is the largest feasible one ``<=`` the request that
divides the rank count (and every extra constraint, such as the feature
dimension the model axis splits), so no rank is left out silently; with
``exact_model`` the requested width is kept and the ranks left out are
reported as a structured ``devices_dropped`` event (the module's log and
``on_event``), the same telemetry idiom as ``repro_torch.kernels.fallback``.
A rank left out of the grid takes no step (``runtime.coordinator``).

After a host loss (``runtime.coordinator``: a simulated host is a block of
ranks; ``runtime.control``: a real one is a worker process) the survivors
quiesce, :func:`remesh` builds the grid over the ranks left, the last
committed chunk boundary is restored onto it, and the chunked schedule
replays from its step.  Checkpoints hold whole arrays (per-host row slices
merge back on load), so any grid restores any boundary.

Liveness (:class:`Beat`, :class:`HeartbeatObserver`,
:func:`surviving_pods`) is the reference's beat-counter contract: pure
Python on the observer's monotonic clock, importing nothing else, so the
supervisor of ``runtime.control`` never loads torch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Sequence

_EVENTS: List[dict] = []


def events(since: int = 0) -> List[dict]:
    """Structured grid-change events recorded by :func:`remesh`."""
    return list(_EVENTS[since:])


def n_events() -> int:
    return len(_EVENTS)


def reset_events() -> None:
    _EVENTS.clear()


def _emit(event: dict, on_event=None) -> dict:
    _EVENTS.append(event)
    if on_event is not None:
        on_event(event)
    return event


def remesh(n_ranks: int = None, *, model: int = 16,
           axis_names=("data", "model"), ranks: Sequence[int] = None,
           exact_model: bool = False, divides: Sequence[int] = (),
           on_event=None) -> "Grid":
    """The largest ``(data, model)`` :class:`~repro_torch.launch.mesh.Grid`
    over ``ranks`` (default ``0 .. n_ranks - 1``; ``n_ranks`` defaults to
    their count).

    ``model`` is the requested model width.  Unless ``exact_model``, the
    width is the largest ``<= model`` that divides the rank count and every
    entry of ``divides``: 6 ranks at ``model=4`` make a (2, 3) grid, with
    ``divides=(8,)`` a (3, 2) one.  With ``exact_model`` the width stays
    and the ranks past ``data * model`` are left out, each reported in one
    ``devices_dropped`` event.

    Where a process group is initialised this builds the grid's subgroups,
    so every rank of the world calls it, with the same arguments.
    """
    from repro_torch.launch.mesh import Grid

    ranks = list(range(n_ranks) if ranks is None else ranks)
    if n_ranks is None:
        n_ranks = len(ranks)
    n_ranks = min(int(n_ranks), len(ranks))
    if n_ranks < 1:
        raise ValueError("remesh needs at least one rank")
    model = max(1, min(int(model), n_ranks))
    if not exact_model:
        def feasible(m):
            return n_ranks % m == 0 and all(d % m == 0 for d in divides)
        while model > 1 and not feasible(model):
            model -= 1
    data = n_ranks // model
    used = data * model
    if used < n_ranks:
        _emit({"kind": "devices_dropped", "requested_model": model,
               "n_devices": n_ranks, "n_used": used,
               "n_dropped": n_ranks - used,
               "dropped": [f"rank {r}" for r in ranks[used:n_ranks]]},
              on_event)
    return Grid((data, model), axis_names, ranks=ranks[:used])


# --------------------------------------------------------------------------
# Heartbeat liveness: the observer-stamped beat-counter contract.
#
# Pods prove liveness by bumping a counter (in a per-pod heartbeat file, at
# every chunk boundary), never by writing a timestamp: clocks on different
# hosts are not comparable.  The observer (the supervisor in
# ``repro_torch.runtime.control``) stamps each counter change with its own
# ``time.monotonic()``, so freshness is an observer-local question: how
# long since it last saw this pod make progress.


@dataclasses.dataclass
class Beat:
    """One pod's liveness record, as seen by the observer.

    ``counter`` is the last beat value the pod published (opaque: equality
    is the only operation, so ``(generation, k)`` tuples work).
    ``stamped`` is the observer's ``time.monotonic()`` when the counter last
    changed (first observation included).  ``changes`` counts the changes
    seen since the first observation; 0 means published but never seen to
    progress.  (Counter changes alone cannot prove a pod is past its slow
    start, since workers beat before their runtime starts and again on
    entering the loop, so the supervisor gates its startup grace on the
    step a beat carries.)"""
    counter: Hashable
    stamped: float
    changes: int = 0


class HeartbeatObserver:
    """Stamps beat-counter changes with the observer's monotonic clock.

    ``observe(pod, counter, now)`` records ``now`` as the pod's freshness
    time iff ``counter`` differs from the last one seen (or the pod is new);
    an unchanged counter never refreshes, so a wedged pod whose stale file
    keeps being read goes stale on schedule.  ``now`` comes from the
    observer's own clock, never from anything the pod wrote."""

    def __init__(self):
        self.beats: Dict[Hashable, Beat] = {}

    def observe(self, pod, counter, now: float) -> bool:
        """Record one reading; True when it counted as progress."""
        b = self.beats.get(pod)
        if b is None:
            self.beats[pod] = Beat(counter, float(now))
            return True
        if counter != b.counter:
            b.counter = counter
            b.stamped = float(now)
            b.changes += 1
            return True
        return False

    def forget(self, pod) -> None:
        self.beats.pop(pod, None)

    def survivors(self, timeout_s: float, now: float) -> list:
        return surviving_pods(self.beats, timeout_s, now)


def surviving_pods(beats: dict, timeout_s: float, now: float) -> list:
    """Pod ids whose beat counter changed within ``timeout_s`` of ``now``.

    ``beats`` maps pod id -> :class:`Beat` (or a ``(counter, stamped)``
    tuple), ``stamped`` being the observer's monotonic time of the last
    counter change.  A gap equal to the timeout counts fresh: the timeout
    is the first instant a pod may be declared dead.  Pod clocks never
    enter the comparison."""
    out = []
    for pod, b in sorted(beats.items()):
        stamped = b.stamped if isinstance(b, Beat) else b[1]
        if now - float(stamped) <= timeout_s:
            out.append(pod)
    return out
