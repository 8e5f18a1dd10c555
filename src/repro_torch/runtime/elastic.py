"""Grid shape over the ranks present (port of the in-process part of
``repro.runtime.elastic``).

:func:`remesh` picks the largest ``(data, model)`` grid over a rank count:
the model width is the largest feasible one ``<=`` the request that
divides the rank count (and every extra constraint, such as the feature
dimension the model axis splits), so no rank is left out silently; with
``exact_model`` the requested width is kept and the ranks left out are
reported as a structured ``devices_dropped`` event (the module's log and
``on_event``), the same telemetry idiom as ``repro_torch.kernels.fallback``.
A rank left out of the grid takes no step (``runtime.coordinator``).

The reference's heartbeat liveness (``Beat``, ``HeartbeatObserver``,
``surviving_pods``) belongs to its multi-process control plane and is not
ported here.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.launch.mesh import Grid

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
           on_event=None) -> Grid:
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
