"""Sticky, opt-in demotion of a kernel family to its plain PyTorch version
on the CPU, and the logged re-raise of a kernel fault on the card (port of
``repro.kernels.fallback``).

The wrappers of the three families the JAX package guards -- "knn_merge"
(B2, B4), "ne_forces" (B3, B5, B7) and "pairwise_sqdist" (B1, B6) -- run
their launch through :func:`guarded`:

  * disabled (the default, and everywhere outside a ``fit`` under a
    ``ResiliencePolicy`` with ``sticky_fallback=True``) it is a plain
    pass-through: a failing launch raises as it always did;
  * enabled, on the CPU -- where the plain version stands in for the
    kernel, as the JAX package's interpret mode does -- a call that raises
    demotes its family for the rest of the process: this call and every
    later one run the plain version (``ref.py``).  A demotion is a
    ``RuntimeWarning`` and an event (:func:`events`), which ``fit`` copies
    into its policy's log;
  * enabled, on the card, nothing gives way to the plain version: a launch
    that raises is logged as a ``kernel_fault`` event and raised again, so
    that ``fit`` stops with it and the run resumes from its last
    checkpoint.  (A real CUDA fault is sticky on its context anyway: the
    plain version on the same context would fail too.)

The kernels are built before a wrapper calls :func:`guarded`, so an
``nvcc`` or build failure always raises, and ``LAUNCHES`` counts only the
launches that ran.  ``repro_torch.runtime.faults.KernelLaunchFault``
raises in place of a launch, so both paths are exercised
deterministically.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Callable, Dict, List, Optional

from repro_torch.runtime import faults

# The registries below are process-global, so every access -- reads
# included -- holds _LOCK.  The lock is never held across a launch:
# guarded() snapshots what it needs, releases, then runs.
_LOCK = threading.Lock()
_ENABLED = False
_DEMOTED: Dict[str, str] = {}       # family -> reason
_EVENTS: List[dict] = []


def is_enabled() -> bool:
    with _LOCK:
        return _ENABLED


@contextlib.contextmanager
def enabled(on: bool = True):
    """Enable (or force-disable) guarded launches within a scope."""
    global _ENABLED
    with _LOCK:
        prev, _ENABLED = _ENABLED, bool(on)
    try:
        yield
    finally:
        with _LOCK:
            _ENABLED = prev


def demote(family: str, reason) -> None:
    """Sticky-demote ``family`` to its plain version."""
    with _LOCK:
        if family in _DEMOTED:
            return
        _DEMOTED[family] = str(reason)
        _EVENTS.append({"kind": "kernel_demoted", "family": family,
                        "reason": str(reason)})
    warnings.warn(f"[kernels.fallback] demoting {family!r} to its plain "
                  f"PyTorch version for the rest of the run: {reason}",
                  RuntimeWarning, stacklevel=2)


def is_demoted(family: str) -> bool:
    with _LOCK:
        return family in _DEMOTED


def demotions() -> Dict[str, str]:
    with _LOCK:
        return dict(_DEMOTED)


def events(since: int = 0) -> List[dict]:
    with _LOCK:
        return list(_EVENTS[since:])


def n_events() -> int:
    with _LOCK:
        return len(_EVENTS)


def reset() -> None:
    """Clear all sticky state (tests)."""
    global _ENABLED
    with _LOCK:
        _ENABLED = False
        _DEMOTED.clear()
        _EVENTS.clear()


def guarded(family: str, run_kernel: Callable[[], object],
            run_ref: Optional[Callable[[], object]] = None):
    """Run ``run_kernel`` under the sticky-fallback contract.

    Pass-through when disabled.  When enabled, an injected fault
    (``repro_torch.runtime.faults``) or a raising call is answered by
    where the tensors lie.  On the CPU (``run_ref`` given: there the plain
    version is the kernel's stand-in) it demotes the family, and
    ``run_ref`` answers this call and every later one.  On the card
    (``run_ref`` None) it is logged as a ``kernel_fault`` event and raised
    again: no plain version runs on CUDA tensors in place of a kernel.
    """
    if not is_enabled():
        return run_kernel()
    if run_ref is not None and is_demoted(family):
        return run_ref()
    try:
        faults.check_kernel(family)
        return run_kernel()
    except Exception as e:
        if run_ref is None:
            with _LOCK:
                _EVENTS.append({"kind": "kernel_fault", "family": family,
                                "reason": repr(e)})
            raise
        demote(family, repr(e))
        return run_ref()
