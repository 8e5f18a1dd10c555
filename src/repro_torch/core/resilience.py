"""Resilience policy of the chunk loop ``funcsne.fit`` (port of
``repro.core.resilience``).

An interactive session keeps running while points stream in and out and
hyperparameters change; one that dies on the first NaN chunk, a diverging
learning rate or a killed process loses the whole embedding.  This module
is the host-side half of the contract:

  * :class:`ResiliencePolicy` -- what ``fit`` snapshots, when a health
    probe trips, how far a retry backs off, and whether a failing kernel
    family is guarded (``repro_torch.kernels.fallback``: demoted to its
    plain PyTorch version on the CPU, logged and raised on the card);
  * :class:`EmbeddingDiverged` -- raised when the bounded retry budget is
    spent (it carries the step, the trip reason and the event log);
  * the health probe (:meth:`ResiliencePolicy.check`) reads only the
    :class:`~repro_torch.core.funcsne.ChunkMetrics` that ``fit`` already
    reads once per chunk, so detection adds no host sync.

The device-side half is in ``funcsne.make_chunked_step`` (the finite
fraction, max |Y| and first bad step folded into the chunk's metrics);
the scripted faults used by the tests are in ``repro_torch.runtime.faults``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional


class EmbeddingDiverged(RuntimeError):
    """Retry budget exhausted: the run kept tripping health probes.

    Attributes:
      step:    global iteration the last failed chunk started at.
      reason:  the final trip reason string.
      retries: retries consumed before giving up.
      events:  the policy's full structured event log.
    """

    def __init__(self, step: int, reason: str, retries: int,
                 events: List[dict]):
        super().__init__(
            f"embedding diverged at step {step} after {retries} "
            f"rollback-retries: {reason}")
        self.step = step
        self.reason = reason
        self.retries = retries
        self.events = events


@dataclasses.dataclass
class ResiliencePolicy:
    """Checkpoint / rollback / degradation policy consumed by ``fit``.

    With a policy active, ``fit`` keeps a clone of the state from before
    each chunk (the rollback anchor) and checks the chunk's health
    telemetry after it.  A tripped probe rolls the state back to the last
    healthy chunk boundary and retries with the learning rate (and
    optionally the exaggeration) multiplied by ``lr_backoff`` /
    ``exaggeration_backoff``; the backoff compounds per retry and persists
    once a retry succeeds, so a clean run under a policy is bit-identical
    to ``resilience=None``: backoff only ever engages after a trip.

    ``checkpoint_dir`` snapshots the whole ``FuncSNEState`` (embedding,
    velocities, lists, key, reverse-edge cache) through
    :class:`repro_torch.checkpoint.Checkpointer`, in the JAX package's
    on-disk format, every ``checkpoint_every`` healthy chunks;
    ``fit(resume_from=dir)`` continues a killed run bit-identically to
    the uninterrupted one.
    """
    # -- checkpointing ----------------------------------------------------
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1           # healthy chunks between snapshots
    keep_last: int = 3
    # -- rollback & retry -------------------------------------------------
    max_retries: int = 3                # consecutive trips before raising
    lr_backoff: float = 0.5
    exaggeration_backoff: float = 1.0
    # -- health probe thresholds ------------------------------------------
    min_finite_frac: float = 1.0        # trip when finite_frac < this
    max_abs_y: float = 1e8              # trip when max |Y| exceeds this
    # -- chunk-boundary state audit ---------------------------------------
    # run funcsne.audit_state every N healthy chunks (0 = off): catches
    # index-table corruption that the finite-fraction probes cannot see
    # (poisoned indices are finite integers); one extra host sync per
    # audited chunk
    audit_every: int = 0
    # -- graceful degradation ---------------------------------------------
    # kernel failure -> plain version on the CPU; on the card a
    # ``kernel_fault`` event, and the error raised
    sticky_fallback: bool = True
    # -- hang / straggler watchdog ----------------------------------------
    hang_timeout: float = 600.0         # seconds per chunk
    straggler_z: float = 4.0
    straggler_warmup: int = 5
    # -- telemetry sink ---------------------------------------------------
    on_event: Optional[Callable[[dict], None]] = None
    events: List[dict] = dataclasses.field(default_factory=list)

    def log(self, kind: str, **info) -> dict:
        event = {"kind": kind, **info}
        self.events.append(event)
        if self.on_event is not None:
            self.on_event(event)
        return event

    def check(self, metrics) -> Optional[str]:
        """Trip reason from one chunk's telemetry, or None when healthy.

        Written so that NaN telemetry trips too (a NaN ``finite_frac``
        fails ``>=``): a probe that can itself go NaN must fail closed.
        """
        ff = float(metrics.finite_frac)
        if not (ff >= self.min_finite_frac):
            bad = int(metrics.bad_step)
            return (f"non-finite embedding: finite_frac={ff:.4f} < "
                    f"{self.min_finite_frac} (first bad step {bad})")
        ym = float(metrics.y_max_abs)
        if not (ym <= self.max_abs_y) or math.isnan(ym):
            return (f"embedding explosion: max|Y|={ym:.3e} > "
                    f"{self.max_abs_y:.3e}")
        return None

    def audit_check(self, audit) -> Optional[str]:
        """Trip reason from an :class:`~repro_torch.core.funcsne.AuditResult`
        (any non-zero violation count), or None when clean.  Feeds the same
        rollback/backoff path as :meth:`check`."""
        bad = [f"{name}={int(v)}" for name, v in
               zip(audit._fields, audit) if int(v) != 0]
        if bad:
            return "state audit violation: " + ", ".join(bad)
        return None
