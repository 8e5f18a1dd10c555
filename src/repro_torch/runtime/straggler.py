"""Straggler / hang detection from per-chunk wall times (port of
``repro.runtime.straggler``).

``StepTimeMonitor`` keeps an EWMA and variance of the durations it sees
and raises an alarm when one exceeds ``mean + z_thresh * std`` (a slow
host, a throttled card) or an absolute ``hang_timeout``.
``funcsne.fit`` feeds it each chunk's wall time and answers an alarm by
committing the chunk boundary early -- a blocking checkpoint save (or a
join of the one in flight), logged as an ``early_checkpoint`` event -- so
a kill that follows loses at most one chunk.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class StepTimeMonitor:
    decay: float = 0.95
    z_thresh: float = 4.0
    hang_timeout: float = 600.0
    warmup_steps: int = 5

    _mean: float = 0.0
    _var: float = 0.0
    _count: int = 0

    def observe(self, seconds: float) -> Optional[str]:
        """Record one duration; returns an alarm string or None."""
        self._count += 1
        if self._count <= self.warmup_steps:
            # seed the statistics; never alarm while the kernels build
            w = 1.0 / self._count
            self._mean = (1 - w) * self._mean + w * seconds
            self._var = max(self._var, (seconds - self._mean) ** 2)
            return None
        alarm = None
        std = math.sqrt(self._var)
        if seconds > self.hang_timeout:
            alarm = f"hang: step took {seconds:.1f}s > {self.hang_timeout}s"
        elif seconds > self._mean + self.z_thresh * max(std, 0.05 * self._mean):
            alarm = (f"straggler: step {seconds * 1e3:.0f}ms vs "
                     f"mean {self._mean * 1e3:.0f}ms (z>{self.z_thresh})")
        self._mean = self.decay * self._mean + (1 - self.decay) * seconds
        self._var = self.decay * self._var \
            + (1 - self.decay) * (seconds - self._mean) ** 2
        return alarm

    @property
    def mean(self) -> float:
        return self._mean
