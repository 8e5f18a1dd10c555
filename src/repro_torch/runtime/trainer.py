"""Fault-tolerant training driver (port of ``repro.runtime.trainer``).

Wraps the train step with: periodic async checkpointing (params,
optimiser state, the step as the data cursor) through the port's
``Checkpointer``, crash-recovery restore on start, step-time straggler
monitoring (``StepTimeMonitor``: an alarm snapshots at once), and an
optional failure-injection hook used by the restart test (fail before step
N, relaunch, and the resumed run's losses equal the uninterrupted run's).

The step's metrics are read on the host (``float(metrics["loss"])``), which
waits for the device, so each step's wall time covers its kernels.  A
restore gives each leaf the like-tree's dtype, shape and device.

One repair against the reference: a straggler alarm comes after its step
has run, so its snapshot is labelled ``step + 1``, the steps it holds, as
the periodic checkpoints are.  The reference labels it ``step``, and a
restore from it runs that step a second time on parameters that already
took it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import Checkpointer
from repro_torch.runtime.straggler import StepTimeMonitor


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep_last: int = 3
    log_every: int = 10
    fail_at_step: Optional[int] = None      # failure injection (tests)


class SimulatedFailure(RuntimeError):
    pass


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 data_fn: Callable[[int], Dict[str, Any]],
                 params, opt_state, logger: Callable[[str], None] = print):
        """step_fn(params, opt_state, batch) -> (params, opt_state, metrics);
        data_fn(step) -> batch (deterministic per step for exact restart)."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.params = params
        self.opt_state = opt_state
        self.log = logger
        self.ckpt = Checkpointer(cfg.checkpoint_dir, keep_last=cfg.keep_last)
        self.monitor = StepTimeMonitor()
        self.start_step = 0
        self.history: list = []

    # -- recovery ---------------------------------------------------------

    def maybe_restore(self):
        step = self.ckpt.latest_step()
        if step is None:
            return False
        tree = {"params": self.params, "opt": self.opt_state}
        tree, meta = self.ckpt.restore(tree, step=step)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.start_step = meta["step"]
        self.log(f"[trainer] restored checkpoint at step {self.start_step}")
        return True

    # -- main loop ---------------------------------------------------------

    def run(self):
        cfg = self.cfg
        for step in range(self.start_step, cfg.total_steps):
            if cfg.fail_at_step is not None and step == cfg.fail_at_step:
                # crash BEFORE the step commits, like a real preemption
                self.ckpt.wait()
                raise SimulatedFailure(f"injected failure at step {step}")
            batch = self.data_fn(step)
            t0 = time.time()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            alarm = self.monitor.observe(dt)
            if alarm:
                self.log(f"[trainer][step {step}] {alarm}; snapshotting")
                self._checkpoint(step + 1)
            self.history.append({"step": step, "loss": loss, "sec": dt})
            if step % cfg.log_every == 0:
                self.log(f"[trainer] step {step} loss {loss:.4f} "
                         f"({dt * 1e3:.0f} ms)")
            if (step + 1) % cfg.checkpoint_every == 0:
                self._checkpoint(step + 1)
        self.ckpt.wait()
        return self.history

    def _checkpoint(self, step: int):
        self.ckpt.save(step, {"params": self.params, "opt": self.opt_state},
                       metadata={"step": step})
