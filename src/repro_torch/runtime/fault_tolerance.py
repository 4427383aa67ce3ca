"""Fault-tolerant training runtime: restartable loop + straggler detection
(the port's copy of ``repro.runtime.fault_tolerance``, which is pure
Python).

At thousand-node scale the framework must assume nodes WILL fail:
- ``TrainGuard.run`` wraps the step loop with checkpoint-every-N, crash
  resume from the latest manifest, and bounded retry on transient step
  failures (on a real cluster: preemption signals / collective timeouts
  surface as exceptions from the step function).
- ``StragglerDetector`` keeps an EWMA of step wall-time; a step slower than
  ``threshold × ewma`` flags a straggler incident. On a cluster the action
  is to report the slow host for the controller to hot-swap; here the hook
  records incidents (and the decision logic is unit-tested with simulated
  timings).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.2  # EWMA coefficient
    threshold: float = 2.5  # step slower than threshold×ewma => incident
    warmup: int = 5  # ignore the first steps (compile)
    ewma: float = 0.0
    n: int = 0
    incidents: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self.n += 1
        if self.n <= self.warmup:
            # seed the EWMA from the first sample ONLY — seeding and then
            # EWMA-ing the same sample would weight it twice
            if self.ewma == 0:
                self.ewma = dt
            else:
                self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
            return False
        flagged = dt > self.threshold * self.ewma and self.ewma > 0
        if flagged:
            self.incidents.append((step, dt, self.ewma))
            log.warning(
                "straggler: step %d took %.3fs (ewma %.3fs)", step, dt,
                self.ewma,
            )
            # clamped update: the baseline still adapts under a persistent
            # slow regime (otherwise every later step flags forever), but
            # one outlier can pull it up by at most the flag bar itself
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * min(
                dt, self.threshold * self.ewma
            )
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return flagged


@dataclasses.dataclass
class TrainGuard:
    """Restartable step loop with periodic checkpointing.

    On a mesh of ranks each rank runs the loop over its blocks of the
    state, with ``shardings`` (the state's tree of ``NamedSharding``,
    e.g. ``launch.steps.state_shardings``) passed to ``save`` and
    ``restore``: rank 0 writes, every rank restores its blocks of rank
    0's latest step. A failure must be raised on every rank at the same
    step, as an SPMD program's is (a collective's error, or a fault the
    caller turns into one on every rank). A failure on one rank alone,
    with its peers blocked in a collective, is out of scope: they wait
    until their process group's timeout."""

    ckpt: Any  # CheckpointManager
    save_every: int = 100
    max_retries: int = 3
    detector: Optional[StragglerDetector] = None
    shardings: Any = None

    def run(
        self,
        state: Any,
        step_fn: Callable[[Any, int], Any],
        n_steps: int,
        start_step: int = 0,
    ):
        """Runs step_fn(state, step) -> state for steps [start, n_steps),
        checkpointing every ``save_every``. Transient exceptions restore the
        latest checkpoint and retry (bounded)."""
        step = start_step
        retries = 0
        while step < n_steps:
            try:
                t0 = time.monotonic()
                state = step_fn(state, step)
                dt = time.monotonic() - t0
                if self.detector is not None:
                    self.detector.observe(step, dt)
                step += 1
                retries = 0
                if step % self.save_every == 0 or step == n_steps:
                    self.ckpt.save(step, state, shardings=self.shardings)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # transient node failure path
                retries += 1
                log.error("step %d failed (%s); retry %d/%d", step, e,
                          retries, self.max_retries)
                if retries > self.max_retries:
                    raise
                if self.shardings is not None:
                    self.ckpt.wait()  # rank 0 has published its saves
                latest = self.ckpt.latest_step()
                if latest is not None:
                    state, step = self.ckpt.restore(
                        state, latest, shardings=self.shardings)[0], latest
        self.ckpt.wait()
        return state, step
