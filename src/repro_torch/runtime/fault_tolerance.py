"""Fault tolerance: a preemption-safe training loop, the step-time
watchdog, restart and resume.

  * ``Watchdog``: an EMA step-time monitor that flags stragglers (a step
    slower than ``threshold x`` the EMA) and records incidents; the
    fleet router (``launch/router.py``) reads its live streak as a
    replica's health.
  * ``PreemptionGuard``: turns SIGTERM/SIGINT into a "save and stop"
    request that the loop honours at the next step boundary.
  * ``TrainRunner``: the step loop: step-indexed data, an async
    checkpoint every N steps, resume from the latest manifest, bit-exact
    restart, and restore onto other devices through the checkpoint's
    ``device=`` argument.
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import tree as tree_lib


class Watchdog:
    """EMA step-time monitor.  A step slower than ``threshold x`` the EMA
    is a straggler incident and leaves the EMA as it was, so a transient
    spike does not inflate the baseline; after ``adapt_after``
    consecutive incidents the slowdown is taken as the new normal and
    straggler times blend into the EMA too, so flagging stops.
    ``consecutive`` is the live incident streak."""

    def __init__(self, threshold: float = 3.0, ema: float = 0.9,
                 warmup_steps: int = 2, adapt_after: int = 5):
        if adapt_after < 1:
            raise ValueError("adapt_after must be >= 1")
        self.threshold = threshold
        self.ema_coef = ema
        self.warmup_steps = warmup_steps
        self.adapt_after = adapt_after
        self.ema: Optional[float] = None
        self.incidents: List[Dict[str, Any]] = []
        self.consecutive = 0
        self._seen = 0

    def observe(self, step: int, dt: float) -> bool:
        """True if this step is a straggler incident."""
        self._seen += 1
        if self._seen <= self.warmup_steps:   # first steps are outliers
            return False
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = dt > self.threshold * self.ema
        if is_straggler:
            self.consecutive += 1
            self.incidents.append({"step": step, "dt": dt, "ema": self.ema})
            if self.consecutive >= self.adapt_after:
                self.ema = (self.ema_coef * self.ema
                            + (1 - self.ema_coef) * dt)
        else:
            self.consecutive = 0
            self.ema = self.ema_coef * self.ema + (1 - self.ema_coef) * dt
        return is_straggler


class PreemptionGuard:
    """``requested`` turns True on SIGTERM or SIGINT (with ``install``)
    or on :meth:`request`."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._orig: Dict[int, Any] = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._orig[sig] = signal.signal(sig, self._handler)
                except ValueError:
                    pass   # not on the main thread

    def _handler(self, signum, frame):
        self.requested = True

    def request(self):
        self.requested = True

    def uninstall(self):
        for sig, h in self._orig.items():
            signal.signal(sig, h)


def _synchronize(state) -> None:
    """Wait for the card that holds ``state``'s first leaf, so a step's
    time is its run on the card and not its launch."""
    leaves = tree_lib.leaves(state)
    if leaves and isinstance(leaves[0], torch.Tensor) \
            and leaves[0].device.type == "cuda":
        torch.cuda.synchronize(leaves[0].device)


class TrainRunner:
    """The fault-tolerant step loop.

    ``step_fn(state, batch) -> (state, metrics)``, where ``state`` is a
    tree that fully determines training (params, optimizer state); the
    step counter is kept here.  ``batch_fn(step) -> batch`` is
    deterministic, so a resume replays the exact stream."""

    def __init__(self, step_fn: Callable, batch_fn: Callable[[int], Any],
                 ckpt: CheckpointManager, *, ckpt_every: int = 50,
                 watchdog: Optional[Watchdog] = None,
                 guard: Optional[PreemptionGuard] = None,
                 on_incident: Optional[Callable[[Dict[str, Any]], None]]
                 = None):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.watchdog = watchdog or Watchdog()
        self.guard = guard or PreemptionGuard(install=False)
        self.on_incident = on_incident
        self.metrics_log: List[Dict[str, Any]] = []

    def resume_or_init(self, init_state, *, device=None):
        step, state = self.ckpt.restore_latest(init_state, device=device)
        if step is None:
            return 0, init_state
        return step, state

    def run(self, state, start_step: int, n_steps: int, *,
            fail_at: Optional[int] = None):
        """Run to ``start_step + n_steps``; ``fail_at`` injects a crash
        after that step (a restart must be bit-exact)."""
        step = start_step
        end = start_step + n_steps
        try:
            while step < end:
                if self.guard.requested:
                    self.ckpt.save(step, state, blocking=True,
                                   extra_meta={"reason": "preempted"})
                    return step, state, "preempted"
                batch = self.batch_fn(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                _synchronize(state)
                dt = time.perf_counter() - t0
                step += 1
                if self.watchdog.observe(step, dt) and self.on_incident:
                    self.on_incident(self.watchdog.incidents[-1])
                m = dict(metrics)
                m.update(step=step, dt=dt)
                self.metrics_log.append(
                    {k: (float(v) if hasattr(v, "__float__") else v)
                     for k, v in m.items()})
                if fail_at is not None and step == fail_at:
                    raise RuntimeError(f"injected failure at step {step}")
                if step % self.ckpt_every == 0 or step == end:
                    self.ckpt.save(step, state, blocking=(step == end))
        except BaseException:
            # the restart resumes from the checkpoint the manifest already
            # names, so an in-flight write must land before the exception
            # escapes (and before any teardown removes its directory)
            self.ckpt.wait()
            raise
        self.ckpt.wait()
        return step, state, "done"
