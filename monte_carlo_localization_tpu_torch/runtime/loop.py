"""Live dual-rate update loop — the reference's wall-timer scheduler, as
the JAX package's ``runtime/loop.py``.

The reference creates a wall timer at ``timer_frequency`` Hz that runs
``timer_update`` on every tick (reference src/particle_filter.cpp:154-159,
:720-846) while odometry callbacks arrive on other executor threads at
100-200 Hz. Contention is handled with ``try_lock``: a tick that finds the
previous update still running is skipped (reference :756).

:class:`LiveRunner` reproduces that scheduling on a host thread:

* ticks at ``config.timer_frequency`` Hz against the monotonic clock;
* **skip-on-overrun**: when a correction takes longer than the period,
  the missed ticks are dropped — the deadline is re-based to now rather
  than backlogged, the sequential-thread analogue of try_lock's skip;
* every tick publishes TF/odom from the pose priority chain whether or
  not MCL ran (reference :839-845);
* odometry keeps flowing through ``node.on_odometry`` from any thread —
  the tracker is mutex-protected.

The thread makes the node's card its current device before it ticks, so
the node's launches and readbacks go to that card's stream.
"""

from __future__ import annotations

import threading
import time

import torch

from monte_carlo_localization_tpu_torch.runtime.node import MCLNode


class LiveRunner:
    """Threaded wall-clock scheduler around an :class:`MCLNode`."""

    def __init__(self, node: MCLNode, timer_frequency: float | None = None):
        self.node = node
        freq = timer_frequency or node.config.timer_frequency
        if freq <= 0:
            raise ValueError(f"timer_frequency must be > 0, got {freq}")
        self.period = 1.0 / freq
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.ticks = 0
        self.corrections = 0
        self.skipped = 0
        self.error: BaseException | None = None  # re-raised by stop()

    def start(self) -> "LiveRunner":
        if self._thread is not None:
            raise RuntimeError("already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if self.error is not None:
            # a scheduler-thread failure must not look like a clean run
            # with zero corrections — surface it to the caller
            err, self.error = self.error, None
            raise RuntimeError("LiveRunner scheduler thread failed") from err

    def __enter__(self) -> "LiveRunner":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        try:
            if self.node.device.type == "cuda":
                torch.cuda.set_device(self.node.device)
            self._run_loop()
        except BaseException as e:  # noqa: BLE001 - stored, re-raised in stop()
            self.error = e

    def _run_loop(self) -> None:
        next_t = time.monotonic()
        while not self._stop.is_set():
            now = time.monotonic()
            if now < next_t:
                time.sleep(min(next_t - now, 0.002))
                continue
            # skip-on-overrun (try_lock analogue, reference :756): if the
            # last update overran, drop the missed ticks instead of
            # backlogging them
            missed = int((now - next_t) / self.period)
            if missed > 0:
                self.skipped += missed
            next_t = max(next_t + self.period, now - self.period / 2)

            self.ticks += 1
            pose = self.node.update(now=now)
            if pose is not None:
                self.corrections += 1
                self.node.publish_correction(now, pose)
            # TF publishes every tick regardless (reference :839-845)
            self.node.publish_tick(now)
