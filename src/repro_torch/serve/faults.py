"""Deterministic failure injection for the serving fleet (FaultFleet; a
copy of the reference's `serve/faults.py`, draw for draw: the fleet
that consumes the monitor is ROADMAP A9).

The paper's decoupling results live at thousands of processes — a scale
where device loss and preemption are routine, not exceptional. Raicu et
al.'s loosely-coupled dispatch (PAPERS.md) survives worker loss by
re-issuing orphaned work; this module is the serving-side analogue: a
seeded `FaultSchedule` declares device-loss / preemption / slow-node
events per traffic scenario, and a `FailureMonitor` folds them into the
per-tick health signal `FleetEngine` polls. Everything downstream of the
monitor — mesh shrink through `launch/elastic.healthy_mesh`, in-flight
KV migration, checkpoint restore, re-admission with original arrival
timestamps — lives in `serve/fleet.py`; this module is pure bookkeeping
(stdlib + numpy only) so `serve/traffic.py` can import it without
cycles.

Fault kinds:

  * ``device_loss`` — ``rows`` decode rows vanish without warning and
    never return. KV held only on those rows is gone; orphaned requests
    take the drop-and-retry or checkpoint-restore path.
  * ``preempt`` — ``rows`` rows leave WITH notice (the cloud
    preemption contract): the engine gets one tick to stage their slots
    to host, so recovery is a pure in-memory migration. ``duration`` > 0
    ticks later the rows come back and the fleet re-grows;
    ``duration`` = 0 means they never return.
  * ``slow_node`` — no rows leave; every tick's wall time is stretched
    by ``factor`` for ``duration`` ticks (a straggler, the case the
    `healthy_mesh_with_backoff` probe exists to NOT shrink on).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

import numpy as np

KINDS = ("device_loss", "preempt", "slow_node")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``tick`` is the engine tick it fires on."""

    tick: int
    kind: str  # device_loss | preempt | slow_node
    rows: int = 1  # rows affected (device_loss / preempt)
    duration: int = 0  # preempt: ticks until rows return (0 = never);
    #                    slow_node: ticks the slowdown lasts
    factor: float = 4.0  # slow_node: wall-time multiplier

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.tick < 0:
            raise ValueError(f"tick must be >= 0, got {self.tick}")
        if self.kind != "slow_node" and self.rows < 1:
            raise ValueError(f"rows must be >= 1, got {self.rows}")
        if self.duration < 0:
            raise ValueError(f"duration must be >= 0, got {self.duration}")
        if self.kind == "slow_node" and self.factor < 1.0:
            raise ValueError(f"factor must be >= 1, got {self.factor}")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An ordered, deterministic sequence of `FaultEvent`s."""

    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "events", tuple(sorted(self.events, key=lambda e: e.tick))
        )

    def at(self, tick: int) -> tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.tick == tick)

    @staticmethod
    def generate(
        horizon: int,
        *,
        seed: int = 0,
        p_loss: float = 0.0,
        p_preempt: float = 0.0,
        p_slow: float = 0.0,
        max_rows: int = 1,
        preempt_duration: int = 8,
        slow_duration: int = 4,
        slow_factor: float = 4.0,
    ) -> "FaultSchedule":
        """Seeded per-tick Bernoulli draws — same seed, same faults."""
        rng = np.random.default_rng(seed)
        events = []
        for t in range(horizon):
            u = rng.random(3)
            if u[0] < p_loss:
                events.append(
                    FaultEvent(t, "device_loss",
                               rows=int(rng.integers(1, max_rows + 1)))
                )
            if u[1] < p_preempt:
                events.append(
                    FaultEvent(t, "preempt",
                               rows=int(rng.integers(1, max_rows + 1)),
                               duration=preempt_duration)
                )
            if u[2] < p_slow:
                events.append(
                    FaultEvent(t, "slow_node", duration=slow_duration,
                               factor=slow_factor)
                )
        return FaultSchedule(tuple(events))


@dataclasses.dataclass(frozen=True)
class FleetHealth:
    """What the monitor reports for one tick."""

    tick: int
    events: tuple[FaultEvent, ...] = ()  # shrink events, rows pre-clamped
    returned_rows: int = 0  # preempted rows back this tick
    slow_factor: float = 1.0  # wall-time stretch in effect


class FailureMonitor:
    """Folds a `FaultSchedule` (plus mid-replay injections) into the
    per-tick health signal the engine polls.

    The monitor owns the row arithmetic — clamping a loss so at least
    ``min_rows`` rows survive, scheduling preempted rows' return,
    capping a re-grow at the fleet's original size — so the engine only
    ever sees realizable events. It deliberately does NOT know about
    meshes or KV: `prober()` adapts the healthy-row count for
    `healthy_mesh_with_backoff`, and everything else is the engine's
    recovery path.
    """

    def __init__(self, schedule: FaultSchedule | None, n_rows: int,
                 *, min_rows: int = 2):
        if n_rows < min_rows:
            raise ValueError(f"n_rows={n_rows} < min_rows={min_rows}")
        self.n_rows_max = n_rows
        self.min_rows = min_rows
        self.healthy_rows = n_rows
        self._pending: dict[int, list[FaultEvent]] = {}
        self._returns: dict[int, int] = {}
        self._slow: list[tuple[int, int, float]] = []  # (start, end, factor)
        self.fired: list[FaultEvent] = []
        for ev in (schedule.events if schedule is not None else ()):
            self._pending.setdefault(ev.tick, []).append(ev)

    def inject(self, event: FaultEvent) -> None:
        """Queue a fault mid-replay (the `fail_at`/`preempt_at` hook)."""
        self._pending.setdefault(event.tick, []).append(event)

    def poll(self, tick: int) -> FleetHealth:
        """Consume every event due at or before ``tick``.

        Returns are processed first (a row that comes back the same tick
        another dies can absorb the loss), then shrinks, clamped so the
        fleet never dips below ``min_rows``."""
        returned = 0
        for t in sorted(k for k in self._returns if k <= tick):
            back = self._returns.pop(t)
            back = min(back, self.n_rows_max - self.healthy_rows)
            self.healthy_rows += back
            returned += back
        shrinks: list[FaultEvent] = []
        for t in sorted(k for k in self._pending if k <= tick):
            for ev in self._pending.pop(t):
                if ev.kind == "slow_node":
                    self._slow.append((tick, tick + max(ev.duration, 1),
                                       ev.factor))
                    self.fired.append(ev)
                    continue
                rows = min(ev.rows, self.healthy_rows - self.min_rows)
                if rows <= 0:
                    continue  # unrealizable: the floor holds the fleet up
                self.healthy_rows -= rows
                if ev.kind == "preempt" and ev.duration > 0:
                    back_at = tick + ev.duration
                    self._returns[back_at] = self._returns.get(back_at, 0) + rows
                clamped = dataclasses.replace(ev, rows=rows)
                shrinks.append(clamped)
                self.fired.append(clamped)
        return FleetHealth(
            tick=tick,
            events=tuple(shrinks),
            returned_rows=returned,
            slow_factor=self.slow_factor(tick),
        )

    def slow_factor(self, tick: int) -> float:
        """Wall-time stretch from every slow-node window covering tick."""
        f = 1.0
        for start, end, factor in self._slow:
            if start <= tick < end:
                f *= factor
        return f

    def prober(self, devices_per_row: int = 1) -> Callable[[], int]:
        """Healthy device count as `healthy_mesh_with_backoff` sees it."""
        return lambda: self.healthy_rows * devices_per_row


def events_from_hooks(
    horizon: int,
    *,
    fail_at: int | None = None,
    preempt_at: int | None = None,
    fault_rows: int = 1,
    preempt_duration: int = 0,
) -> tuple[FaultEvent, ...]:
    """The `replay(fail_at=..., preempt_at=...)` convenience hooks as
    explicit events (clamped into the replay horizon)."""
    events = []
    if fail_at is not None:
        events.append(
            FaultEvent(min(max(int(fail_at), 0), horizon), "device_loss",
                       rows=fault_rows)
        )
    if preempt_at is not None:
        events.append(
            FaultEvent(min(max(int(preempt_at), 0), horizon), "preempt",
                       rows=fault_rows, duration=preempt_duration)
        )
    return tuple(events)


def validate_events(events: Iterable[FaultEvent] | Sequence[FaultEvent]):
    """Type-check a scenario's fault tuple at construction time."""
    events = tuple(events)
    for ev in events:
        if not isinstance(ev, FaultEvent):
            raise TypeError(f"faults must be FaultEvent, got {type(ev).__name__}")
    return events


__all__ = [
    "FaultEvent",
    "FaultSchedule",
    "FailureMonitor",
    "FleetHealth",
    "events_from_hooks",
    "validate_events",
]
