"""AdaptiveGraph: the measure -> plan -> regroup control loop (a port of
the reference's `core/adapt.py`).

A `ServiceGraph` fixes every group's alpha when it is built, so a
drifting skew (PIC's current sheet moving, MapReduce's straggler splits)
erodes the decoupling win. This module closes the loop:

  measure   a `LoadLedger` accumulates each superstep's wall seconds and
            the counters (`dataflow.work_vector`'s per-row work,
            `dataflow.with_work_probe`'s per-stage items);
  plan      `calibrate` turns the ledger into the performance model's
            inputs (online t_w0 and sigma through
            `imbalance.empirical_sigma`, one `StageWorkload` per service
            stage), feeds `perfmodel.recommend_allocation`, and emits a
            `ReplanDecision` behind hysteresis: re-plan only when the
            predicted chain speedup clears a threshold, never inside the
            cooldown after a regroup, so the loop cannot oscillate;
  regroup   `ServiceGraph.regroup(rows)` builds the new row partition and
            its process groups; the application moves its row-partitioned
            state with `launch.elastic.reshard_state` and rebuilds its step.

`ReplanController` is the headless planner (usable at any scale without
a world); `AdaptiveGraph` binds it to a live `ServiceGraph`. The
controller, the ledger and the calibration are host logic over numpy,
copied value for value with the reference's reason strings.

One decision per world: every rank runs its own controller, so every
input of `AdaptiveGraph.step` must be the same on every rank, or two
ranks could disagree on a regroup and build their process groups in
different orders (a deadlock). The work vector comes from one sum over
the world (`work_vector`), stage items from a group sum broadcast to
every row, and the wall from `timed_call`, which takes the slowest row's.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.dataflow import ServiceGraph
from repro_torch.core.imbalance import empirical_sigma, empirical_t_sigma_work
from repro_torch.core.perfmodel import (
    StageWorkload,
    StreamCosts,
    recommend_allocation,
    t_decoupled_chain,
)
from repro_torch.obs import registry as _obs_metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.utils.treeutil import tree_leaves


@dataclasses.dataclass(frozen=True)
class StageTrait:
    """Per-stage calibration constants, declared by the application.

    ``cost_ratio`` converts one stage work item into compute-item time
    units (stage seconds per item / compute seconds per item);
    ``bytes_per_item`` is the dataflow streamed into the stage per item
    (the D_i of Eq. 4'). ``t_prime`` optionally overrides the stage's
    scaling law exactly as in `perfmodel.StageWorkload`.
    """

    name: str
    cost_ratio: float = 0.5
    bytes_per_item: float = 8.0
    t_prime: Callable[[float, int, int], float] | None = None


@dataclasses.dataclass(frozen=True)
class AdaptPolicy:
    """Hysteresis and planning knobs of the control loop.

    ``window`` supersteps of measurements are required before a plan is
    even attempted (and the ledger is cleared on regroup, so every
    regroup re-earns its window). ``speedup_threshold`` is the minimum
    predicted chain speedup (Eq. 4' at the proposed vs current rows)
    that justifies paying the rebuild + migration; ``cooldown``
    supersteps must pass after a regroup before the next one. Both
    gates together make oscillation structurally impossible: flipping
    back requires the same threshold in the opposite direction, at
    least ``cooldown + window`` supersteps later.
    """

    window: int = 4
    speedup_threshold: float = 1.08
    cooldown: int = 2
    row_budget: int | None = None  # max total service rows (default: half)
    min_compute_rows: int = 1
    s_bytes: float = 64e3
    o_seconds: float = 2e-6
    # supersteps an unapplied (pending) regroup decision survives before
    # the controller drops it and resumes planning — a caller that
    # declines to act can never freeze the loop. None: 4x the natural
    # staleness horizon (window + cooldown).
    pending_ttl: int | None = None

    @property
    def pending_ttl_steps(self) -> int:
        return (
            self.pending_ttl
            if self.pending_ttl is not None
            else 4 * (self.window + self.cooldown)
        )


class LoadLedger:
    """Sliding window of per-superstep load measurements.

    ``record(wall_s, work_per_row, stage_items)`` appends one
    superstep: host wall seconds, the per-COMPUTE-row work counter
    vector, and optionally per-stage consumed item counts (from
    `dataflow.with_work_probe`). Statistics are means over the window.
    """

    def __init__(self, window: int = 8):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = window
        self._wall: collections.deque[float] = collections.deque(maxlen=window)
        self._work: collections.deque[np.ndarray] = collections.deque(maxlen=window)
        self._stage_items: collections.deque[dict[str, float]] = collections.deque(
            maxlen=window
        )
        self.total_recorded = 0

    def record(
        self,
        wall_s: float,
        work_per_row: Iterable[float],
        stage_items: Mapping[str, float] | None = None,
    ) -> None:
        work = np.asarray(list(work_per_row), np.float64)
        if work.ndim != 1 or work.size == 0:
            raise ValueError(f"work_per_row must be a non-empty vector, got {work.shape}")
        self._wall.append(float(wall_s))
        self._work.append(work)
        self._stage_items.append(dict(stage_items or {}))
        self.total_recorded += 1
        _obs_metrics.REGISTRY.counter("adapt.load_samples").inc()

    def clear(self) -> None:
        """Forget the window — measurements of an old row partition do
        not describe the new one (called on regroup)."""
        self._wall.clear()
        self._work.clear()
        self._stage_items.clear()

    @property
    def n(self) -> int:
        return len(self._wall)

    def wall_mean(self) -> float:
        return float(np.mean(self._wall)) if self._wall else 0.0

    def work_matrix(self) -> np.ndarray:
        """(n_samples, n_rows) per-row work over the window."""
        if not self._work:
            return np.zeros((0, 0))
        return np.stack(list(self._work))

    def work_mean(self) -> float:
        w = self.work_matrix()
        return float(w.mean()) if w.size else 0.0

    def work_max_mean(self) -> float:
        """Mean over the window of the per-superstep max row work."""
        w = self.work_matrix()
        return float(w.max(axis=1).mean()) if w.size else 0.0

    def work_cv(self) -> float:
        w = self.work_matrix()
        if not w.size or w.mean() <= 0:
            return 0.0
        return float(w.std(axis=1).mean() / w.mean())

    def t_sigma_work(self) -> float:
        """Online T_sigma in work units (`imbalance.empirical_t_sigma_work`)."""
        w = self.work_matrix()
        return empirical_t_sigma_work(w) if w.size else 0.0

    def stage_items_mean(self, name: str, default: float) -> float:
        vals = [s[name] for s in self._stage_items if name in s]
        return float(np.mean(vals)) if vals else float(default)


@dataclasses.dataclass(frozen=True)
class ChainCalibration:
    """Measured perf-model inputs: the ledger expressed in Eq.-4' terms."""

    t_unit: float  # seconds per work item on the bottleneck row
    t_w0: float  # per-process coupled compute time at P rows
    sigma: float  # per-process time stddev (online T_sigma, inverted)
    stages: tuple[StageWorkload, ...]


def calibrate(
    ledger: LoadLedger,
    traits: Iterable[StageTrait],
    n_rows: int,
    n_compute: int,
) -> ChainCalibration | None:
    """Turn window measurements into `perfmodel` inputs.

    The model: per-row compute time is proportional to its work counter
    (data-dependent skew, the imbalance source `imbalance.py` models), so the superstep wall is dominated by the most
    loaded row: ``t_unit = wall / max_row_work``. From there

      * ``t_w0``   = t_unit * mean_work * n_compute / P (the coupled
        baseline spreads the same total work over all P rows),
      * ``sigma``  = the measured straggler penalty inverted through
        `t_sigma`'s closed form (`imbalance.empirical_sigma`), scaled
        to the coupled baseline like t_w0,
      * stage i    = StageWorkload with t_op from the stage's measured
        item count (or total work when unprobed) times the declared
        ``cost_ratio``, and D_i from ``bytes_per_item``.

    Returns None while the ledger has no usable signal (no samples or
    zero work), which the planner treats as "keep measuring".
    """
    w_max = ledger.work_max_mean()
    w_mean = ledger.work_mean()
    wall = ledger.wall_mean()
    if ledger.n == 0 or w_max <= 0.0 or wall <= 0.0:
        return None
    t_unit = wall / w_max
    scale = n_compute / n_rows  # redistribute measured work over all P rows
    t_w0 = t_unit * w_mean * scale
    sigma = empirical_sigma(ledger.work_matrix(), t_per_item=t_unit) * scale
    total_work = w_mean * n_compute
    stages = tuple(
        StageWorkload(
            name=tr.name,
            t_op=tr.cost_ratio
            * t_unit
            * ledger.stage_items_mean(tr.name, total_work)
            / n_rows,
            d_bytes=tr.bytes_per_item
            * ledger.stage_items_mean(tr.name, total_work)
            / n_rows,
            t_prime=tr.t_prime,
        )
        for tr in traits
    )
    return ChainCalibration(t_unit=t_unit, t_w0=t_w0, sigma=sigma, stages=stages)


@dataclasses.dataclass(frozen=True)
class ReplanDecision:
    """One planning verdict. ``regroup=False`` decisions carry the
    reason (warming up, cooldown, below threshold, already optimal)."""

    regroup: bool
    rows: dict[str, int]  # proposed per-stage rows (current when not regrouping)
    predicted_speedup: float
    reason: str
    calibration: ChainCalibration | None = None


class ReplanController:
    """The headless planner: current row vector + ledger + hysteresis.

    Drives the loop at any scale without a mesh — benchmarks evaluate
    it at paper scales; `AdaptiveGraph` binds it to a live graph.
    """

    def __init__(
        self,
        n_rows: int,
        rows: Mapping[str, int],
        traits: Iterable[StageTrait],
        policy: AdaptPolicy | None = None,
    ):
        self.n_rows = int(n_rows)
        self.rows = {k: int(v) for k, v in rows.items()}
        self.traits = tuple(traits)
        names = {t.name for t in self.traits}
        if names != set(self.rows):
            raise ValueError(
                f"traits {sorted(names)} must match stages {sorted(self.rows)}"
            )
        self.policy = policy or AdaptPolicy()
        self.ledger = LoadLedger(self.policy.window)
        self.history: list[ReplanDecision] = []
        self._since_regroup = math.inf  # supersteps since the last regroup
        # a regroup decision the caller has not applied yet. Appliers
        # that must wait for a safe point (the serving fleet cannot
        # shrink the decode pool under in-flight slots) leave it here;
        # plan() holds further verdicts until it is applied, discarded,
        # or expired (policy.pending_ttl_steps), so a deferred regroup
        # cannot be thrashed by a newer plan from the same stale window
        # — and a caller that never applies cannot freeze the loop.
        self.pending: ReplanDecision | None = None
        self._pending_age = 0

    # -- measure -----------------------------------------------------------
    def record(
        self,
        wall_s: float,
        work_per_row: Iterable[float],
        stage_items: Mapping[str, float] | None = None,
    ) -> None:
        self.ledger.record(wall_s, work_per_row, stage_items)
        self._since_regroup += 1
        if self.pending is not None:
            self._pending_age += 1

    # -- plan --------------------------------------------------------------
    def _no(self, reason: str, cal: ChainCalibration | None = None) -> ReplanDecision:
        d = ReplanDecision(False, dict(self.rows), 1.0, reason, cal)
        self.history.append(d)
        return d

    def plan(self) -> ReplanDecision:
        pol = self.policy
        if self.pending is not None:
            if self._pending_age > pol.pending_ttl_steps:
                self.discard_pending()  # stale — resume planning
            else:
                return self._no("pending regroup awaiting application")
        if self.ledger.n < pol.window:
            return self._no(f"warming up ({self.ledger.n}/{pol.window} samples)")
        if self._since_regroup <= pol.cooldown:
            return self._no(f"cooldown ({self._since_regroup}/{pol.cooldown})")
        n = self.n_rows
        n_compute = n - sum(self.rows.values())
        cal = calibrate(self.ledger, self.traits, n, n_compute)
        if cal is None:
            return self._no("no work measured")
        costs = StreamCosts(o_seconds=pol.o_seconds)
        t_cur = t_decoupled_chain(
            cal.t_w0, cal.stages, cal.sigma, n, self.rows, pol.s_bytes, costs
        )
        budget = pol.row_budget if pol.row_budget is not None else n // 2
        budget = min(budget, n - pol.min_compute_rows)
        plan = recommend_allocation(
            cal.t_w0, cal.stages, cal.sigma, n, pol.s_bytes, costs, budget
        )
        speedup = t_cur / plan.t if plan.t > 0 else 1.0
        if plan.rows == self.rows:
            return self._no("already optimal", cal)
        if speedup < pol.speedup_threshold:
            return self._no(
                f"predicted speedup {speedup:.3f} < threshold "
                f"{pol.speedup_threshold}",
                cal,
            )
        d = ReplanDecision(True, dict(plan.rows), speedup, "replan", cal)
        self.history.append(d)
        self.pending = d
        self._pending_age = 0
        return d

    def step(
        self,
        wall_s: float,
        work_per_row: Iterable[float],
        stage_items: Mapping[str, float] | None = None,
    ) -> ReplanDecision:
        """record + plan: the per-superstep entry point."""
        self.record(wall_s, work_per_row, stage_items)
        return self.plan()

    # -- regroup -----------------------------------------------------------
    def apply(self, decision: ReplanDecision) -> dict[str, int]:
        """Commit a regroup decision: adopt the rows, clear the ledger
        (old-partition measurements don't describe the new one), start
        the cooldown."""
        if not decision.regroup:
            raise ValueError("cannot apply a non-regroup decision")
        self.rows = dict(decision.rows)
        self.ledger.clear()
        self._since_regroup = 0
        self.pending = None
        _obs_metrics.REGISTRY.counter("adapt.regroups").inc()
        self._pending_age = 0
        return dict(self.rows)

    def discard_pending(self) -> None:
        """Drop an unapplied regroup decision (the caller decided not
        to act, or it expired); planning resumes on the next plan()."""
        self.pending = None
        self._pending_age = 0


class AdaptiveGraph:
    """A `ServiceGraph` plus the closed control loop.

    Usage (one superstep, on every rank of the world)::

        out, wall = timed_call(step, state, mesh=mesh)
        decision = ag.step(wall, work_per_row, stage_items={"reduce": n})
        if decision.regroup:
            ag.apply(decision)          # collective: new process groups
            state = migrate(state)      # elastic.reshard_state / re-layout
            step = rebuild(ag.graph)    # the step on the new partition

    With imbalance absent the hysteresis never fires, no regroup ever
    happens, and the sequence of steps, hence the output bits, is
    identical to driving the static `ServiceGraph` directly.
    """

    def __init__(
        self,
        graph: ServiceGraph,
        traits: Iterable[StageTrait],
        policy: AdaptPolicy | None = None,
    ):
        self.graph = graph
        rows = {g.name: g.size for g in graph.gmesh.service_groups}
        self.controller = ReplanController(
            graph.gmesh.axis_size, rows, traits, policy
        )

    @property
    def ledger(self) -> LoadLedger:
        return self.controller.ledger

    @property
    def rows(self) -> dict[str, int]:
        return dict(self.controller.rows)

    @property
    def history(self) -> list[ReplanDecision]:
        return self.controller.history

    def record(self, wall_s, work_per_row, stage_items=None) -> None:
        self.controller.record(wall_s, work_per_row, stage_items)

    def plan(self) -> ReplanDecision:
        return self.controller.plan()

    def step(self, wall_s, work_per_row, stage_items=None) -> ReplanDecision:
        return self.controller.step(wall_s, work_per_row, stage_items)

    def discard_pending(self) -> None:
        """Decline an unapplied regroup decision; planning resumes."""
        self.controller.discard_pending()

    def apply(self, decision: ReplanDecision) -> ServiceGraph:
        """Commit: regroup the graph onto the decision's row vector
        (collective in a world: every rank applies the same decision)."""
        self.graph = self.graph.regroup(
            decision.rows,
            min_compute_rows=self.controller.policy.min_compute_rows,
        )
        self.controller.apply(decision)
        return self.graph


def _block_until_ready(out: Any) -> None:
    """Wait for the device work behind every CUDA tensor of ``out``."""
    for dev in {t.device for t in tree_leaves(out) if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def agreed_wall(mesh, wall_s: float) -> float:
    """The slowest row's ``wall_s``: one MAX over the world (f64), the same
    on every rank; ``wall_s`` itself outside a world."""
    if mesh is None or not mesh.in_world:
        return float(wall_s)
    out = mesh.all_reduce(torch.tensor([wall_s], dtype=torch.float64), op=dist.ReduceOp.MAX)
    return float(out[0])


def timed_call(fn: Callable[..., Any], *args: Any, mesh=None) -> tuple[Any, float]:
    """The superstep timer: call, wait for this rank's device, and return
    (out, wall seconds). The reference blocks on the whole SPMD program,
    so its wall is the slowest row's; here ``mesh`` (this rank's
    `launch.mesh.Mesh`) is synchronised and the wall agreed as the maximum
    over the world's rows (`agreed_wall`), so every rank records the same
    sample. Without ``mesh``, the local wall after the outputs' devices
    are synchronised."""
    t0 = time.perf_counter()
    out = fn(*args)
    if mesh is not None:
        mesh.sync()
    else:
        _block_until_ready(out)
    return out, agreed_wall(mesh, time.perf_counter() - t0)


# -- first-use guards ----------------------------------------------------------------
# The first call on a new partition pays first-use costs (new process
# groups, the allocator's growth, the kernels' first launches), and a
# ledger sample polluted by them would trigger a spurious replan. Two
# idioms, as in the reference:


def warmed_step(cache: dict, key: Any, build: Callable[[], Callable],
                *warmup_args: Any) -> Callable:
    """Build-and-warm a step per ``key``, outside the ledger's wall samples.

    On a cache miss, ``build()`` makes the step and one warmup call runs
    to completion under a ``compile`` span (obs.trace), so first-use time
    shows on timelines instead of polluting the first measured sample.
    Only for steps whose warmup call has no side effects (in a world, the
    warmup is collective: every rank warms alike); a step that updates
    real state in place uses `CompileGate` instead."""
    fn = cache.get(key)
    if fn is None:
        with _obs_trace.span("compile", ("adapt", "compile"), key=str(key)):
            fn = build()
            _block_until_ready(fn(*warmup_args))
        cache[key] = fn
    return fn


class CompileGate:
    """Skip the first wall sample after every (re)build, for steps that
    cannot be warmed (the in-place trainer step, where a warmup call would
    apply a real update).

    ``sample(wall_s)`` returns whether the sample is clean; the first
    call after construction or `rebuilt()` returns False and emits the
    measured first-use wall as a ``compile`` span."""

    def __init__(self):
        self._fresh = True

    def rebuilt(self) -> None:
        self._fresh = True

    def sample(self, wall_s: float) -> bool:
        if not self._fresh:
            return True
        self._fresh = False
        _obs_trace.complete("compile", wall_s, ("adapt", "compile"))
        return False


__all__ = [
    "AdaptPolicy",
    "AdaptiveGraph",
    "ChainCalibration",
    "CompileGate",
    "LoadLedger",
    "ReplanController",
    "ReplanDecision",
    "StageTrait",
    "agreed_wall",
    "calibrate",
    "timed_call",
    "warmed_step",
]
