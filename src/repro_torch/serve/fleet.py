"""The serving fleet of the port: the traffic-driven closed loop over the
prefill/decode split, with its fault paths (the counterpart of the
reference's `serve/fleet.py`).

A `FleetEngine` wraps the disaggregated engine with

  measure   every tick lands in the `FleetLedger` (wall seconds, measured
            or from a caller's virtual clock, with the prompt tokens each
            prefill row retired and the active slots of each decode row)
            and goes to a `core.adapt.ReplanController` sample by sample;
  plan      the controller calibrates the window (`core.adapt.calibrate`)
            into `perfmodel.recommend_allocation` with one service stage,
            ``prefill``: the serving instance of Eq. 4' (compute = the
            decode fleet, service = the prefill group), behind the usual
            hysteresis;
  regroup   `ServiceGraph.regroup({"prefill": rows})` re-partitions the
            serving topology when a mesh is bound, and `DisaggEngine.resize`
            applies the split: pending prompts re-admit onto the new prefill
            rows and every in-flight KV slot migrates into the re-sized
            decode pool. A shrink that cannot hold the occupied slots is
            deferred until enough requests drain (a regroup never drops a
            request), and dropped after ``max_deferrals`` ticks.

Faults (`serve/faults.py`): a device loss orphans the dying rows'
requests, which come back from the last serving checkpoint or from
scratch; a preemption with notice stages the dying rows' slots to the
host and the rows later return. Every orphan re-enters through the
scheduler with its original arrival tick.

`reshard_serving_state` and `reshard_paged_serving_state` are the SPMD
layer's counterparts: they move `disagg.init_disagg_state`'s slot layout
between two row splits. The reference moves sharded arrays between meshes
of any sizes; here (a decision recorded in ROADMAP) the global layout, every
row's slots on one device, moves between planning `GroupedMesh`es of any
sizes by the reference's host arithmetic, and inside a rank world each
rank's row moves through `launch.elastic.reshard_state` between two splits
of the world's one size.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.adapt import AdaptPolicy, ReplanController, StageTrait
from repro_torch.core.groups import GroupedMesh
from repro_torch.launch.elastic import healthy_mesh_with_backoff, repack_block_pool, reshard_state
from repro_torch.obs import registry as _metrics
from repro_torch.obs import trace as _obs
from repro_torch.serve.api import ServeConfig
from repro_torch.serve.disagg import PREFILL, DisaggConfig, DisaggEngine, serving_graph
from repro_torch.serve.faults import FailureMonitor, FaultEvent, FaultSchedule
from repro_torch.serve.sched import FleetScheduler

# the control loop's track (obs.trace): replan, regroup, fault and
# checkpoint markers and the per-tick counter series land here
_T_FLEET = ("fleet", "control")


@dataclasses.dataclass
class FleetConfig(ServeConfig):
    """Sizing and adaptation knobs of a serving fleet.

    ``n_rows`` is the row budget (prefill + decode); ``slots_per_row``
    turns decode rows into decode slots, so a regroup that moves a row
    between the groups re-sizes the slot pool too. ``adapt=None`` freezes
    the split (the static disaggregated baseline); an `AdaptPolicy`
    closes the loop. ``prefill_cost_ratio`` / ``prefill_bytes_per_token``
    are the prefill stage's `StageTrait` constants: seconds per prompt
    token over seconds per decode slot-step, and KV bytes migrated per
    prompt token. The inherited `ServeConfig` fields go to the wrapped
    `DisaggEngine`."""

    n_rows: int = 8
    prefill_rows: int = 2
    slots_per_row: int = 2
    prefill_chunk: int = 32
    adapt: AdaptPolicy | None = None
    prefill_cost_ratio: float = 1.0
    prefill_bytes_per_token: float = 256.0
    # a deferred regroup (a shrink blocked by occupied slots) is dropped
    # after this many ticks: under sustained load the pool may never drain
    # below the proposed size, and a held decision would both freeze
    # planning and apply a verdict from a long-gone load window
    max_deferrals: int = 8
    # per-tick records kept on FleetEngine.report, a ring bounded by
    # default (cumulative totals stay exact on the ledger; the whole history
    # goes through obs.trace when a tracer is on); None = unbounded
    report_window: int | None = 256
    # -- faults (serve/faults.py) ------------------------------------------
    # a deterministic fault schedule; None = a healthy fleet
    faults: FaultSchedule | None = None
    # the fleet never shrinks below this many rows (one row cannot hold
    # both a prefill and a decode group)
    min_rows: int = 2
    # the orphans of a row lost WITHOUT notice: "retry" admits them again
    # from scratch, "checkpoint" resumes decode from the last
    # `ServingCheckpointer` snapshot (retrying what the snapshot predates)
    recovery: str = "retry"
    # periodic serving-state snapshots (serve/checkpoint_bridge.py): every
    # `ckpt_cadence` ticks into `ckpt_dir`; 0 = off
    ckpt_dir: str | None = None
    ckpt_cadence: int = 0
    # healthy_mesh_with_backoff's knobs on the mesh-bound fault path
    probe_attempts: int = 2
    probe_base_delay: float = 0.01

    def __post_init__(self):
        super().__post_init__()
        if self.recovery not in ("retry", "checkpoint"):
            raise ValueError(f"recovery must be 'retry' or 'checkpoint', got {self.recovery!r}")
        if self.faults is not None and self.mode != "continuous":
            raise ValueError("fault recovery needs mode='continuous' (mid-stream slot "
                             "restores require per-slot cursors)")
        if self.recovery == "checkpoint" and (self.ckpt_dir is None or self.ckpt_cadence <= 0):
            raise ValueError("recovery='checkpoint' needs ckpt_dir and ckpt_cadence > 0")
        if self.ckpt_cadence > 0 and self.ckpt_dir is None:
            raise ValueError("ckpt_cadence > 0 needs ckpt_dir")

    @property
    def decode_rows(self) -> int:
        return self.n_rows - self.prefill_rows


class FleetEngine:
    """`DisaggEngine` + `FleetScheduler` + the closed control loop.

    ``clock`` maps an engine tick report (`DisaggEngine.last_tick`) to
    that tick's wall seconds (a virtual clock); without it the measured
    host wall feeds the ledger. ``mesh`` (a `launch.mesh.Mesh`, planning
    or in a world) binds a `ServiceGraph` that every regroup re-partitions
    (`ServiceGraph.regroup`); without it the split is tracked as numbers
    alone (the host engine needs no mesh to run)."""

    def __init__(self, model, params, cfg: FleetConfig, sched: FleetScheduler | None = None,
                 *, mesh=None, clock: Callable[[dict], float] | None = None):
        if not 0 < cfg.prefill_rows < cfg.n_rows:
            raise ValueError(f"prefill_rows={cfg.prefill_rows} must leave >= 1 decode row "
                             f"of {cfg.n_rows}")
        self.cfg = cfg
        self.clock = clock
        self.model = model
        self.params = params
        self.prefill_rows = cfg.prefill_rows
        # the live row budget: cfg.n_rows is the provisioned fleet, n_rows the
        # rows healthy now (faults shrink it, returning rows grow it back)
        self.n_rows = cfg.n_rows
        self.eng = DisaggEngine(
            model, params,
            DisaggConfig(n_prefill_rows=cfg.prefill_rows,
                         decode_slots=cfg.decode_rows * cfg.slots_per_row,
                         max_len=cfg.max_len, eos_id=cfg.eos_id, mode=cfg.mode, kv=cfg.kv,
                         prefill_chunk=cfg.prefill_chunk),
            sched=sched)
        self.graph = None
        self._mesh = mesh
        if mesh is not None:
            if mesh.shape["data"] != cfg.n_rows:
                raise ValueError(f"mesh data axis ({mesh.shape['data']}) must match "
                                 f"n_rows={cfg.n_rows}")
            self.graph = serving_graph(GroupedMesh.build_rows(
                mesh, rows={PREFILL: cfg.prefill_rows}))
        self.controller = None
        if cfg.adapt is not None:
            self.controller = self._build_controller(cfg.n_rows, cfg.prefill_rows)
        self.regroups = 0
        self.deferrals = 0
        self.discarded = 0
        self._pending_age = 0
        self.report: collections.deque[dict] = collections.deque(maxlen=cfg.report_window)
        # -- fault machinery -----------------------------------------------
        self.monitor = None
        if cfg.faults is not None:
            self.monitor = FailureMonitor(cfg.faults, cfg.n_rows, min_rows=cfg.min_rows)
        self.ckpt = None
        if cfg.ckpt_dir is not None and cfg.ckpt_cadence > 0:
            from repro_torch.serve.checkpoint_bridge import ServingCheckpointer

            self.ckpt = ServingCheckpointer(cfg.ckpt_dir, cadence=cfg.ckpt_cadence)
        # bounded like report: the cumulative story lives in faults_total,
        # recoveries and regrows, the whole event stream in the tracer
        self.fault_log: collections.deque[dict] = collections.deque(maxlen=cfg.report_window)
        self.faults_total = 0
        self.recoveries = {"staged": 0, "restored": 0, "retried": 0}
        self.regrows = 0

    def _build_controller(self, n_rows: int, prefill_rows: int):
        """A fresh planning loop sized to the (possibly degraded) fleet,
        rebuilt after every shrink or grow: `ReplanController` bakes the
        row budget into its recommendation."""
        cfg = self.cfg
        return ReplanController(
            n_rows, {PREFILL: prefill_rows},
            traits=(StageTrait(PREFILL, cost_ratio=cfg.prefill_cost_ratio,
                               bytes_per_item=cfg.prefill_bytes_per_token),),
            policy=cfg.adapt)

    # -- engine facade -----------------------------------------------------
    @property
    def ledger(self):
        return self.eng.ledger

    @property
    def sched(self):
        return self.eng.sched

    @property
    def finished(self):
        return self.eng.finished

    @property
    def stats(self):
        return self.eng.stats

    @property
    def decode_slots(self) -> int:
        return len(self.eng.slots)

    def submit(self, req) -> bool:
        return self.eng.submit(req)

    def idle(self) -> bool:
        return self.eng.idle()

    def workload_sample(self) -> dict:
        return self.eng.workload_sample()

    # -- the per-tick loop -------------------------------------------------
    def _work_signals(self, tick: dict) -> tuple[list[float], list[float]]:
        """(prompt tokens each prefill row retired, active slots of each
        decode row) of one tick: the measure leg's two vectors."""
        prefill = [float(w) for w in tick.get("prefill_tokens_per_row", [])]
        active = tick.get("slots_active", [])
        spr = self.cfg.slots_per_row
        decode = [float(sum(active[r * spr : (r + 1) * spr]))
                  for r in range(max(len(active) // spr, 1))]
        return prefill, decode

    def step(self, wall_s: float | None = None) -> dict:
        """One engine tick and one turn of the control loop. ``wall_s``
        overrides the tick's wall seconds (a replay on a virtual clock);
        otherwise ``clock(last_tick)`` or the measured host wall."""
        fault_events = self._poll_faults()
        t0 = time.perf_counter()
        self.eng.step()
        measured = time.perf_counter() - t0
        tick = self.eng.last_tick
        if wall_s is None:
            wall_s = self.clock(tick) if self.clock is not None else measured
        if self.monitor is not None:
            # a straggler stretches the whole lockstep tick: decode is
            # batched, so the slowest row sets the tick's wall
            wall_s *= self.monitor.slow_factor(self.eng.tick)
        if self.ckpt is not None and self.ckpt.maybe_save(self.eng, self.eng.tick):
            _metrics.REGISTRY.counter("fleet.ckpt_saves").inc()
            _obs.instant("checkpoint_save", _T_FLEET, tick=self.eng.tick)
        prefill_work, decode_work = self._work_signals(tick)
        # one sample feeds two windows of different lifetimes: the
        # FleetLedger's (observability, never cleared) and the controller's
        # LoadLedger (the planning window, cleared on every regroup)
        self.ledger.record_tick(wall_s=wall_s, prefill_work_rows=prefill_work,
                                decode_work_rows=decode_work,
                                queue_depth=self.eng.workload_sample()["queue_depth"])
        rec = {"tick": self.eng.tick, "wall_s": wall_s, "rows": self.n_rows,
               "prefill_rows": self.prefill_rows, "decode_slots": self.decode_slots,
               "regrouped": False, "deferred": False, "discarded": False,
               "decision": None, "faults": fault_events}
        if self.controller is not None:
            decision = self.controller.step(wall_s, decode_work, {PREFILL: sum(prefill_work)})
            rec["decision"] = decision.reason
            if decision.regroup:
                # a fresh verdict this tick (retries of a pending one don't mark)
                if _obs.enabled():
                    _obs.instant("replan", _T_FLEET, reason=str(decision.reason),
                                 prefill_rows=int(decision.rows[PREFILL]), tick=self.eng.tick)
                _metrics.REGISTRY.counter("fleet.replans").inc()
            pending = self.controller.pending
            if pending is not None:
                if self._try_regroup(pending):
                    rec["regrouped"] = True
                    if _obs.enabled():
                        _obs.instant("regroup", _T_FLEET, tick=self.eng.tick,
                                     prefill_rows=self.prefill_rows,
                                     decode_slots=self.decode_slots)
                    _metrics.REGISTRY.counter("fleet.regroups").inc()
                    self._pending_age = 0
                else:
                    rec["deferred"] = True
                    self.deferrals += 1
                    self._pending_age += 1
                    if self._pending_age > self.cfg.max_deferrals:
                        # stale: the window behind this shrink has drained
                        # past; drop it and plan afresh
                        self.controller.discard_pending()
                        self.discarded += 1
                        self._pending_age = 0
                        rec["discarded"] = True
        rec["prefill_rows"] = self.prefill_rows
        rec["decode_slots"] = self.decode_slots
        self.report.append(rec)
        reg = _metrics.REGISTRY
        reg.gauge("fleet.rows").set(float(self.n_rows))
        reg.gauge("fleet.prefill_rows").set(float(self.prefill_rows))
        if _obs.enabled():
            # the whole control-loop history: the ring above may wrap, the
            # trace keeps every tick (up to the tracer's own ring)
            _obs.complete("tick", wall_s, _T_FLEET, tick=rec["tick"], rows=rec["rows"],
                          prefill_rows=rec["prefill_rows"], decode_slots=rec["decode_slots"],
                          decision=rec["decision"])
            _obs.counter("fleet", {"rows": rec["rows"], "prefill_rows": rec["prefill_rows"],
                                   "queue_depth": float(
                                       self.eng.workload_sample()["queue_depth"])}, _T_FLEET)
        return rec

    def _try_regroup(self, decision) -> bool:
        """Apply a pending regroup if the decode pool can absorb it."""
        new_pre = int(decision.rows[PREFILL])
        # against the LIVE row budget: after a shrink the planner already
        # targets the degraded fleet
        new_slots = (self.n_rows - new_pre) * self.cfg.slots_per_row
        occupied = sum(s is not None for s in self.eng.slots)
        if occupied > new_slots:
            return False  # defer: the shrink would strand in-flight slots
        if self.graph is not None:
            self.graph = self.graph.regroup({PREFILL: new_pre})
        self.eng.resize(new_pre, new_slots)
        self.prefill_rows = new_pre
        self.controller.apply(decision)
        self.regroups += 1
        return True

    def drain(self, max_steps: int = 10_000) -> int:
        """Step until idle; returns the steps taken. Work still queued at
        the cap raises: a recovery deadlock must be loud."""
        for n in range(max_steps):
            if self.idle():
                return n
            self.step()
        if not self.idle():
            w = self.eng.workload_sample()
            raise RuntimeError(
                f"fleet stalled after {max_steps} steps: queue={w['queue_depth']} "
                f"handoff={w['handoff_depth']} restores={w.get('restore_depth', 0)} "
                f"active={w['active_slots']} rows={self.n_rows}")
        return max_steps

    # the reference's earlier name, kept as an alias
    run_until_drained = drain

    # -- failure handling ----------------------------------------------------
    def inject_fault(self, event: FaultEvent) -> None:
        """Queue a fault mid-replay (`traffic.replay`'s ``fail_at`` /
        ``preempt_at`` hooks land here); the monitor is made on demand, so
        an unfaulted config can still be failed."""
        if self.cfg.mode != "continuous":
            raise ValueError("fault injection needs mode='continuous'")
        if self.monitor is None:
            self.monitor = FailureMonitor(None, self.cfg.n_rows, min_rows=self.cfg.min_rows)
        self.monitor.inject(event)

    def _poll_faults(self) -> list[dict]:
        """The fault leg of a tick: take the due events, shrink, stage or
        drop, recover the orphans, grow onto returned rows."""
        if self.monitor is None:
            return []
        health = self.monitor.poll(self.eng.tick)
        out: list[dict] = []
        if health.returned_rows:
            # the grow target: the rows healthy BEFORE this tick's shrinks
            # (each `_apply_fault` below subtracts its own again)
            target = self.monitor.healthy_rows + sum(e.rows for e in health.events)
            rec = self._grow(target)
            if rec is not None:
                out.append(rec)
        for ev in health.events:
            out.append(self._apply_fault(ev))
        if out:
            reg = _metrics.REGISTRY
            for rec in out:
                if rec["kind"] == "regrow":
                    reg.counter("fleet.regrows").inc()
                    _obs.instant("regrow", _T_FLEET, **rec)
                else:
                    self.faults_total += 1
                    reg.counter(f"fleet.faults.{rec['kind']}").inc()
                    reg.counter("fleet.recovered.staged").inc(rec["staged"])
                    reg.counter("fleet.recovered.restored").inc(rec["restored"])
                    reg.counter("fleet.recovered.retried").inc(rec["retried"])
                    _obs.instant("fault", _T_FLEET, **rec)
        self.fault_log.extend(out)
        return out

    def _apply_fault(self, ev: FaultEvent) -> dict:
        """Shrink the fleet by one (clamped) loss or preemption.

        Slots on preempted rows are STAGED to the host before the rows
        leave (an in-memory migration, no recompute); slots on lost rows
        are orphaned and RESTORED from the last serving checkpoint or
        RETRIED from scratch; surviving slots that no longer fit the smaller
        pool are staged too (their KV is intact; they wait for a slot).
        Every orphan re-enters with its original arrival tick, so the
        ledger charges the whole recovery stall to TTFT and latency."""
        new_n = max(self.n_rows - ev.rows, self.cfg.min_rows)
        new_pre = min(self.prefill_rows, new_n - 1)
        new_slots = (new_n - new_pre) * self.cfg.slots_per_row
        old_slots = len(self.eng.slots)
        # the dying rows map to the TAIL of the slot pool (decode rows own
        # slots_per_row consecutive slots; the pool is compacted either way)
        n_dead = min(ev.rows * self.cfg.slots_per_row, old_slots) \
            if ev.kind == "device_loss" else 0
        dead = list(range(old_slots - n_dead, old_slots)) if n_dead else []
        orphans = [self.eng.drop_slot(i) for i in dead if self.eng.slots[i] is not None]
        staged = 0
        # a preemption notice evacuates the dying rows' slots; after a loss
        # the survivors past the smaller pool are staged (healthy KV, no slot)
        for i in range(old_slots - 1, -1, -1):
            if ev.kind != "preempt" and i in dead:
                continue
            if sum(s is not None for s in self.eng.slots) <= new_slots:
                break
            if self.eng.slots[i] is not None:
                self.eng.restores.append(self.eng.stage_out(i))
                staged += 1
        self.recoveries["staged"] += staged
        self._resize_fleet(new_n, new_pre, new_slots)
        restored = retried = 0
        for req in orphans:
            if self._restore_orphan(req):
                restored += 1
            else:
                retried += 1
        self.recoveries["restored"] += restored
        self.recoveries["retried"] += retried
        return {"tick": self.eng.tick, "kind": ev.kind, "rows_lost": ev.rows,
                "rows": self.n_rows, "prefill_rows": self.prefill_rows,
                "decode_slots": self.decode_slots, "staged": staged, "restored": restored,
                "retried": retried}

    def _grow(self, target_rows: int) -> dict | None:
        """Preempted rows came back: grow the decode pool onto them."""
        new_n = min(target_rows, self.cfg.n_rows)
        if new_n <= self.n_rows:
            return None
        new_pre = self.prefill_rows
        self._resize_fleet(new_n, new_pre, (new_n - new_pre) * self.cfg.slots_per_row)
        self.regrows += 1
        return {"tick": self.eng.tick, "kind": "regrow", "rows": self.n_rows,
                "prefill_rows": self.prefill_rows, "decode_slots": self.decode_slots}

    def _resize_fleet(self, new_n: int, new_pre: int, new_slots: int) -> None:
        """Re-size rows, split, graph and controller to the new fleet."""
        if self.graph is not None:
            # rebuild the serving topology on the largest mesh the surviving
            # rows allow (probing with backoff first, so that a transient
            # straggler does not shrink it); a row of the port's mesh is one
            # device
            mesh = healthy_mesh_with_backoff(
                (new_n,), (self._mesh.axis,),
                prober=self.monitor.prober(1) if self.monitor else None,
                attempts=self.cfg.probe_attempts, base_delay=self.cfg.probe_base_delay,
                device=self._mesh.device)
            self.graph = serving_graph(GroupedMesh.build_rows(mesh, rows={PREFILL: new_pre}))
        self.eng.resize(new_pre, new_slots)
        self.n_rows = new_n
        self.prefill_rows = new_pre
        if self.cfg.adapt is not None:
            # re-plan in degraded mode: a fresh controller sized to the
            # surviving fleet, its window refilled from live ticks
            self.controller = self._build_controller(new_n, new_pre)
            self._pending_age = 0

    def _restore_orphan(self, req) -> bool:
        """Resume an orphan from the last serving checkpoint, or retry it
        from scratch when no snapshot covers it. Either way it re-enters
        through `sched.submit`, NOT `eng.submit`, which would stamp a fresh
        ``submitted_tick`` and forgive the recovery stall."""
        req.done = False
        if self.cfg.recovery == "checkpoint" and self.ckpt is not None:
            entry = self.ckpt.slot_entry(req.uid, device=self.model.device)
            if entry is not None:
                cache1, length, next_tok, out_tokens = entry
                req.out_tokens[:] = list(out_tokens)
                if not req.out_tokens:
                    req.first_token_tick = -1
                self.eng.restores.append((req, cache1, length, next_tok))
                if _obs.enabled():
                    _obs.instant("checkpoint_restore", _T_FLEET, uid=req.uid,
                                 tick=self.eng.tick)
                return True
        # drop and retry: the stream restarts and TTFT is charged from the
        # original arrival; sched.submit also keeps the request's one
        # lifecycle span open across the retry
        req.out_tokens.clear()
        req.first_token_tick = -1
        self.eng.sched.submit(req, now=self.eng.tick)
        if _obs.enabled():
            _obs.request_mark(req.uid, "retry", _T_FLEET)
        return False


# -- the SPMD layer's slot migration ------------------------------------------------


def _fault_keep(old_c: int, new_c: int, spr: int, keep: Sequence[int] | None,
                dead_rows: Sequence[int] | None) -> list[int]:
    """The surviving slots of a reshard. ``dead_rows`` names old DECODE
    rows lost to a fault: their slots leave the default keep, and an
    explicit ``keep`` naming one raises (KV on a dead row cannot migrate;
    it can only be restored from a checkpoint)."""
    dead = set(int(r) for r in (dead_rows or ()))
    for r in dead:
        if not 0 <= r < old_c:
            raise ValueError(f"dead row {r} outside the {old_c} old decode rows")
    if keep is None:
        alive = [s for s in range(old_c * spr) if s // spr not in dead]
        keep = alive[: new_c * spr]
    else:
        keep = [int(s) for s in keep]
        for s in keep:
            if s // spr in dead:
                raise ValueError(f"kept slot {s} lives on dead row {s // spr}")
    if len(keep) > new_c * spr:
        raise ValueError(f"{len(keep)} kept slots exceed capacity {new_c * spr}")
    return keep


def _host(x: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host (bf16 widened to f32, exactly)."""
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _repartition(keep: list[int], spr: int):
    """The reference's re-deal of decode rows: kept slots to the head of
    the new decode rows, ``pos`` the max over the old decode rows."""

    def repartition(tree, old_g, new_g):
        new_c = new_g.compute.size
        out = {}
        for name, x in tree.items():
            if name == "pos":
                out[name] = np.full((new_c,) + x.shape[1:], x.max(initial=0), x.dtype)
                continue
            flat = x.reshape((-1,) + x.shape[2:])  # (old_c * spr, ...)
            dst = np.zeros((new_c * spr,) + flat.shape[1:], flat.dtype)
            dst[: len(keep)] = flat[list(keep)]
            out[name] = dst.reshape((new_c, spr) + flat.shape[1:])
        return out

    return repartition


def reshard_serving_state(cache: dict, tokens, old_gmesh: GroupedMesh, new_gmesh: GroupedMesh,
                          *, slots_per_row: int, keep: Sequence[int] | None = None,
                          dead_rows: Sequence[int] | None = None):
    """Move `init_disagg_state`'s cache and tokens between two
    prefill/decode splits. The decode group is the serving `GroupedMesh`'s
    compute group: the old decode rows' slots are gathered, dealt again
    over the new decode rows (``keep`` picks the global slot indices that
    survive a shrink; by default the head of the pool) and placed; the
    shared cursor ``pos`` becomes the max over the old decode rows (the
    shared-position contract of `migrate_cache_into_slot`); service rows
    get zeros.

    Two forms. With planning meshes (no world), ``cache`` and ``tokens``
    are the global layout (every row's slots) and the meshes may differ in
    size (the fault path: the full fleet onto a `healthy_mesh` of fewer
    rows): the reference's host arithmetic, returning tensors on the
    state's device. Inside a rank world they are this rank's row
    (`disagg.disagg_row_state`), every rank calls this alike, and the row
    moves through `launch.elastic.reshard_state`; one gloo world has one
    size, so meshes of different sizes raise there. ``dead_rows`` names
    old decode rows lost to a fault: their slots leave the default keep,
    and naming them in ``keep`` raises."""
    old_c, new_c = old_gmesh.compute.size, new_gmesh.compute.size
    spr = int(slots_per_row)
    keep = _fault_keep(old_c, new_c, spr, keep, dead_rows)
    if old_gmesh.mesh.in_world or new_gmesh.mesh.in_world:
        return _reshard_rows(cache, tokens, old_gmesh, new_gmesh, spr, keep)
    n_old, n_new = old_gmesh.axis_size, new_gmesh.axis_size

    def rows_first(x):
        """(L, n*spr, ...) slot-batched leaf -> (old_c, spr, L, ...)."""
        moved = np.moveaxis(_host(x), 1, 0)
        return moved.reshape((n_old, spr) + moved.shape[1:])[:old_c]

    state = {"tokens": _host(tokens).reshape(n_old, spr, 1)[:old_c],
             "pos": _host(cache["pos"])[:old_c],
             **{k: rows_first(v) for k, v in cache.items() if k != "pos"}}
    migrated = _repartition(keep, spr)(state, old_gmesh, new_gmesh)

    def place(name, like):
        """(new_c, spr, ...) compute rows -> the global leaf, service rows
        zero, in ``like``'s dtype on its device."""
        rows = migrated[name]
        whole = np.zeros((n_new,) + rows.shape[1:], rows.dtype)
        whole[:new_c] = rows
        if name == "pos":
            host = whole
        elif name == "tokens":
            host = whole.reshape(n_new * spr, 1)
        else:
            host = np.moveaxis(whole.reshape((n_new * spr,) + whole.shape[2:]), 0, 1)
        return torch.from_numpy(np.ascontiguousarray(host)).to(device=like.device,
                                                                dtype=like.dtype)

    new_cache = {k: place(k, v) for k, v in cache.items()}
    return new_cache, place("tokens", tokens)


def _reshard_rows(cache: dict, tokens, old_gmesh, new_gmesh, spr: int, keep: list[int]):
    """`reshard_serving_state` inside a world: this rank's row
    (`disagg_row_state`'s views) through `launch.elastic.reshard_state`."""
    if old_gmesh.axis_size != new_gmesh.axis_size:
        raise ValueError(
            f"reshard_serving_state between axis sizes {old_gmesh.axis_size} and "
            f"{new_gmesh.axis_size} inside a world: one gloo world has one size; move the "
            f"global layout between planning meshes instead")
    # row leaves: this rank's row, slots first (reshard_state's item axis)
    state = {"tokens": tokens, "pos": cache["pos"],
             **{k: v.transpose(0, 1) for k, v in cache.items() if k != "pos"}}
    moved = reshard_state(state, old_gmesh, new_gmesh, repartition=_repartition(keep, spr))
    new_cache = {k: (moved[k] if k == "pos" else moved[k].transpose(0, 1).contiguous())
                 for k in cache}
    return new_cache, moved["tokens"]


def reshard_paged_serving_state(k_pool, v_pool, tables, lens, tokens, old_gmesh: GroupedMesh,
                                new_gmesh: GroupedMesh, *, slots_per_row: int,
                                keep: Sequence[int] | None = None,
                                dead_rows: Sequence[int] | None = None,
                                n_blocks: int | None = None):
    """The paged counterpart of `reshard_serving_state`: move a block pool
    and slot tables between two prefill/decode splits.

    Paged state is mostly indirection: the KV bytes live in one pool
    shared by the decode rows, so a regroup only `repack_block_pool`s the
    live blocks onto the surviving slots and deals the per-slot token row
    again. ``keep`` picks the surviving global slots (by default the head
    of the pool minus any slot on a ``dead_rows`` decode row). Host
    arithmetic on the global layout, for meshes of any sizes (it takes no
    part in a world): the pools and tokens come back on the pool's
    device, tables and lens on the host."""
    n_new = new_gmesh.axis_size
    old_c, new_c = old_gmesh.compute.size, new_gmesh.compute.size
    spr = int(slots_per_row)
    lens = np.asarray(lens)
    keep = _fault_keep(old_c, new_c, spr, keep, dead_rows)
    new_k, new_v, kept_tables, kept_lens = repack_block_pool(
        k_pool, v_pool, tables, lens, keep=keep, n_blocks=n_blocks)
    # the global slot index space spans every row (init_disagg_state's
    # rows * slots_per_row layout), decode slots at the head
    new_tables = np.full((n_new * spr, np.asarray(tables).shape[1]), -1, np.int32)
    new_tables[: len(keep)] = kept_tables
    new_lens = np.zeros(n_new * spr, lens.dtype)
    new_lens[: len(keep)] = kept_lens
    host_tokens = np.zeros((n_new * spr, 1), np.int32)
    host_tokens[: len(keep)] = _host(tokens)[list(keep)]
    new_tokens = torch.from_numpy(host_tokens).to(k_pool.device)
    return new_k, new_v, new_tables, new_lens, new_tokens


__all__ = ["FleetConfig", "FleetEngine", "reshard_paged_serving_state", "reshard_serving_state"]
