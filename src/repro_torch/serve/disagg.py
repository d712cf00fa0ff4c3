"""Disaggregated prefill/decode serving of the port: the paper's decoupling
strategy applied to serving a language model (the counterpart of the
reference's `serve/disagg.py`).

Prefill (whole prompts, bound by operations) and decode (one token a
step, bound by bytes) are the "diverse operations" of Sec. II: a
colocated engine makes every worker do both, so one long prompt stalls
every decode slot behind it (`serve/engine.py`). Here the two operations
get groups of their own, and the KV cache of every finished prefill flows
from the prefill group to the decode group through a `StreamChannel` with
a cache-migration operator attached: the paper's Listing-1 dataflow, with
the KV handoff as the attached operator.

Two realisations share the operators:

* `DisaggEngine`, the host engine. A `PrefillScheduler` admits requests
  to prefill rows by load (pending prompt tokens, so skewed prompts stay
  balanced), finished prefills queue their per-request caches on the
  handoff queue, and the decode group refills free slots at the tick
  boundary through the store's `admit` (`migrate_cache_into_slot` in the
  dense store). Under an aligned schedule its decode logits equal the
  colocated engine's bit for bit: the same prefill, migration and decode
  calls. On the card every prefill runs the flash kernel, every
  continuous decode tick the paged decode kernel, and every handoff's
  first token and every tick's next tokens the argmax kernel.
* `build_disagg_spmd_step`, one serving tick over the rows of a rank
  world (`launch.mesh.spawn`): each rank is one row and calls the step on
  its own row's views (`disagg_row_state`). Prefill rows run the
  length-masked batch-1 prefill and `pack_cache`; each wave streams
  through `StreamChannel.stream_fold` with `cache_migration_op`; the first
  token and the length follow the wave's pairs by `Mesh.isend` /
  `Mesh.irecv` (the reference's ``lax.ppermute``); decode rows migrate
  into the wave's slot and take ``decode_steps`` greedy steps;
  `select_by_role` keeps the two roles' divergence inside one program.

The engine's ``tokens`` is a device tensor written in place where the
reference rebinds ``.at[slot, 0].set(...)``.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.core.dataflow import ServiceGraph
from repro_torch.core.decouple import group_psum, select_by_role
from repro_torch.core.groups import COMPUTE, GroupedMesh
from repro_torch.core.operators import (
    cache_migration_op,
    cache_stream_plan,
    migrate_cache_into_slot,
    pack_cache,
)
from repro_torch.core.wire import WireSpec
from repro_torch.kernels.sample import sample_last
from repro_torch.obs import registry as _metrics
from repro_torch.obs import trace as _obs
from repro_torch.serve.api import ServeConfig
from repro_torch.serve.engine import (
    PrefillRunner,
    Request,
    page_admission_budget,
    request_block_tokens,
    supports_length_masked_prefill,
)
from repro_torch.serve.kvstore import make_kvstore
from repro_torch.serve.sched import FleetLedger, FleetScheduler

PREFILL = "prefill"


# ---------------------------------------------------------------------------
# host engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DisaggConfig(ServeConfig):
    n_prefill_rows: int = 2
    decode_slots: int = 8
    # the scheduler's granularity: prompt tokens one prefill row retires a
    # tick (chunked prefill at the schedule level); 0 = a whole prompt a tick
    prefill_chunk: int = 0


class PrefillScheduler:
    """Load-balanced admission of prompts to prefill rows.

    Load = pending prompt tokens per row; a new request goes to the least
    loaded row, so skewed prompt lengths do not pile onto one row. Rows
    retire ``chunk`` tokens of their head prompt per tick."""

    def __init__(self, n_rows: int, chunk: int = 0):
        self.n_rows = n_rows
        self.chunk = chunk
        self.rows: list[deque[Request]] = [deque() for _ in range(n_rows)]
        self.remaining = [0] * n_rows  # tokens left on each row's head request

    def load(self) -> list[int]:
        out = []
        for r in range(self.n_rows):
            pending = sum(int(q.prompt.shape[0]) for q in self.rows[r])
            head = self.rows[r][0] if self.rows[r] else None
            if head is not None:  # part of the head's work is retired already
                pending -= int(head.prompt.shape[0]) - self.remaining[r]
            out.append(pending)
        return out

    def admit(self, req: Request) -> int:
        row = int(np.argmin(self.load()))
        if not self.rows[row]:
            self.remaining[row] = int(req.prompt.shape[0])
        self.rows[row].append(req)
        return row

    def pending(self) -> int:
        return sum(len(q) for q in self.rows)

    def tick(self) -> tuple[list[Request], list[int]]:
        """Advance every row by one chunk; return (the finished requests in
        row order, the prompt tokens each row retired this tick)."""
        finished: list[Request] = []
        work = [0] * self.n_rows
        for r in range(self.n_rows):
            if not self.rows[r]:
                continue
            step = self.remaining[r] if self.chunk <= 0 else min(self.chunk, self.remaining[r])
            self.remaining[r] -= step
            work[r] = step
            if self.remaining[r] <= 0:
                finished.append(self.rows[r].popleft())
                if self.rows[r]:
                    self.remaining[r] = int(self.rows[r][0].prompt.shape[0])
        return finished, work


# disaggregated tracks (obs.trace): prefill and decode are distinct stage
# groups, so distinct trace processes, and a request's flow arrows cross
# the prefill -> migrate -> decode handoff
_T_DPREFILL = ("prefill", "rows")
_T_HANDOFF = ("prefill", "handoff")
_T_DDECODE = ("decode", "slots")


class DisaggEngine:
    """A prefill group and a decode group with a KV handoff queue between.

    A tick mirrors `Engine.step`, so the two compare on one tick clock:
    (1) prefill rows advance and finished prefills queue their caches on
    the handoff queue, (2) the decode group refills free slots from it at
    the tick boundary, (3) one decode step runs over the slot batch.

    ``mode="continuous"`` adds a second refill after retirement (a
    prefill finished this tick lands in a slot freed this tick), runs a
    tick's finished prefills as one packed call, decodes on per-slot
    cursors through the configured `KVStore`, and (paged store with the
    prefix cache) sends whole-prompt hits straight to the handoff queue
    with no prefill work."""

    def __init__(self, model, params, cfg: DisaggConfig, sched: FleetScheduler | None = None):
        self.model = model
        self.params = params
        self.cfg = cfg
        if cfg.mode == "continuous" and not supports_length_masked_prefill(model.cfg):
            raise ValueError(
                "continuous batching needs an attention-only LM "
                "(ragged per-slot decode cursors)"
            )
        # the fleet-level SLO queue in front of the per-row prefill scheduler
        self.sched = sched if sched is not None else FleetScheduler.fifo()
        self.ledger = FleetLedger()
        self.prefill_sched = PrefillScheduler(cfg.n_prefill_rows, cfg.prefill_chunk)
        # handoff entries: (req, cache1 | None, first | None, logits | None);
        # cache1 None marks a whole-prompt prefix hit that skipped prefill
        # and is resolved again at refill time
        self.handoff: deque[tuple] = deque()
        # restore entries: (req, cache1, length, next_token): KV staged off a
        # dying row (a preemption notice) or replayed from a checkpoint,
        # installed ahead of fresh handoffs (serve/fleet.py's recovery)
        self.restores: deque[tuple] = deque()
        self.slots: list[Request | None] = [None] * cfg.decode_slots
        self.finished: list[Request] = []
        self._prefill = PrefillRunner(model, params, max_len=cfg.max_len)
        self.kv = make_kvstore(model, cfg.decode_slots, cfg.max_len, cfg.kv,
                               ragged=cfg.mode == "continuous")
        self.tokens = torch.zeros((cfg.decode_slots, 1), dtype=torch.int32, device=model.device)
        self.last_logits = None
        self.tick = 0
        # refused submits live on the scheduler (sched.rejected)
        self.stats = {"steps": 0, "tokens_out": 0, "prefills": 0, "handoffs": 0,
                      "prefix_hit_tokens": 0, "prefill_skips": 0, "restores": 0}
        self.last_tick: dict = {}
        self._tick_restores = 0

    @property
    def cache(self) -> dict:
        """The slot KV as a dense cache dict (a read view; the paged store
        gathers its block tables)."""
        if self.kv.kind == "dense":
            return self.kv.cache
        return self.kv.view([i for i, s in enumerate(self.slots) if s is not None])

    def submit(self, req: Request) -> bool:
        req.submitted_tick = self.tick
        ok = self.sched.submit(req, now=self.tick)
        # the lifecycle span opens here and only here: recovery paths
        # re-queue through sched.submit and never open another
        if ok and _obs.enabled():
            _obs.request_begin(req.uid, tenant=req.tenant, tick=self.tick,
                               prompt_tokens=int(req.prompt.shape[0]))
        return ok

    def _inflight(self) -> list[Request]:
        """Requests past the fleet queue and not yet in a decode slot
        (prefill rows, the handoff queue, staged restores)."""
        out = [req for row in self.prefill_sched.rows for req in row]
        out.extend(item[0] for item in self.handoff)
        out.extend(item[0] for item in self.restores)
        return out

    def _inflight_prompt_tokens(self) -> int:
        """WHOLE prompt tokens of the in-flight requests, the quantity the
        token budget bounds (not the rows' remaining work: a retired chunk
        must not free budget that the handoff queue still holds)."""
        return sum(int(req.prompt.shape[0]) for req in self._inflight())

    def _prefill_tick(self) -> list[int]:
        budget, cost_fn = None, None
        if self.cfg.mode == "continuous":
            # the page gate: in-flight prefill and handoff work holds no
            # blocks yet but will, so it is charged beside the decode
            # pool's growth reserve
            extra = sum(
                request_block_tokens(self.kv, req, self.cfg.max_len)
                for req in self._inflight()
            ) if self.kv.block_size is not None else 0
            budget, cost_fn = page_admission_budget(
                self.kv, self.slots, self.cfg.max_len, extra_need_tokens=extra)
        # a dense store has no page budget: `take` is then called exactly as
        # the scheduler's plain duck type expects
        gate = {} if budget is None else {"free_tokens": budget, "cost_fn": cost_fn}
        for req in self.sched.take(self.tick, inflight_tokens=self._inflight_prompt_tokens(),
                                   **gate):
            if self.cfg.mode == "continuous" and self.kv.full_hit(req.prompt):
                # a whole-prompt prefix hit: no prefill work; straight to
                # the handoff queue (resolved at refill)
                self.handoff.append((req, None, None, None))
                if _obs.enabled():
                    _obs.request_mark(req.uid, "handoff:prefix_hit", _T_HANDOFF)
                self.stats["prefill_skips"] += 1
                continue
            self.prefill_sched.admit(req)
        finished, work = self.prefill_sched.tick()
        if self.cfg.mode == "continuous" and len(finished) > 1:
            with _obs.span("prefill_packed", _T_DPREFILL, batch=len(finished)):
                logits, batch = self._prefill.run_batch([r.prompt for r in finished])
            for i, req in enumerate(finished):
                n = int(req.prompt.shape[0])
                cache1 = {k: (torch.tensor(n, dtype=torch.int32, device=v.device)
                              if k == "pos" else v[:, i : i + 1])
                          for k, v in batch.items()}
                first = sample_last(logits[i : i + 1])[0]
                self.handoff.append((req, cache1, first, logits[i, -1]))
                if _obs.enabled():
                    _obs.request_mark(req.uid, "handoff", _T_HANDOFF)
                self.stats["prefills"] += 1
        else:
            for req in finished:
                with _obs.span("prefill", _T_DPREFILL, uid=req.uid,
                               tokens=int(req.prompt.shape[0])):
                    logits, cache1 = self._prefill(req.prompt)
                first = sample_last(logits)[0]
                self.handoff.append((req, cache1, first, logits[0, -1]))
                if _obs.enabled():
                    _obs.request_mark(req.uid, "handoff", _T_HANDOFF)
                self.stats["prefills"] += 1
        return work

    def _refill_slots(self) -> int:
        n = 0
        continuous = self.cfg.mode == "continuous"
        for slot, occupant in enumerate(self.slots):
            if occupant is not None or not (self.restores or self.handoff):
                continue
            if self.restores:
                # a staged or checkpointed slot resumes mid-stream: its KV is
                # installed verbatim (no prefix registration: the cache spans
                # decoded tokens too) and decode goes on from the saved token
                req, cache1, length, next_tok = self.restores.popleft()
                self.slots[slot] = req
                self.kv.admit(slot, cache1, int(length))
                self.tokens[slot, 0] = int(next_tok)
                if _obs.enabled():
                    _obs.request_mark(req.uid, "restore", _T_DDECODE, slot=slot)
                self.stats["restores"] += 1
                self._tick_restores += 1
                n += 1
                continue
            req, cache1, first, logits = self.handoff.popleft()
            self.slots[slot] = req
            if cache1 is None:
                # a whole-prompt hit: resolve it again (the entry may have
                # been evicted while queued; then prefill late)
                entry = self.kv.full_hit(req.prompt)
                if entry is not None:
                    info = self.kv.admit_from_full(slot, entry)
                    self.stats["prefix_hit_tokens"] += info["prefix_tokens"]
                    self.tokens[slot, 0] = entry.first
                    if _obs.enabled():
                        _obs.request_mark(req.uid, "migrate:prefix_hit", _T_DDECODE, slot=slot)
                    self.stats["handoffs"] += 1
                    n += 1
                    continue
                out_logits, cache1 = self._prefill(req.prompt)
                first = sample_last(out_logits)[0]
                logits = out_logits[0, -1]
                self.stats["prefills"] += 1
            plen = int(req.prompt.shape[0])
            if continuous:
                info = self.kv.admit(slot, cache1, plen, tokens=req.prompt, logits=logits,
                                     first=int(first))
                self.stats["prefix_hit_tokens"] += info["prefix_tokens"]
            else:
                self.kv.admit(slot, cache1, plen)
            self.tokens[slot, 0] = first
            if _obs.enabled():
                _obs.request_mark(req.uid, "migrate", _T_DDECODE, slot=slot)
            self.stats["handoffs"] += 1
            n += 1
        return n

    def step(self) -> None:
        continuous = self.cfg.mode == "continuous"
        self._tick_restores = 0
        work = self._prefill_tick()
        handoffs = self._refill_slots()
        self.tick += 1
        self.last_tick = {
            "prefill_tokens_per_row": work,
            "handoffs": handoffs,
            "restores": self._tick_restores,
            "decode_batch": sum(s is not None for s in self.slots),
            # per-slot occupancy at decode time: the closed loop's per-decode-
            # row work signal (serve/fleet.py)
            "slots_active": [s is not None for s in self.slots],
        }
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            if continuous:
                self.last_tick["kv"] = self.kv.stats
                _metrics.publish_kv_stats(self.last_tick["kv"])
            return
        _obs.begin("decode", _T_DDECODE, tick=self.tick, batch=len(active))
        if continuous:
            # the paged decode (continuous mode is attention-only): per-slot
            # rows in and out, no dense gather
            logits, rows_k, rows_v = self.model.decode_step_paged(
                self.params, self.kv.kernel_view(active), self.tokens)
            self.kv.absorb_rows(rows_k, rows_v, active)
        else:
            logits, cache = self.model.decode_step(self.params, self.kv.view(), self.tokens)
            self.kv.absorb(cache, active)
        self.last_logits = logits
        next_tok = sample_last(logits)
        # the tick's one wait for the device, inside the decode span
        next_np = next_tok.cpu().numpy()
        _obs.end(_T_DDECODE)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(next_np[i])
            if req.first_token_tick < 0:
                req.first_token_tick = self.tick
            req.out_tokens.append(tok)
            self.stats["tokens_out"] += 1
            if tok == self.cfg.eos_id or len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                req.done_tick = self.tick
                self.finished.append(req)
                if _obs.enabled():
                    _obs.request_mark(req.uid, "retire", _T_DDECODE, slot=i)
                self.ledger.record_done(req, self.sched.slo(req.tenant), self.tick)
                self.slots[i] = None
                if continuous:
                    self.kv.free(i)
        self.tokens = next_tok[:, None]
        if continuous:
            # same-tick insertion: a prefill finished this tick takes a slot
            # retired this tick instead of waiting for the next boundary
            self.last_tick["handoffs"] += self._refill_slots()
            self.last_tick["restores"] = self._tick_restores
            self.last_tick["slots_active"] = [s is not None for s in self.slots]
            self.last_tick["kv"] = self.kv.stats
            _metrics.publish_kv_stats(self.last_tick["kv"])
            if _obs.enabled():
                kv = self.last_tick["kv"]
                _obs.counter("kv", {k: kv[k] for k in ("blocks_in_use", "live_tokens")
                                    if k in kv}, _T_DDECODE)
        self.stats["steps"] += 1

    def idle(self) -> bool:
        return (self.sched.pending() == 0 and self.prefill_sched.pending() == 0
                and not self.handoff and not self.restores
                and all(s is None for s in self.slots))

    # -- fault actuators (the recovery path's hooks, serve/fleet.py) -------
    def stage_out(self, slot: int) -> tuple:
        """Evacuate an occupied slot to staging (a preemption notice came
        for its row): returns the restore entry ``(req, cache1, length,
        next_token)`` and frees the slot. The KV leaves as a batch-1 dense
        cache (`KVStore.slot_cache`, copied: the slot's storage is reused),
        so re-admission is its exact inverse, with no recompute. int8 pools
        dequantize on the way out and quantize again on re-admission
        (within the codec's tolerance, not bit for bit)."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is empty")
        cache1 = {k: v.clone() for k, v in self.kv.slot_cache(slot).items()}
        entry = (req, cache1, int(self.kv.lens[slot]), int(self.tokens[slot, 0]))
        self.slots[slot] = None
        self.kv.free(slot)
        return entry

    def drop_slot(self, slot: int) -> Request:
        """Abandon an occupied slot (its row died without notice): the KV
        is gone with the row; the orphaned request is returned for retry or
        a checkpoint restore."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is empty")
        self.slots[slot] = None
        self.kv.free(slot)
        return req

    # -- regroup actuator (the closed loop's act leg, serve/fleet.py) ------
    def resize(self, n_prefill_rows: int, decode_slots: int) -> None:
        """Re-size the prefill/decode split in place, migrating every
        in-flight KV slot into the new decode pool.

        Occupied slots are compacted into the head of the new pool by the
        store's `resize` (the dense store copies each slot whole with
        `migrate_cache_into_slot`, keeping the shared cursor; the paged
        store moves table rows, no KV bytes). Pending prefill-row requests
        are admitted again, least loaded, onto the new row count; a partly
        retired head prompt restarts its (virtual) progress: the real
        batch-1 prefill runs only at retire time, so outputs do not change.
        Shrinking below the occupied slots raises: the fleet defers the
        regroup until enough requests drain."""
        occupied = [i for i, s in enumerate(self.slots) if s is not None]
        if len(occupied) > decode_slots:
            raise ValueError(
                f"cannot shrink to {decode_slots} decode slots with {len(occupied)} in flight")
        pending: list[Request] = []
        for row in self.prefill_sched.rows:
            pending.extend(row)
        self.prefill_sched = PrefillScheduler(n_prefill_rows, self.cfg.prefill_chunk)
        for req in pending:
            self.prefill_sched.admit(req)
        old_tokens, old_slots = self.tokens, self.slots
        moves = list(enumerate(occupied))
        self.kv = self.kv.resize(decode_slots, moves)
        self.tokens = torch.zeros((decode_slots, 1), dtype=torch.int32, device=old_tokens.device)
        self.slots = [None] * decode_slots
        for dst, src in moves:
            self.tokens[dst, 0] = old_tokens[src, 0]
            self.slots[dst] = old_slots[src]
        self.cfg = dataclasses.replace(self.cfg, n_prefill_rows=n_prefill_rows,
                                       decode_slots=decode_slots)

    def drain(self, max_steps: int = 10_000) -> int:
        """Step until idle; returns the steps taken. Work still queued at
        the cap raises: a recovery deadlock must be loud."""
        for n in range(max_steps):
            if self.idle():
                return n
            self.step()
        if not self.idle():
            raise RuntimeError(
                f"engine stalled after {max_steps} steps: queue={self.sched.pending()} "
                f"prefill={self.prefill_sched.pending()} handoff={len(self.handoff)} "
                f"restores={len(self.restores)} "
                f"slots={sum(s is not None for s in self.slots)}")
        return max_steps

    # the reference's earlier name, kept as an alias
    run_until_drained = drain

    def workload_sample(self) -> dict:
        return {
            "active_slots": sum(s is not None for s in self.slots),
            "queue_depth": self.sched.pending() + self.prefill_sched.pending()
            + len(self.restores),
            "handoff_depth": len(self.handoff),
            "restore_depth": len(self.restores),
            "tokens_out": self.stats["tokens_out"],
        }


# ---------------------------------------------------------------------------
# the SPMD step over a rank world (the paper's producer/consumer groups)
# ---------------------------------------------------------------------------

def serving_mesh(mesh, alpha: float, axis: str = "data") -> GroupedMesh:
    """Partition ``axis`` into a decode (compute) group and a prefill
    service group of alpha * rows (collective inside a world)."""
    return GroupedMesh.build(mesh, axis=axis, services={PREFILL: alpha})


def serving_graph(mesh_or_gmesh, alpha: float | None = None, axis: str = "data", *,
                  codec: str = "identity", wire_chunk_bytes: int | None = None
                  ) -> ServiceGraph:
    """The disaggregated serving topology as a `ServiceGraph`: one
    prefill -> decode edge whose wire declaration (codec and chunking)
    covers the KV migration stream. Takes a bare mesh (with ``alpha``) or
    a `GroupedMesh` from `serving_mesh`."""
    if isinstance(mesh_or_gmesh, GroupedMesh):
        if alpha is not None:
            raise ValueError("alpha is resolved by the GroupedMesh already; pass a bare "
                             "mesh to let serving_graph partition it")
        gmesh = mesh_or_gmesh
    else:
        if alpha is None:
            raise ValueError("serving_graph(mesh, alpha) needs alpha")
        gmesh = serving_mesh(mesh_or_gmesh, alpha, axis)
    return ServiceGraph.from_grouped(
        gmesh, [(PREFILL, COMPUTE)],
        wire={(PREFILL, COMPUTE): WireSpec(codec=codec, chunk_bytes=wire_chunk_bytes)})


def kv_handoff_channel(gmesh: GroupedMesh, codec: str = "identity"):
    """The prefill -> decode dataflow channel."""
    return serving_graph(gmesh, codec=codec).channel(PREFILL, COMPUTE)


def _permute(mesh, perm: list[tuple[int, int]], x: torch.Tensor) -> torch.Tensor:
    """``lax.ppermute`` of one rank's ``x`` along the (src, dst) pairs:
    the destination of a pair gets its source's ``x``; every other rank
    gets zeros."""
    for src, dst in perm:
        if mesh.row == src:
            mesh.isend(x, dst).wait()
        elif mesh.row == dst:
            return mesh.irecv(tuple(x.shape), x.dtype, src).wait()
    return torch.zeros_like(x)


def build_disagg_spmd_step(model, gmesh: GroupedMesh, *, max_prompt: int, slots_per_row: int,
                           max_len: int, chunk_elems: int = 4096, decode_steps: int = 1,
                           codec: str = "identity"):
    """One disaggregated serving tick over the rows of a rank world.

    Every rank calls the step on its own row (`disagg_row_state` gives the
    views). A tick, each prefill row takes at most one request (a
    right-padded ``(1, max_prompt)`` prompt and its true length) and each
    decode row exposes ``slots_per_row`` decode slots:

      1. prefill rows run the length-masked batch-1 prefill and pack the
         request's cache into granularity-S stream elements (`pack_cache`);
      2. each wave streams to the decode group, every chunk, where the
         attached `cache_migration_op` assembles it and
         `migrate_cache_into_slot` installs it in that wave's free slot
         (``dst_slot``), zero-extended to ``max_len``; the first token and
         the length follow the wave's pairs;
      3. decode rows take ``decode_steps`` greedy decode steps over their
         slot batch; prefill rows hold their (dummy) state.

    Returns ``(step, plan)``. ``step(params, prompts (1, max_prompt), plen
    (1,), dst_slot (1, n_waves), cache, tokens (slots, 1)) -> (cache,
    tokens, out_tokens (slots, decode_steps), stats (1, 2))``, where
    ``cache`` holds this row's k/v ``(L, slots, max_len, d)`` and its
    ``pos`` ``(1,)``; the cache and ``tokens`` are updated in place and
    returned. A stats row carries (handoffs, lockstep decode slot-steps:
    slots * decode_steps per decode row, occupied or not) summed over the
    decode group by `group_psum`. Attention-only models: a length-masked
    prefill cannot rewind an SSM recurrence past padding."""
    cfg = model.cfg
    if getattr(cfg, "ssm_state", 0) or getattr(cfg, "hybrid", False) or (
            getattr(cfg, "family", "") == "encdec"):
        raise ValueError("disaggregated SPMD step needs an attention-only LM cache")
    channel = kv_handoff_channel(gmesh, codec=codec)
    mesh = gmesh.mesh
    plan = cache_stream_plan(model.init_cache(1, max_prompt), chunk_elems)
    op = cache_migration_op(plan, device=mesh.device)
    n_waves = channel.n_waves
    dev = mesh.device
    is_cons = gmesh.is_member(COMPUTE)
    cons_rank = mesh.row - gmesh.compute.start

    def step(params, prompts, plen, dst_slot, cache, tokens):
        row_cache = {k: v for k, v in cache.items() if k != "pos"}
        row_cache["pos"] = cache["pos"][0]

        # -- 1. prefill rows produce (packed cache, first token, length)
        def prefill_branch():
            length = plen[0].to(device=dev, dtype=torch.int32)
            logits, c1 = model.prefill(params, prompts.to(dev), length=length)
            first = sample_last(logits)[0]
            return pack_cache(c1, plan), first, length

        def idle_branch():
            return (torch.zeros((plan.n_chunks, plan.chunk_elems), dtype=plan.dtype, device=dev),
                    torch.zeros((), dtype=torch.int32, device=dev),
                    torch.zeros((), dtype=torch.int32, device=dev))

        elems, first, length = select_by_role(
            gmesh, {COMPUTE: idle_branch, PREFILL: prefill_branch})

        # -- 2. stream each wave through the channel, migrating into a slot
        handoffs = 0
        for wave in range(n_waves):
            perm = channel.wave_perm(wave)
            if not perm:
                continue
            staged = channel.stream_fold(elems, op.apply, op.init(), waves=[wave])
            first_arr, len_arr = _permute(mesh, perm, torch.stack([first, length])).unbind()
            slot = int(dst_slot[0, wave])
            ok = is_cons and cons_rank < len(perm) and slot >= 0 and int(len_arr) > 0
            if ok:
                src = plan.unpack(staged)
                src["pos"] = len_arr
                migrate_cache_into_slot(row_cache, src, slot)
                tokens[slot, 0] = first_arr
            handoffs += int(ok)

        # -- 3. decode rows advance their slot batch
        def decode_branch():
            c, toks, outs = dict(row_cache), tokens, []
            for _ in range(decode_steps):
                logits, c = model.decode_step(params, c, toks)
                toks = sample_last(logits)[:, None]
                outs.append(toks[:, 0])
            return c, toks, torch.stack(outs, dim=1)

        def hold_branch():
            zero = torch.zeros((tokens.shape[0], decode_steps), dtype=torch.int32, device=dev)
            return row_cache, tokens, zero

        row_cache, new_tokens, out_toks = select_by_role(
            gmesh, {COMPUTE: decode_branch, PREFILL: hold_branch})
        if new_tokens is not tokens:
            tokens.copy_(new_tokens)

        # -- 4. decode-group analytics (handoffs, lockstep slot-steps; the
        # host tracks each request's liveness, so this counts every slot of
        # every decode row, occupied or not)
        emitted = tokens.shape[0] * decode_steps if is_cons else 0
        stats = group_psum(torch.tensor([handoffs, emitted], dtype=torch.int32, device=dev),
                           gmesh, COMPUTE)
        # k/v were written in place (the migration and the decode steps);
        # the cursor was rebound
        cache["pos"].copy_(row_cache["pos"].reshape(1))
        return cache, tokens, out_toks, stats[None]

    return step, plan


def init_disagg_state(model, gmesh: GroupedMesh, *, slots_per_row: int, max_len: int):
    """The global cache and tokens of the SPMD step (every row's slots,
    the reference's layout): k/v ``(L, rows * slots_per_row, max_len, d)``,
    ``pos`` ``(rows,)``, tokens ``(rows * slots_per_row, 1)``."""
    rows = gmesh.axis_size
    cache = model.init_cache(rows * slots_per_row, max_len)
    cache["pos"] = torch.zeros((rows,), dtype=torch.int32, device=model.device)
    tokens = torch.zeros((rows * slots_per_row, 1), dtype=torch.int32, device=model.device)
    return cache, tokens


def disagg_row_state(cache: dict, tokens: torch.Tensor, gmesh: GroupedMesh, *,
                     slots_per_row: int):
    """This rank's part of `init_disagg_state`'s global layout, as views:
    what the step takes and updates in place."""
    r = gmesh.mesh.row
    lo, hi = r * slots_per_row, (r + 1) * slots_per_row
    view = {k: (v[r : r + 1] if k == "pos" else v[:, lo:hi]) for k, v in cache.items()}
    return view, tokens[lo:hi]


__all__ = [
    "PREFILL", "DisaggConfig", "DisaggEngine", "PrefillScheduler", "build_disagg_spmd_step",
    "disagg_row_state", "init_disagg_state", "kv_handoff_channel", "serving_graph",
    "serving_mesh",
]
