"""ServeFleet scheduler: SLO-aware multi-tenant admission for the engines
(a copy of the reference's `serve/sched.py`: the same tags, picks and
gates pop the same requests on the same ticks in both packages).

`FleetScheduler` sits in front of an engine's prefill stage:

  * **weighted-fair queuing** (start-time fair queuing): each request
    carries a virtual finish tag ``start + prompt_tokens / weight``;
    the scheduler pops the smallest tag, so tenant throughput tracks
    the declared weights under backlog. Tags advance with every pop,
    which makes WFQ *starvation-free* by construction — priority
    ``aging`` sharpens the bound (a waiting request's effective tag
    decreases linearly in ticks waited);
  * **deadline-aware prefill ordering**: a request whose TTFT deadline
    is at risk (slack below ``urgent_slack``) is pulled forward
    earliest-deadline-first, ahead of the fairness order;
  * **token-budget admission control**: `take` never admits past
    ``token_budget`` outstanding prompt tokens (the caller reports the
    tokens already in flight), bounding prefill memory and keeping a
    burst from swamping the decode pool;
  * **FIFO mode** (`policy="fifo"`, the default built by the engines
    when no scheduler is passed): pure submit-order pop with no budget,
    bit-identical to the historic deque path.

`FleetLedger` is the measurement side: per-request completion records
(TTFT/latency percentiles per tenant and per SLO class, goodput) plus
the per-tick load samples the closed loop (serve/fleet.py) feeds into
`core.adapt.calibrate`.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import TYPE_CHECKING, Iterable, Mapping, Sequence

import numpy as np

from repro_torch.obs import registry as _metrics
from repro_torch.obs import trace as _obs
from repro_torch.serve.traffic import SLOClass, TenantSpec

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.serve.engine import Request


@dataclasses.dataclass
class _Queued:
    req: "Request"
    tenant: str
    submitted: int  # scheduler tick at submit
    seq: int  # global submit order (FIFO + tie-break)
    finish_tag: float  # WFQ virtual finish time
    start_tag: float


class FleetScheduler:
    """Multi-tenant SLO queue in front of an engine's prefill stage.

    ``tenants`` declares names/weights/SLOs; unknown tenants are
    admitted under a default spec so the scheduler never drops traffic
    on the floor. With ``policy="fifo"`` tags are ignored and requests
    pop in global submit order (the deque-compatible mode).
    """

    def __init__(
        self,
        tenants: Sequence[TenantSpec] | None = None,
        *,
        policy: str = "wfq",
        token_budget: int | None = None,
        aging: float = 0.0,
        urgent_slack: int = 4,
    ):
        if policy not in ("wfq", "fifo"):
            raise ValueError(f"policy must be 'wfq' or 'fifo', got {policy!r}")
        self.policy = policy
        self.token_budget = token_budget
        self.aging = float(aging)
        self.urgent_slack = int(urgent_slack)
        self.tenants: dict[str, TenantSpec] = {t.name: t for t in (tenants or ())}
        self._default = TenantSpec(name="default")
        self._queues: dict[str, collections.deque[_Queued]] = {}
        self._last_finish: dict[str, float] = {}
        self._vtime = 0.0
        self._seq = 0
        self.rejected = 0  # submits refused because they can never fit the budget

    @staticmethod
    def fifo() -> "FleetScheduler":
        """The deque-compatible scheduler the engines build by default."""
        return FleetScheduler(policy="fifo")

    # -- submit ------------------------------------------------------------
    def spec(self, tenant: str) -> TenantSpec:
        return self.tenants.get(tenant, self._default)

    def slo(self, tenant: str) -> SLOClass:
        return self.spec(tenant).slo

    def submit(self, req: "Request", now: int = 0) -> bool:
        """Queue a request; returns False (and counts it ``rejected``)
        when its prompt alone exceeds the token budget — such a request
        could never be admitted, so refusing it at the door keeps the
        budget invariant strict and the queue livelock-free."""
        ten = getattr(req, "tenant", "default") or "default"
        if (
            self.token_budget is not None
            and int(req.prompt.shape[0]) > self.token_budget
        ):
            self.rejected += 1
            _metrics.REGISTRY.counter("sched.rejected").inc()
            return False
        _metrics.REGISTRY.counter("sched.submitted").inc()
        spec = self.spec(ten)
        weight = max(spec.weight * spec.slo.weight, 1e-9)
        cost = float(req.prompt.shape[0]) / weight
        start = max(self._vtime, self._last_finish.get(ten, 0.0))
        finish = start + cost
        self._last_finish[ten] = finish
        q = self._queues.setdefault(ten, collections.deque())
        q.append(
            _Queued(req=req, tenant=ten, submitted=int(now), seq=self._seq,
                    finish_tag=finish, start_tag=start)
        )
        self._seq += 1
        return True

    # -- queries -----------------------------------------------------------
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def pending_by_tenant(self) -> dict[str, int]:
        return {t: len(q) for t, q in self._queues.items() if q}

    def pending_tokens(self) -> int:
        return sum(
            int(e.req.prompt.shape[0]) for q in self._queues.values() for e in q
        )

    def queued_requests(self) -> list["Request"]:
        """Every queued request in global submission (seq) order — the
        checkpoint bridge serializes this so a cold restore re-submits
        the queue with original arrival order intact."""
        entries = [e for q in self._queues.values() for e in q]
        entries.sort(key=lambda e: e.seq)
        return [e.req for e in entries]

    # -- pop ---------------------------------------------------------------
    def _heads(self) -> list[_Queued]:
        return [q[0] for q in self._queues.values() if q]

    def _pick(self, now: int) -> _Queued | None:
        heads = self._heads()
        if not heads:
            return None
        if self.policy == "fifo":
            return min(heads, key=lambda e: e.seq)
        # deadline-aware pull-forward: EDF among at-risk heads
        urgent = []
        for e in heads:
            deadline = e.submitted + self.slo(e.tenant).ttft_deadline
            if deadline - now <= self.urgent_slack:
                urgent.append((deadline, e.seq, e))
        if urgent:
            return min(urgent)[2]
        # weighted-fair order with priority aging (seq breaks ties
        # deterministically)
        return min(
            heads,
            key=lambda e: (e.finish_tag - self.aging * max(now - e.submitted, 0),
                           e.seq),
        )

    def take(
        self,
        now: int,
        *,
        max_n: int | None = None,
        inflight_tokens: int = 0,
        free_tokens: int | None = None,
        cost_fn=None,
    ) -> list["Request"]:
        """Pop up to ``max_n`` requests for admission at tick ``now``.

        ``inflight_tokens`` is the caller's count of already-admitted
        prompt tokens still occupying the prefill stage (pending row
        work + handoff queue); admission stops before
        ``inflight_tokens + admitted`` would exceed ``token_budget``
        (strict: `submit` already refused anything that could never
        fit). Work-conserving: if the queue is non-empty and both the
        budget and ``max_n`` allow the scheduled head request, at least
        one request is returned.

        ``free_tokens``/``cost_fn`` is the page-aware gate (paged KV):
        the engine reports how many block tokens remain after reserving
        in-flight decode growth, and ``cost_fn(req)`` prices a request
        in block tokens through completion, net of its prefix-cache
        discount. Admission stops before the priced sum would exceed
        ``free_tokens`` — against *free blocks*, not dense slot
        capacity, which is what lets a paged pool oversubscribe slots
        safely.
        """
        out: list[Request] = []
        used = int(inflight_tokens)
        pages = 0
        while max_n is None or len(out) < max_n:
            head = self._pick(now)
            if head is None:
                break
            cost = int(head.req.prompt.shape[0])
            if self.token_budget is not None and used + cost > self.token_budget:
                break
            page_cost = cost if cost_fn is None else int(cost_fn(head.req))
            if free_tokens is not None and pages + page_cost > free_tokens:
                break
            self._queues[head.tenant].popleft()
            used += cost
            pages += page_cost
            out.append(head.req)
            if self.token_budget is not None and used >= self.token_budget:
                break
        self._vtime = max(
            self._vtime, min((e.start_tag for e in self._heads()), default=self._vtime)
        )
        if out:
            _metrics.REGISTRY.counter("sched.admitted").inc(len(out))
        return out


# -- accounting ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Completion:
    """One finished request, on the engine tick clock."""

    uid: int
    tenant: str
    slo: str
    submitted: int
    first_token: int
    done: int
    tokens: int
    ttft_ok: bool
    latency_ok: bool


def _pct(vals: Iterable[float], q: float) -> float:
    vals = list(vals)
    return float(np.percentile(vals, q)) if vals else 0.0


class FleetLedger:
    """Per-tenant / per-class serving accounting + the adapt bridge.

    Completion records give latency percentiles and goodput; per-tick
    samples (wall seconds, per-row prefill work, decode work, queue
    depth) form the sliding window the closed loop pushes through
    `core.adapt.calibrate`. All times are engine ticks unless a wall
    clock is recorded alongside (`record_tick`'s ``wall_s``).
    """

    def __init__(self, window: int = 64):
        # completion records are exact and unbounded BY DESIGN: the
        # benchmarks assert on true full-run percentiles (a reservoir
        # would change the claim). Per-tenant/per-class indices are
        # maintained at record time so percentile queries never rescan
        # the full history once per selector.
        self.completions: list[Completion] = []
        self._by_tenant: dict[str, list[Completion]] = {}
        self._by_class: dict[str, list[Completion]] = {}
        self.ticks: collections.deque[dict] = collections.deque(maxlen=window)
        self.total_ticks = 0
        self.tokens_out = 0
        # exact cumulative counters — the tick window above is a sliding
        # sample for the adapt bridge, these never lose history
        self.cum_wall_s = 0.0
        self.cum_prefill_tokens = 0.0
        self.cum_decode_work = 0.0
        self.cum_accepted = 0
        self.cum_drafted = 0

    # -- record ------------------------------------------------------------
    def record_done(self, req: "Request", slo: SLOClass, now: int) -> None:
        ttft = req.first_token_tick - req.submitted_tick
        latency = now - req.submitted_tick
        c = Completion(
            uid=req.uid,
            tenant=getattr(req, "tenant", "default"),
            slo=slo.name,
            submitted=req.submitted_tick,
            first_token=req.first_token_tick,
            done=now,
            tokens=len(req.out_tokens),
            ttft_ok=ttft <= slo.ttft_deadline,
            latency_ok=latency <= slo.latency_deadline,
        )
        self.completions.append(c)
        self._by_tenant.setdefault(c.tenant, []).append(c)
        self._by_class.setdefault(c.slo, []).append(c)
        self.tokens_out += len(req.out_tokens)
        reg = _metrics.REGISTRY
        reg.counter("serve.completions").inc()
        reg.counter("serve.tokens_out").inc(c.tokens)
        if c.latency_ok:
            reg.counter("serve.good_tokens").inc(c.tokens)
        reg.histogram("serve.ttft_ticks").observe(ttft)
        reg.histogram("serve.latency_ticks").observe(latency)
        if _obs.enabled():
            _obs.request_end(req.uid, tokens=c.tokens, tick=now,
                             ttft=ttft, latency=latency, tenant=c.tenant)

    def record_tick(
        self,
        *,
        wall_s: float,
        prefill_work_rows: Sequence[float],
        decode_work_rows: Sequence[float],
        queue_depth: int,
        accepted: int = 0,
        drafted: int = 0,
        accepted_by_tenant: Mapping[str, int] | None = None,
        drafted_by_tenant: Mapping[str, int] | None = None,
    ) -> None:
        """``accepted``/``drafted`` are the speculative-decode counters
        (serve/spec.py): draft tokens proposed this tick and how many
        the verify pass kept. Non-spec engines leave them at zero —
        `acceptance_rate` then reports the sentinel, not a division."""
        self.ticks.append(
            {
                "wall_s": float(wall_s),
                "prefill_work_rows": list(map(float, prefill_work_rows)),
                "decode_work_rows": list(map(float, decode_work_rows)),
                "queue_depth": int(queue_depth),
                "accepted": int(accepted),
                "drafted": int(drafted),
                "accepted_by_tenant": dict(accepted_by_tenant or {}),
                "drafted_by_tenant": dict(drafted_by_tenant or {}),
            }
        )
        self.total_ticks += 1
        self.cum_wall_s += float(wall_s)
        self.cum_prefill_tokens += float(sum(prefill_work_rows))
        self.cum_decode_work += float(sum(decode_work_rows))
        self.cum_accepted += int(accepted)
        self.cum_drafted += int(drafted)
        reg = _metrics.REGISTRY
        reg.counter("serve.ticks").inc()
        reg.gauge("serve.queue_depth").set(float(queue_depth))
        if drafted:
            reg.counter("spec.drafted").inc(int(drafted))
            reg.counter("spec.accepted").inc(int(accepted))

    # -- latency / goodput -------------------------------------------------
    def _sel(self, tenant: str | None = None, slo: str | None = None):
        if tenant is not None:
            pool = self._by_tenant.get(tenant, [])
            return pool if slo is None else [c for c in pool if c.slo == slo]
        if slo is not None:
            return self._by_class.get(slo, [])
        return self.completions

    def ttft_percentile(self, q: float, **sel) -> float:
        return _pct((c.first_token - c.submitted for c in self._sel(**sel)), q)

    def latency_percentile(self, q: float, **sel) -> float:
        return _pct((c.done - c.submitted for c in self._sel(**sel)), q)

    def good_tokens(self, **sel) -> int:
        """Tokens of requests that met their latency deadline — the
        numerator of goodput (divide by the caller's clock)."""
        return sum(c.tokens for c in self._sel(**sel) if c.latency_ok)

    def queue_depth_mean(self) -> float:
        return float(np.mean([t["queue_depth"] for t in self.ticks])) if self.ticks else 0.0

    # sentinel for "no speculative sample in the window" — callers must
    # branch on it, not average it (it is deliberately out of [0, 1])
    NO_SAMPLE = -1.0

    def acceptance_rate(self, tenant: str | None = None) -> float:
        """Windowed draft-token acceptance rate, the live signal the
        spec adapt loop splits draft/verify rows on. Over an empty
        window, a verify-only warmup tick, or a tenant that never
        drafted, returns ``NO_SAMPLE`` (-1.0) instead of raising a
        ZeroDivisionError — the adapt bridge polls every tick and the
        first tick of a run has no drafted tokens yet."""
        if tenant is None:
            acc = sum(t.get("accepted", 0) for t in self.ticks)
            drf = sum(t.get("drafted", 0) for t in self.ticks)
        else:
            acc = sum(t.get("accepted_by_tenant", {}).get(tenant, 0)
                      for t in self.ticks)
            drf = sum(t.get("drafted_by_tenant", {}).get(tenant, 0)
                      for t in self.ticks)
        if drf <= 0:
            return self.NO_SAMPLE
        return acc / drf

    def snapshot(self) -> dict:
        """JSON-able per-tenant/per-class summary."""
        tenants = sorted({c.tenant for c in self.completions})
        classes = sorted({c.slo for c in self.completions})
        return {
            "completions": len(self.completions),
            "tokens_out": self.tokens_out,
            "cumulative": {
                "ticks": self.total_ticks,
                "cum_wall_s": self.cum_wall_s,
                "prefill_tokens": self.cum_prefill_tokens,
                "decode_work": self.cum_decode_work,
                "accepted": self.cum_accepted,
                "drafted": self.cum_drafted,
            },
            "good_tokens": self.good_tokens(),
            "queue_depth_mean": self.queue_depth_mean(),
            "acceptance_rate": self.acceptance_rate(),
            "ttft_p50": self.ttft_percentile(50),
            "ttft_p99": self.ttft_percentile(99),
            "latency_p50": self.latency_percentile(50),
            "latency_p99": self.latency_percentile(99),
            "by_tenant": {
                t: {
                    "completions": len(self._sel(tenant=t)),
                    "ttft_p99": self.ttft_percentile(99, tenant=t),
                    "latency_p99": self.latency_percentile(99, tenant=t),
                    "good_tokens": self.good_tokens(tenant=t),
                }
                for t in tenants
            },
            "by_class": {
                s: {
                    "completions": len(self._sel(slo=s)),
                    "ttft_p99": self.ttft_percentile(99, slo=s),
                    "latency_p99": self.latency_percentile(99, slo=s),
                }
                for s in classes
            },
        }

    # -- adapt bridge ------------------------------------------------------
    def load_samples(self) -> list[tuple[float, list[float], Mapping[str, float]]]:
        """The window as `(wall_s, work_per_row, stage_items)` samples
        in `core.adapt.LoadLedger.record` form: per-DECODE-row work plus
        the prefill stage's item volume (prompt tokens retired)."""
        return [
            (
                t["wall_s"],
                t["decode_work_rows"],
                {"prefill": float(sum(t["prefill_work_rows"]))},
            )
            for t in self.ticks
        ]


__all__ = ["Completion", "FleetLedger", "FleetScheduler"]
