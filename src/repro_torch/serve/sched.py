"""Admission queue and completion ledger of the port: a trimmed copy of
the reference's `FleetScheduler` (FIFO policy) and `FleetLedger`.

`FleetScheduler.fifo()` pops requests in submit order. `take` honours
the page-aware gate (``free_tokens``/``cost_fn``) exactly as the
reference does, so both engines admit the same requests on the same
ticks. Weighted-fair queuing, deadlines and token budgets come with the
fleet (ROADMAP A9).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import TYPE_CHECKING, Sequence

from repro_torch.serve.traffic import SLOClass, TenantSpec

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.serve.engine import Request


class FleetScheduler:
    """FIFO admission queue in front of an engine's prefill stage."""

    def __init__(self, tenants: Sequence[TenantSpec] | None = None):
        self.tenants: dict[str, TenantSpec] = {t.name: t for t in (tenants or ())}
        self._default = TenantSpec(name="default")
        self._queue: collections.deque["Request"] = collections.deque()

    @staticmethod
    def fifo() -> "FleetScheduler":
        """The submit-order scheduler the engines build by default."""
        return FleetScheduler()

    def spec(self, tenant: str) -> TenantSpec:
        return self.tenants.get(tenant, self._default)

    def slo(self, tenant: str) -> SLOClass:
        return self.spec(tenant).slo

    def submit(self, req: "Request", now: int = 0) -> bool:
        self._queue.append(req)
        return True

    def pending(self) -> int:
        return len(self._queue)

    def take(self, now: int, *, max_n: int | None = None, free_tokens: int | None = None,
             cost_fn=None) -> list["Request"]:
        """Pop up to ``max_n`` requests in submit order. With the
        page-aware gate, admission stops before the summed
        ``cost_fn(req)`` (block tokens through completion, net of the
        prefix-cache discount) would exceed ``free_tokens``."""
        out: list["Request"] = []
        pages = 0
        while self._queue and (max_n is None or len(out) < max_n):
            head = self._queue[0]
            cost = int(head.prompt.shape[0]) if cost_fn is None else int(cost_fn(head))
            if free_tokens is not None and pages + cost > free_tokens:
                break
            self._queue.popleft()
            pages += cost
            out.append(head)
        return out


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


class FleetLedger:
    """Completion records on the tick clock, with their SLO verdicts."""

    def __init__(self):
        self.completions: list[Completion] = []
        self.tokens_out = 0

    def record_done(self, req: "Request", slo: SLOClass, now: int) -> None:
        ttft = req.first_token_tick - req.submitted_tick
        latency = now - req.submitted_tick
        self.completions.append(Completion(
            uid=req.uid, tenant=req.tenant, slo=slo.name,
            submitted=req.submitted_tick, first_token=req.first_token_tick, done=now,
            tokens=len(req.out_tokens), ttft_ok=ttft <= slo.ttft_deadline,
            latency_ok=latency <= slo.latency_deadline,
        ))
        self.tokens_out += len(req.out_tokens)


__all__ = ["Completion", "FleetLedger", "FleetScheduler"]
