"""The traffic dataclasses the scheduler needs: an SLO class and a
tenant's contract. Arrival processes and scenarios are not ported yet
(ROADMAP A9); `TenantSpec` keeps only the fields the scheduler reads."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A latency target class, in engine ticks: ``ttft_deadline`` bounds
    submit -> first token, ``latency_deadline`` submit -> done;
    ``weight`` is the class's fair-share multiplier."""

    name: str = "standard"
    ttft_deadline: int = 64
    latency_deadline: int = 512
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's share and SLO."""

    name: str
    weight: float = 1.0
    slo: SLOClass = SLOClass()


__all__ = ["SLOClass", "TenantSpec"]
