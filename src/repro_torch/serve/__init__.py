"""Serving layer of the port: the colocated `Engine` (aligned and
continuous batching) over the dense and paged KV stores, behind
`make_engine`; the multi-tenant `FleetScheduler` and `FleetLedger`; and
named traffic scenarios replayed through `replay`."""
from repro_torch.serve.api import KVSpec, ServeConfig, ServingEngine, make_engine
from repro_torch.serve.engine import Engine, EngineConfig, PrefillRunner, Request
from repro_torch.serve.faults import FailureMonitor, FaultEvent, FaultSchedule
from repro_torch.serve.kvstore import DenseKVStore, PagedKVStore, make_kvstore
from repro_torch.serve.sched import FleetLedger, FleetScheduler
from repro_torch.serve.traffic import (
    SCENARIOS,
    SLOClass,
    TenantSpec,
    TrafficScenario,
    replay,
    scenario,
)

__all__ = [
    "SCENARIOS", "DenseKVStore", "Engine", "EngineConfig", "FailureMonitor", "FaultEvent",
    "FaultSchedule", "FleetLedger", "FleetScheduler", "KVSpec", "PagedKVStore",
    "PrefillRunner", "Request", "SLOClass", "ServeConfig", "ServingEngine", "TenantSpec",
    "TrafficScenario", "make_engine", "make_kvstore", "replay", "scenario",
]
