"""Serving layer of the port: one engine API over the colocated,
speculative, disaggregated and fleet constructions, behind `make_engine`.

  * build an engine: `make_engine(model, params, cfg)` with a
    `ServeConfig` subclass: `EngineConfig` (colocated), `SpecConfig`
    (speculative draft -> verify), `DisaggConfig` (prefill/decode split),
    `FleetConfig` (the closed loop, with its fault paths). Every engine
    implements the `ServingEngine` protocol (``submit / step / drain /
    stats``), so callers never branch on the engine's type.
  * choose KV and batching: ``ServeConfig.mode`` ("aligned" or
    "continuous") and ``ServeConfig.kv`` (a `KVSpec`: dense, or paged
    blocks with the cross-tenant prefix cache).
  * drive traffic: `scenario(name)` / `replay(engine, sc, vocab)` through
    the multi-tenant `FleetScheduler`, accounted in the `FleetLedger`.
  * survive faults: a `FaultSchedule` of seeded device-loss, preemption
    and slow-node events (or `replay`'s ``fail_at`` / ``preempt_at``
    hooks) drives `FleetEngine`'s recovery: a smaller fleet, staged KV or a
    `ServingCheckpointer` restore, re-admission at the original arrival
    ticks, no request lost.
"""
from repro_torch.serve.api import KVSpec, ServeConfig, ServingEngine, make_engine
from repro_torch.serve.checkpoint_bridge import ServingCheckpointer
from repro_torch.serve.disagg import DisaggConfig, DisaggEngine
from repro_torch.serve.engine import Engine, EngineConfig, PrefillRunner, Request
from repro_torch.serve.faults import FailureMonitor, FaultEvent, FaultSchedule
from repro_torch.serve.fleet import (
    FleetConfig,
    FleetEngine,
    reshard_paged_serving_state,
    reshard_serving_state,
)
from repro_torch.serve.kvstore import DenseKVStore, PagedKVStore, PrefixCache, make_kvstore
from repro_torch.serve.sched import FleetLedger, FleetScheduler
from repro_torch.serve.spec import SpecConfig, SpecEngine
from repro_torch.serve.traffic import (
    SCENARIOS,
    SLOClass,
    TenantSpec,
    TrafficScenario,
    replay,
    scenario,
)

__all__ = [
    "SCENARIOS", "DenseKVStore", "DisaggConfig", "DisaggEngine", "Engine", "EngineConfig",
    "FailureMonitor", "FaultEvent", "FaultSchedule", "FleetConfig", "FleetEngine",
    "FleetLedger", "FleetScheduler", "KVSpec", "PagedKVStore", "PrefillRunner", "PrefixCache",
    "Request", "SLOClass", "ServeConfig", "ServingCheckpointer", "ServingEngine", "SpecConfig",
    "SpecEngine", "TenantSpec", "TrafficScenario", "make_engine", "make_kvstore", "replay",
    "reshard_paged_serving_state", "reshard_serving_state", "scenario",
]
