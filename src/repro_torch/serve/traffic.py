"""ServeFleet traffic engine: named, reproducible arrival scenarios (a
copy of the reference's `serve/traffic.py`, draw for draw: the same
seeds give the same events and the same prompts in both packages).

Traffic is a first-class, deterministic object:

  * an arrival process per tenant (Poisson, bursty on/off
    Markov-modulated, diurnal rate modulation) driven by one seeded
    generator, so ``scenario(name).generate()`` is bit-reproducible;
  * per-tenant prompt/output-length distributions drawn from the
    existing `core.imbalance.ImbalanceModel` lognormal/pareto branches
    (`sample_lengths`) — the same heavy tails the T_sigma analysis
    models, now injected as traffic;
  * a record/replay trace format (plain JSON event lists) so a measured
    trace can be replayed against any engine or scheduler change.

Scenarios are *declared* (tenants + processes + horizon), *generated*
(a sorted list of `ArrivalEvent`s), and *materialized* into
`serve.engine.Request`s when handed to an engine. `SCENARIOS` names the
canonical ones the reference's tests and benchmarks share. Fault events
need an engine with ``inject_fault`` (the fleet, ROADMAP A9): `replay`
refuses them on the colocated engine.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.imbalance import ImbalanceModel
from repro_torch.serve.faults import events_from_hooks, validate_events


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A latency target class: how long a request may wait.

    Deadlines are in engine *ticks* (the common clock of both engines);
    the virtual-clock benchmarks convert ticks to seconds afterwards.
    ``ttft_deadline`` bounds submit -> first token (prefill queueing is
    the disaggregation-sensitive part), ``latency_deadline`` bounds
    submit -> done; ``weight`` is the class's WFQ share multiplier.
    """

    name: str = "standard"
    ttft_deadline: int = 64
    latency_deadline: int = 512
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Deterministic-in-seed arrival process of one tenant.

    ``poisson``: iid Poisson(rate) arrivals per tick. ``bursty``: a
    two-state Markov-modulated Poisson process — rate is multiplied by
    ``burst_factor`` while the on-state holds (mean ``burst_on`` ticks,
    off for mean ``burst_off``). ``diurnal``: the rate follows a
    sinusoid of ``period`` ticks and modulation ``depth`` (the
    load-follows-the-sun pattern, compressed to tick scale).
    """

    kind: str = "poisson"  # poisson | bursty | diurnal
    burst_factor: float = 6.0
    burst_on: int = 6
    burst_off: int = 24
    period: int = 64
    depth: float = 0.8

    def rates(self, rate: float, horizon: int, rng: np.random.Generator) -> np.ndarray:
        """Per-tick mean arrival rate over the horizon."""
        t = np.arange(horizon, dtype=np.float64)
        if self.kind == "poisson":
            return np.full(horizon, rate)
        if self.kind == "diurnal":
            return rate * (1.0 + self.depth * np.sin(2.0 * math.pi * t / self.period))
        if self.kind == "bursty":
            on = False
            mod = np.empty(horizon)
            for k in range(horizon):
                flip = 1.0 / max(self.burst_on if on else self.burst_off, 1)
                if rng.random() < flip:
                    on = not on
                mod[k] = self.burst_factor if on else 1.0
            return rate * mod
        raise ValueError(self.kind)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic contract: share, mix, and SLO.

    ``rate`` is mean requests per tick; ``surge_at``/``surge_factor``
    model a *drifting* mix (the tenant's rate jumps mid-run — the
    traffic-side analogue of the PIC current sheet moving), which is
    what the closed-loop fleet (serve/fleet.py) re-sizes against.
    Prompt/output lengths come from `ImbalanceModel` draws: lognormal
    for chat-like traffic, pareto for heavy-tailed batch jobs.
    """

    name: str
    rate: float = 0.5
    weight: float = 1.0
    prompt: ImbalanceModel = ImbalanceModel(kind="lognormal", mean=24.0, sigma=0.5)
    output: ImbalanceModel = ImbalanceModel(kind="lognormal", mean=8.0, sigma=0.3)
    min_prompt: int = 2
    min_output: int = 1
    arrivals: ArrivalProcess = ArrivalProcess()
    slo: SLOClass = SLOClass()
    surge_at: int = -1  # tick at which the rate jumps (-1: never)
    surge_factor: float = 1.0
    # system-prompt modeling: every request of this tenant starts with
    # the same `shared_prefix` tokens (drawn once per tenant), the
    # workload shape the cross-tenant prefix cache (serve/kvstore.py)
    # deduplicates. 0 = fully independent prompts (the historic draw,
    # bit-for-bit).
    shared_prefix: int = 0


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """One request arrival — the unit of the record/replay trace."""

    tick: int
    tenant: str
    uid: int
    prompt_len: int
    max_new_tokens: int


@dataclasses.dataclass(frozen=True)
class TrafficScenario:
    """A named, reproducible traffic mix over a finite horizon."""

    name: str
    tenants: tuple[TenantSpec, ...]
    horizon: int = 64
    seed: int = 0
    max_prompt: int | None = None  # cap prompt draws (engine max_len guard)
    max_output: int | None = None
    # declared faults (serve.faults.FaultEvent) — part of the scenario so a
    # recorded trace replays its failures as deterministically as its traffic
    faults: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "faults", validate_events(self.faults))

    def tenant(self, name: str) -> TenantSpec:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(name)

    def generate(self) -> list[ArrivalEvent]:
        """Deterministic event list, sorted by (tick, tenant order).

        Each tenant gets its own child generator derived from
        (scenario seed, tenant index), so adding a tenant never
        perturbs the others' draws.
        """
        events: list[ArrivalEvent] = []
        for idx, ten in enumerate(self.tenants):
            rng = np.random.default_rng((self.seed, idx))
            rates = ten.arrivals.rates(ten.rate, self.horizon, rng)
            if ten.surge_at >= 0:
                rates = rates.copy()
                rates[ten.surge_at :] *= ten.surge_factor
            counts = rng.poisson(rates)
            n_total = int(counts.sum())
            plens = ten.prompt.sample_lengths(
                n_total, rng, minimum=ten.min_prompt, cap=self.max_prompt
            )
            olens = ten.output.sample_lengths(
                n_total, rng, minimum=ten.min_output, cap=self.max_output
            )
            i = 0
            for tick, c in enumerate(counts):
                for _ in range(int(c)):
                    events.append(
                        ArrivalEvent(
                            tick=tick,
                            tenant=ten.name,
                            uid=-1,  # assigned after the global sort
                            prompt_len=int(plens[i]),
                            max_new_tokens=int(olens[i]),
                        )
                    )
                    i += 1
        order = {t.name: i for i, t in enumerate(self.tenants)}
        events.sort(key=lambda e: (e.tick, order[e.tenant]))
        events = [dataclasses.replace(e, uid=i) for i, e in enumerate(events)]
        return events

    def requests(self, vocab_size: int, events: Sequence[ArrivalEvent] | None = None):
        """Materialize events into `(event, Request)` pairs.

        Token ids are drawn from a generator keyed by (seed, uid), so a
        replayed trace reproduces the exact prompts bit-for-bit. A
        tenant with ``shared_prefix > 0`` gets its per-tenant system
        prompt (keyed by (seed, tenant index)) spliced in front, with
        the per-uid draw filling the rest of the declared length.
        """
        from repro_torch.serve.engine import Request

        prefixes: dict[str, np.ndarray] = {}
        for idx, ten in enumerate(self.tenants):
            if ten.shared_prefix > 0:
                prng = np.random.default_rng((self.seed, 0x51F1, idx))
                prefixes[ten.name] = prng.integers(
                    0, vocab_size, ten.shared_prefix
                ).astype(np.int32)

        out = []
        for e in events if events is not None else self.generate():
            rng = np.random.default_rng((self.seed, 0x70C5, e.uid))
            pre = prefixes.get(e.tenant)
            if pre is None:
                prompt = rng.integers(0, vocab_size, e.prompt_len).astype(np.int32)
            else:
                head = pre[: e.prompt_len]
                tail_n = e.prompt_len - head.shape[0]
                tail = rng.integers(0, vocab_size, tail_n).astype(np.int32)
                prompt = np.concatenate([head, tail])
            out.append(
                (e, Request(uid=e.uid, prompt=prompt, max_new_tokens=e.max_new_tokens,
                            tenant=e.tenant))
            )
        return out


# -- record / replay -----------------------------------------------------------


def replay(
    engine,
    sc: TrafficScenario,
    vocab_size: int,
    *,
    events: Sequence[ArrivalEvent] | None = None,
    on_tick=None,
    max_ticks: int = 5000,
    fail_at: int | None = None,
    preempt_at: int | None = None,
    fault_rows: int = 1,
    preempt_duration: int = 0,
):
    """Drive an engine through a scenario: submit each event's request
    at its tick, step once per tick, continue until the horizon has
    passed AND the engine has drained.

    THE replay loop — examples, benchmarks and tests all route through
    it so the submit-before-step ordering and the drain guard cannot
    silently diverge between them. ``on_tick(engine)`` runs after every
    step (analytics sampling, virtual-clock accumulation). Returns the
    materialized `(event, Request)` pairs.

    Faults: the scenario's declared ``faults`` tuple plus the
    ``fail_at``/``preempt_at`` convenience hooks (lose ``fault_rows``
    rows at that tick; preempted rows return after ``preempt_duration``
    ticks) are injected into the engine before the loop starts — the
    engine must expose `inject_fault` (FleetEngine) when any are set.
    """
    fault_events = tuple(sc.faults) + events_from_hooks(
        sc.horizon,
        fail_at=fail_at,
        preempt_at=preempt_at,
        fault_rows=fault_rows,
        preempt_duration=preempt_duration,
    )
    if fault_events:
        inject = getattr(engine, "inject_fault", None)
        if inject is None:
            raise ValueError(
                "fault injection needs an engine with inject_fault "
                "(serve.fleet.FleetEngine in continuous mode)"
            )
        for ev in fault_events:
            inject(ev)
    pairs = sc.requests(vocab_size, events)
    by_tick: dict[int, list] = {}
    for e, r in pairs:
        by_tick.setdefault(e.tick, []).append(r)
    t = 0
    while t <= sc.horizon or not engine.idle():
        for r in by_tick.get(t, []):
            engine.submit(r)
        engine.step()
        if on_tick is not None:
            on_tick(engine)
        t += 1
        if t > max_ticks:
            raise RuntimeError(f"engine did not drain within {max_ticks} ticks")
    return pairs


def save_trace(path: str, scenario_name: str, events: Iterable[ArrivalEvent]) -> None:
    """Write a replayable JSON trace (the record side)."""
    with open(path, "w") as f:
        json.dump(
            {
                "scenario": scenario_name,
                "events": [dataclasses.asdict(e) for e in events],
            },
            f,
            indent=2,
            sort_keys=True,
        )
        f.write("\n")


def load_trace(path: str) -> tuple[str, list[ArrivalEvent]]:
    """Read a recorded trace back into events (the replay side)."""
    with open(path) as f:
        raw = json.load(f)
    return raw["scenario"], [ArrivalEvent(**e) for e in raw["events"]]


# -- named scenarios -----------------------------------------------------------

INTERACTIVE_SLO = SLOClass(name="interactive", ttft_deadline=24, latency_deadline=96,
                           weight=2.0)
BATCH_SLO = SLOClass(name="batch", ttft_deadline=160, latency_deadline=640, weight=1.0)


def _single_fifo() -> TrafficScenario:
    """One tenant, steady Poisson arrivals — the scenario under which
    the FleetScheduler must reproduce the pre-ServeFleet deque engines
    bit-for-bit (asserted by tests and fig13)."""
    return TrafficScenario(
        name="single-fifo",
        tenants=(
            TenantSpec(
                name="default",
                rate=0.8,
                prompt=ImbalanceModel(kind="lognormal", mean=10.0, sigma=0.4),
                output=ImbalanceModel(kind="lognormal", mean=5.0, sigma=0.3),
            ),
        ),
        horizon=24,
        seed=7,
        max_prompt=40,
        max_output=8,
    )


def _bursty_multitenant() -> TrafficScenario:
    """Three tenants with drift: interactive chat (short prompts, tight
    TTFT), a batch/RAG tenant whose heavy-tailed long prompts *surge*
    mid-run (the prefill-bound phase the adaptive fleet must chase),
    and a background trickle. fig13's headline scenario."""
    return TrafficScenario(
        name="bursty-multitenant",
        tenants=(
            TenantSpec(
                name="chat",
                rate=0.9,
                weight=2.0,
                prompt=ImbalanceModel(kind="lognormal", mean=10.0, sigma=0.4),
                output=ImbalanceModel(kind="lognormal", mean=6.0, sigma=0.3),
                arrivals=ArrivalProcess(kind="bursty", burst_factor=3.0,
                                        burst_on=4, burst_off=12),
                slo=INTERACTIVE_SLO,
            ),
            TenantSpec(
                name="rag",
                rate=0.25,
                weight=1.0,
                prompt=ImbalanceModel(kind="pareto", mean=48.0, sigma=0.8,
                                      pareto_shape=2.5),
                output=ImbalanceModel(kind="lognormal", mean=4.0, sigma=0.3),
                arrivals=ArrivalProcess(kind="bursty", burst_factor=4.0,
                                        burst_on=6, burst_off=16),
                slo=BATCH_SLO,
                surge_at=28,
                surge_factor=5.0,
            ),
            TenantSpec(
                name="background",
                rate=0.1,
                weight=0.5,
                prompt=ImbalanceModel(kind="lognormal", mean=20.0, sigma=0.5),
                output=ImbalanceModel(kind="lognormal", mean=6.0, sigma=0.3),
                slo=BATCH_SLO,
            ),
        ),
        horizon=56,
        seed=11,
        max_prompt=120,
        max_output=10,
    )


def _diurnal_mix() -> TrafficScenario:
    """Two tenants on out-of-phase diurnal cycles — slow, periodic
    drift (vs the step drift of bursty-multitenant)."""
    return TrafficScenario(
        name="diurnal-mix",
        tenants=(
            TenantSpec(
                name="day",
                rate=0.6,
                arrivals=ArrivalProcess(kind="diurnal", period=48, depth=0.9),
                slo=INTERACTIVE_SLO,
            ),
            TenantSpec(
                name="night",
                rate=0.3,
                prompt=ImbalanceModel(kind="pareto", mean=32.0, sigma=0.7),
                arrivals=ArrivalProcess(kind="diurnal", period=48, depth=-0.9),
                slo=BATCH_SLO,
            ),
        ),
        horizon=48,
        seed=3,
        max_prompt=96,
        max_output=8,
    )


def _bursty_prefix() -> TrafficScenario:
    """bursty-multitenant's arrival shape with system prompts: chat and
    rag requests share a long per-tenant prefix (the agent/system
    prompt every production request carries), so the cross-tenant
    prefix cache gets full-block hits while the background tenant
    stays cold. fig14's prefix-cache scenario."""
    base = _bursty_multitenant()
    tenants = tuple(
        dataclasses.replace(
            t,
            shared_prefix={"chat": 24, "rag": 48}.get(t.name, 0),
            prompt=dataclasses.replace(
                t.prompt, mean=t.prompt.mean + {"chat": 24, "rag": 48}.get(t.name, 0)
            ),
        )
        for t in base.tenants
    )
    return dataclasses.replace(base, name="bursty-prefix", tenants=tenants)


SCENARIOS = {
    "single-fifo": _single_fifo,
    "bursty-multitenant": _bursty_multitenant,
    "diurnal-mix": _diurnal_mix,
    "bursty-prefix": _bursty_prefix,
}


def scenario(name: str) -> TrafficScenario:
    """Look up a named scenario (every call builds a fresh instance)."""
    try:
        return SCENARIOS[name]()
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}"
        ) from None


__all__ = [
    "ArrivalEvent",
    "ArrivalProcess",
    "SCENARIOS",
    "SLOClass",
    "TenantSpec",
    "TrafficScenario",
    "load_trace",
    "replay",
    "save_trace",
    "scenario",
]
