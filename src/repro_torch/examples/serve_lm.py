"""Serving example of the port: requests through the colocated engine, with
a decoupled-analytics sample per tick (the paper's Listing-1 pattern
applied to an inference fleet); the counterpart of the reference's
`examples/serve_lm.py`.

    python -m repro_torch.examples.serve_lm [--scenario NAME] [--continuous] [--paged]
        [--disagg] [--adapt] [--fail-at TICK] [--preempt-at TICK] [--fault-rows N]
        [--preempt-duration TICKS] [--spec [--spec-k K] [--draft NAME]] [--trace PATH]
        [--smoke] [--device cpu] [--seed 0]

It serves qwen2.5-3b at full width with random bf16 weights from
``--seed`` on the card unless ``--device`` names another device;
``--smoke`` serves the reference example's own reduced config instead.

``--scenario NAME`` replays a named, reproducible traffic scenario
(`serve/traffic.py`) through the multi-tenant scheduler: weighted-fair
queuing with SLO classes and a token budget, latency accounting per
tenant in the `FleetLedger`. Without it, ten short requests are drained.
``--continuous`` switches to slot-level continuous batching; ``--paged``
adds the paged KV store with the cross-tenant prefix cache (and implies
continuous batching). ``--trace PATH`` records a Chrome/Perfetto trace of
the run (open it at https://ui.perfetto.dev or chrome://tracing).

``--spec`` serves through the speculative draft -> verify engine
(`serve/spec.py`, implies continuous batching, composes with
``--paged`` and ``--scenario``): the ``--draft`` model drafts
``--spec-k``-token blocks that the target scores in one verify forward.
At full width the draft is the full-width ``--draft`` config with random
bf16 weights from ``--seed + 1``; with ``--smoke`` the engine builds the
draft's reduced config itself, as the reference's does.

``--disagg`` serves through the disaggregated engine
(`serve/disagg.py`): a prefill group hands KV caches to the decode slot
pool. ``--adapt`` (with ``--scenario``) closes the measure -> plan ->
regroup loop of the serving fleet (`serve/fleet.py`): the prefill/decode
split re-sizes against the live traffic mix. ``--fail-at TICK`` loses
``--fault-rows`` rows without notice (the orphans are admitted again at
their original arrival ticks), ``--preempt-at TICK`` preempts them with
notice (their slots are staged to the host, and the rows return after
``--preempt-duration`` ticks); fault flags need ``--scenario`` and serve
through the fleet in continuous mode.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.obs import export as obs_export
from repro_torch.obs import registry as obs_registry
from repro_torch.obs import trace as obs_trace
from repro_torch.core.adapt import AdaptPolicy
from repro_torch.serve import (
    DisaggConfig,
    EngineConfig,
    FleetConfig,
    KVSpec,
    Request,
    SpecConfig,
    make_engine,
)
from repro_torch.serve.sched import FleetScheduler
from repro_torch.serve.traffic import SCENARIOS, replay, scenario

ARCH = "qwen2.5-3b"
# the reference example's settings
MAX_BATCH = 4
MAX_LEN = 160
TOKEN_BUDGET = 2000
AGING = 0.05
BLOCK_SIZE = 16
DRAFT = "qwen1.5-0.5b"
DISAGG = dict(n_prefill_rows=2, decode_slots=4)
FLEET = dict(n_rows=8, prefill_rows=2, slots_per_row=1, prefill_chunk=16)
ADAPT = dict(window=4, cooldown=4, speedup_threshold=1.1, row_budget=5)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default=None, choices=sorted(SCENARIOS),
                    help="replay a named traffic scenario through the multi-tenant scheduler")
    ap.add_argument("--continuous", action="store_true",
                    help="slot-level continuous batching (same-tick refill)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV blocks + cross-tenant prefix cache (implies --continuous)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a Chrome/Perfetto trace of the run to PATH")
    ap.add_argument("--smoke", action="store_true",
                    help=f"serve {ARCH}'s reduced config (the reference example's)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--spec", action="store_true",
                    help="speculative draft->verify decoding (implies --continuous)")
    ap.add_argument("--spec-k", type=int, default=4, metavar="K",
                    help="draft block length per verify step (with --spec)")
    ap.add_argument("--draft", default=DRAFT, help="zoo name of the draft model (with --spec)")
    ap.add_argument("--disagg", action="store_true",
                    help="serve through the prefill/decode-disaggregated engine")
    ap.add_argument("--adapt", action="store_true",
                    help="close the prefill/decode re-sizing loop (needs --scenario)")
    ap.add_argument("--fail-at", type=int, default=None, metavar="TICK",
                    help="lose --fault-rows rows WITHOUT notice at TICK (device loss)")
    ap.add_argument("--preempt-at", type=int, default=None, metavar="TICK",
                    help="preempt --fault-rows rows WITH notice at TICK (slots staged to "
                         "the host; the rows return after --preempt-duration ticks)")
    ap.add_argument("--fault-rows", type=int, default=1)
    ap.add_argument("--preempt-duration", type=int, default=8)
    args = ap.parse_args(argv)
    faulted = args.fail_at is not None or args.preempt_at is not None
    if args.spec and (args.disagg or args.adapt or faulted):
        raise SystemExit("--spec composes with --paged/--scenario, not "
                         "--disagg/--adapt/fault flags")
    if (args.adapt or faulted) and args.scenario is None:
        raise SystemExit("--adapt / fault injection need --scenario")
    return args


def build_model(*, smoke: bool = False, device=None, seed: int = 0):
    """(model, params): qwen2.5-3b at full width (or its reduced config)
    with random weights from ``seed``, on the card unless ``device``
    names another."""
    from repro_torch.configs import get, get_smoke
    from repro_torch.models.model_zoo import build

    model = build(get_smoke(ARCH) if smoke else get(ARCH), device=device)
    return model, model.init(seed)


def build_draft(name: str = DRAFT, *, device=None, seed: int = 1):
    """(model, params) of the full-width ``name`` draft with random weights
    from ``seed``, on the card unless ``device`` names another."""
    from repro_torch.configs import get
    from repro_torch.models.model_zoo import build

    model = build(get(name), device=device)
    return model, model.init(seed)


def drive_legacy(eng, cfg, n_requests: int = 10, on_tick=None):
    """The reference example's request list: ten short prompts drained."""
    rng = np.random.default_rng(0)
    for i in range(n_requests):
        prompt = rng.integers(0, cfg.vocab_size, size=rng.integers(2, 6))
        eng.submit(Request(uid=i, prompt=prompt.astype(np.int32),
                           max_new_tokens=int(rng.integers(4, 12))))
    analytics = []
    while not eng.idle():
        eng.step()
        analytics.append(eng.workload_sample())  # -> decoupled analytics group
        if on_tick is not None:
            on_tick(eng)
        if len(analytics) > 500:
            raise RuntimeError("engine did not drain")
    return n_requests, analytics


def drive_scenario(eng, cfg, sc, on_tick=None, **fault_kw):
    analytics = []

    def tick(e):
        analytics.append(e.workload_sample())
        if on_tick is not None:
            on_tick(e)

    pairs = replay(eng, sc, cfg.vocab_size, on_tick=tick, **fault_kw)
    return len(pairs), analytics


def engine_config(*, batching: str, kv: KVSpec, spec: bool = False, spec_k: int = 4,
                  draft_name: str = DRAFT, disagg: bool = False, adapt: bool = False,
                  faulted: bool = False):
    """(config, mode label): the reference example's engine for the flags."""
    if spec:
        return (SpecConfig(max_batch=MAX_BATCH, max_len=MAX_LEN, mode=batching, kv=kv,
                           spec_k=spec_k, draft=draft_name), f"speculative k={spec_k}")
    if adapt or faulted:
        mode = ("adaptive-disagg" if adapt else "fleet") + ("+faults" if faulted else "")
        return (FleetConfig(max_len=MAX_LEN, mode=batching, kv=kv,
                            adapt=AdaptPolicy(**ADAPT) if adapt else None, **FLEET), mode)
    if disagg:
        return (DisaggConfig(max_len=MAX_LEN, mode=batching, kv=kv, **DISAGG),
                "disaggregated")
    return EngineConfig(max_batch=MAX_BATCH, max_len=MAX_LEN, mode=batching, kv=kv), "colocated"


def serve(model, params, *, scenario_name: str | None = None, continuous: bool = False,
          paged: bool = False, trace: str | None = None, on_tick=None, spec: bool = False,
          spec_k: int = 4, draft_name: str = DRAFT, draft=None, disagg: bool = False,
          adapt: bool = False, fail_at: int | None = None, preempt_at: int | None = None,
          fault_rows: int = 1, preempt_duration: int = 8) -> dict:
    """Build the engine the flags describe, drive it, and
    return what the example reports. ``on_tick(engine)`` runs after every
    tick (the caller's own sampling). The metrics registry is zeroed at
    the start, so its counts are this run's; with ``trace`` the tracer is
    on from before the engine is built until the trace is written.
    ``spec`` serves through `SpecEngine` with ``draft`` (a ``(model,
    params)`` pair; None builds ``draft_name``'s reduced config);
    ``disagg`` through `DisaggEngine`; ``adapt`` or a fault
    (``fail_at`` / ``preempt_at``, a scenario's tick) through the fleet."""
    faulted = fail_at is not None or preempt_at is not None
    if (adapt or faulted) and not scenario_name:
        raise ValueError("adapt / fault injection need a scenario")
    sc = scenario(scenario_name) if scenario_name else None
    sched = FleetScheduler(sc.tenants, token_budget=TOKEN_BUDGET, aging=AGING) if sc else None
    batching = "continuous" if (continuous or paged or spec or faulted) else "aligned"
    kv = KVSpec(kind="paged", block_size=BLOCK_SIZE, prefix_cache=True) if paged else KVSpec()
    engine_cfg, mode = engine_config(batching=batching, kv=kv, spec=spec, spec_k=spec_k,
                                     draft_name=draft_name, disagg=disagg, adapt=adapt,
                                     faulted=faulted)
    mode += "" if batching == "aligned" else "+paged" if paged else "+continuous"
    fault_kw = dict(fail_at=fail_at, preempt_at=preempt_at, fault_rows=fault_rows,
                    preempt_duration=preempt_duration) if faulted else {}
    obs_registry.reset()
    if trace:
        obs_trace.enable()
    try:
        eng = make_engine(model, params, engine_cfg, sched=sched,
                          draft=draft if spec else None)
        t0 = time.perf_counter()
        if sc is not None:
            n_requests, analytics = drive_scenario(eng, model.cfg, sc, on_tick, **fault_kw)
        else:
            n_requests, analytics = drive_legacy(eng, model.cfg, on_tick=on_tick)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        seconds = time.perf_counter() - t0
        metrics = obs_registry.get_registry().snapshot()
        obj = obs_export.write_trace(trace, metrics=metrics) if trace else None
    finally:
        tracer = obs_trace.disable() if trace else None
    out = {"engine": eng, "mode": mode, "scenario": sc, "requests": n_requests,
           "paged": paged, "disagg": disagg, "adapt": adapt, "faulted": faulted,
           "analytics": analytics, "seconds": seconds,
           "device": (torch.cuda.get_device_name(model.device)
                      if model.device.type == "cuda" else "CPU"),
           "metrics": metrics, "trace": None}
    if trace:
        out["trace"] = {"path": trace, "events": len(obj["traceEvents"]),
                        "bytes": os.path.getsize(trace), "dropped": tracer.dropped,
                        "lifecycle": tracer.lifecycle_report(), "tracer": tracer}
    return out


def report(out: dict) -> None:
    """Print what the reference example prints; the rate is labelled with
    the device it was measured on."""
    eng, analytics = out["engine"], out["analytics"]
    tokens_out = eng.stats["tokens_out"]
    print(f"[{out['mode']}] served {out['requests']} requests, {tokens_out} tokens in "
          f"{len(analytics)} ticks ({tokens_out / out['seconds']:.1f} tok/s on "
          f"{out['device']})")
    occ = np.mean([a["active_slots"] for a in analytics])
    print(f"mean slot occupancy {occ:.2f}, final queue depth "
          f"{analytics[-1]['queue_depth']}")
    if out["disagg"] and not out["adapt"]:
        ttft = [r.first_token_tick - r.submitted_tick for r in eng.finished]
        print(f"prefills handed off: {eng.stats['handoffs']}, "
              f"mean TTFT {np.mean(ttft):.1f} ticks")
    if out["paged"]:
        print(f"prefix cache: {eng.stats['prefix_hit_tokens']} hit tokens, "
              f"{eng.stats['prefill_skips']} prefill skips")
    if "verify_calls" in eng.stats:
        acc = eng.ledger.acceptance_rate()
        verify_calls = max(1, eng.stats["verify_calls"])
        print(f"speculative: acceptance rate {acc:.2f}, rows draft/verify = "
              f"{eng.draft_rows}/{eng.n_rows - eng.draft_rows}, "
              f"{eng.stats['tokens_out'] / verify_calls:.2f} tokens per verify step "
              f"(drafted {eng.stats['drafted']}, accepted {eng.stats['accepted']})")
    if out["adapt"]:
        print(f"regroups: {eng.regroups} (deferred {eng.deferrals}), final "
              f"prefill rows {eng.prefill_rows}/{eng.cfg.n_rows}, "
              f"decode slots {eng.decode_slots}")
    if out["faulted"]:
        finished = {r.uid for r in eng.finished}
        rec = eng.recoveries
        print(f"faults: {len(eng.fault_log)} events, recoveries "
              f"staged={rec['staged']} restored={rec['restored']} "
              f"retried={rec['retried']}, regrows={eng.regrows}, "
              f"rows {eng.n_rows}/{eng.cfg.n_rows}, "
              f"lost {out['requests'] - len(finished)}")
    if out["scenario"] is not None:
        snap = eng.ledger.snapshot()
        print(f"fleet: ttft p50/p99 = {snap['ttft_p50']:.0f}/{snap['ttft_p99']:.0f} "
              f"ticks, latency p99 = {snap['latency_p99']:.0f} ticks, "
              f"good tokens {snap['good_tokens']}/{snap['tokens_out']}")
        for name, rec in sorted(snap["by_tenant"].items()):
            print(f"  tenant {name:<12} n={rec['completions']:<4} "
                  f"ttft_p99={rec['ttft_p99']:.0f} "
                  f"latency_p99={rec['latency_p99']:.0f} "
                  f"good={rec['good_tokens']}")
    if out["trace"] is not None:
        tr = out["trace"]
        print(f"trace: {tr['events']} events ({tr['dropped']} dropped), "
              f"{tr['lifecycle']['begins']} request flows -> {tr['path']}")


def main(argv=None) -> dict:
    args = parse_args(argv)
    model, params = build_model(smoke=args.smoke, device=args.device, seed=args.seed)
    draft = None
    if args.spec and not args.smoke:
        draft = build_draft(args.draft, device=args.device, seed=args.seed + 1)
    out = serve(model, params, scenario_name=args.scenario, continuous=args.continuous,
                paged=args.paged, trace=args.trace, spec=args.spec, spec_k=args.spec_k,
                draft_name=args.draft, draft=draft, disagg=args.disagg, adapt=args.adapt,
                fail_at=args.fail_at, preempt_at=args.preempt_at, fault_rows=args.fault_rows,
                preempt_duration=args.preempt_duration)
    report(out)
    return out


if __name__ == "__main__":
    main()
