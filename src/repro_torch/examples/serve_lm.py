"""Serving example of the port: requests through the colocated engine, with
a decoupled-analytics sample per tick (the paper's Listing-1 pattern
applied to an inference fleet); the counterpart of the reference's
`examples/serve_lm.py`.

    python -m repro_torch.examples.serve_lm [--scenario NAME] [--continuous] [--paged]
        [--trace PATH] [--smoke] [--device cpu] [--seed 0]

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

The reference's ``--disagg`` and ``--adapt`` (ROADMAP A9), ``--spec``
(A6), and ``--fail-at`` / ``--preempt-at`` (the fleet's fault paths, A9)
name engines that are not ported yet: they raise.
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
from repro_torch.serve import EngineConfig, KVSpec, Request, make_engine
from repro_torch.serve.sched import FleetScheduler
from repro_torch.serve.traffic import SCENARIOS, replay, scenario

ARCH = "qwen2.5-3b"
# the reference example's settings
MAX_BATCH = 4
MAX_LEN = 160
TOKEN_BUDGET = 2000
AGING = 0.05
BLOCK_SIZE = 16

_NOT_PORTED = {
    "disagg": "the disaggregated engine is not ported yet (ROADMAP A9)",
    "adapt": "the adaptive fleet is not ported yet (ROADMAP A9)",
    "spec": "speculative decoding is not ported yet (ROADMAP A6)",
    "fail_at": "fault injection needs the fleet engine, not ported yet (ROADMAP A9)",
    "preempt_at": "fault injection needs the fleet engine, not ported yet (ROADMAP A9)",
}


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
    for flag in ("--disagg", "--adapt", "--spec"):
        ap.add_argument(flag, action="store_true", help="not ported yet (raises)")
    for flag in ("--fail-at", "--preempt-at"):
        ap.add_argument(flag, type=int, default=None, metavar="TICK",
                        help="not ported yet (raises)")
    args = ap.parse_args(argv)
    for name, why in _NOT_PORTED.items():
        if getattr(args, name) not in (None, False):
            raise NotImplementedError(f"--{name.replace('_', '-')}: {why}")
    return args


def build_model(*, smoke: bool = False, device=None, seed: int = 0):
    """(model, params): qwen2.5-3b at full width (or its reduced config)
    with random weights from ``seed``, on the card unless ``device``
    names another."""
    from repro_torch.configs import get, get_smoke
    from repro_torch.models.model_zoo import build

    model = build(get_smoke(ARCH) if smoke else get(ARCH), device=device)
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


def drive_scenario(eng, cfg, sc, on_tick=None):
    analytics = []

    def tick(e):
        analytics.append(e.workload_sample())
        if on_tick is not None:
            on_tick(e)

    pairs = replay(eng, sc, cfg.vocab_size, on_tick=tick)
    return len(pairs), analytics


def serve(model, params, *, scenario_name: str | None = None, continuous: bool = False,
          paged: bool = False, trace: str | None = None, on_tick=None) -> dict:
    """Build the engine the flags describe, drive it, and
    return what the example reports. ``on_tick(engine)`` runs after every
    tick (the caller's own sampling). The metrics registry is zeroed at
    the start, so its counts are this run's; with ``trace`` the tracer is
    on from before the engine is built until the trace is written."""
    sc = scenario(scenario_name) if scenario_name else None
    sched = FleetScheduler(sc.tenants, token_budget=TOKEN_BUDGET, aging=AGING) if sc else None
    batching = "continuous" if (continuous or paged) else "aligned"
    kv = KVSpec(kind="paged", block_size=BLOCK_SIZE, prefix_cache=True) if paged else KVSpec()
    mode = "colocated" + ("" if batching == "aligned" else
                          "+paged" if paged else "+continuous")
    obs_registry.reset()
    if trace:
        obs_trace.enable()
    try:
        eng = make_engine(model, params, EngineConfig(max_batch=MAX_BATCH, max_len=MAX_LEN,
                                                      mode=batching, kv=kv), sched=sched)
        t0 = time.perf_counter()
        if sc is not None:
            n_requests, analytics = drive_scenario(eng, model.cfg, sc, on_tick)
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
    if eng.kv.kind == "paged":
        print(f"prefix cache: {eng.stats['prefix_hit_tokens']} hit tokens, "
              f"{eng.stats['prefill_skips']} prefill skips")
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
    out = serve(model, params, scenario_name=args.scenario, continuous=args.continuous,
                paged=args.paged, trace=args.trace)
    report(out)
    return out


if __name__ == "__main__":
    main()
