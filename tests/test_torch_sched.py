"""PyTorch port, the multi-tenant scheduler and the ledger
(`repro_torch.serve.sched`): seeded request streams over tenants,
weights, SLO classes, token budgets, aging and page gates through the
port's and the reference's `FleetScheduler` side by side (the same uids
popped on the same ticks, the same refusals, queues and virtual time);
the ledgers fed the same completions and ticks (equal snapshots and load
samples); then the reference's pure scheduler and ledger cases of
`tests/test_fleet.py` against the port.
"""
from collections import deque

import numpy as np
import pytest

from hypothesis_compat import given, settings, strategies as st
from repro.obs import registry as j_registry
from repro.serve.engine import Request as JRequest
from repro.serve.sched import FleetLedger as JFleetLedger
from repro.serve.sched import FleetScheduler as JFleetScheduler
from repro.serve.traffic import SLOClass as JSLOClass
from repro.serve.traffic import TenantSpec as JTenantSpec
from repro_torch.obs import registry
from repro_torch.serve.engine import Request
from repro_torch.serve.sched import FleetLedger, FleetScheduler
from repro_torch.serve.traffic import SLOClass, TenantSpec


def _req(uid, n_tokens, tenant="default", max_new=4):
    return Request(uid=uid, prompt=np.zeros(int(n_tokens), np.int32),
                   max_new_tokens=max_new, tenant=tenant)


def _tenants(rng):
    """2-4 tenants with random weights and SLO classes, in both packages."""
    names = ["chat", "rag", "batch", "bg"][: int(rng.integers(2, 5))]
    port, ref = [], []
    for name in names:
        slo = dict(name=f"slo-{name}", ttft_deadline=int(rng.integers(2, 40)),
                   latency_deadline=int(rng.integers(40, 200)),
                   weight=float(rng.choice([0.5, 1.0, 2.0])))
        w = float(rng.choice([0.1, 0.5, 1.0, 3.0, 8.0]))
        port.append(TenantSpec(name=name, weight=w, slo=SLOClass(**slo)))
        ref.append(JTenantSpec(name=name, weight=w, slo=JSLOClass(**slo)))
    return names, tuple(port), tuple(ref)


# (policy, token_budget, aging, urgent_slack, page gate) per case
CASES = [
    ("wfq", None, 0.0, 4, False),
    ("wfq", 120, 0.0, 4, False),
    ("wfq", 120, 0.05, 4, True),
    ("wfq", 60, 0.2, 0, True),
    ("wfq", None, 0.05, 8, True),
    ("wfq", 200, 0.0, 2, True),
    ("fifo", None, 0.0, 4, False),
    ("fifo", 90, 0.0, 4, True),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_scheduler_matches_reference(case, seed):
    """Both schedulers take the same submits and the same `take` calls
    (max_n, in-flight tokens, and with the page gate a free-token budget
    and a per-request page price that differs from the prompt length, so
    the token budget and the page gate bind apart): every tick they pop
    the same uids, refuse the same requests, and agree on every query."""
    policy, budget, aging, slack, paged = CASES[case]
    rng = np.random.default_rng((case, seed))
    names, t_ten, j_ten = _tenants(rng)
    kw = dict(policy=policy, token_budget=budget, aging=aging, urgent_slack=slack)
    port, ref = FleetScheduler(t_ten, **kw), JFleetScheduler(j_ten, **kw)
    registry.reset()
    j_registry.reset()
    uid = 0
    popped = 0
    for tick in range(80):
        for _ in range(int(rng.poisson(1.5))):
            n = int(rng.integers(1, 150))
            ten = str(rng.choice(names + ["unknown"]))
            m = int(rng.integers(1, 30))
            prompt = rng.integers(0, 100, n).astype(np.int32)
            a = port.submit(Request(uid=uid, prompt=prompt, max_new_tokens=m, tenant=ten),
                            now=tick)
            b = ref.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=m, tenant=ten),
                           now=tick)
            assert a == b
            uid += 1
        gate = {}
        if paged:
            # block-rounded prompt + output, less a uid-keyed "prefix discount"
            def price(r):
                n = int(r.prompt.shape[0]) + r.max_new_tokens
                return -(-n // 16) * 16 - 16 * (r.uid % 3 == 0)

            gate = {"free_tokens": int(rng.integers(0, 400)), "cost_fn": price}
        call = dict(max_n=int(rng.integers(1, 5)) if rng.random() < 0.8 else None,
                    inflight_tokens=int(rng.integers(0, 80)), **gate)
        got = [r.uid for r in port.take(tick, **call)]
        want = [r.uid for r in ref.take(tick, **call)]
        assert got == want, tick
        popped += len(got)
        assert port.rejected == ref.rejected
        assert port.pending() == ref.pending()
        assert port.pending_by_tenant() == ref.pending_by_tenant()
        assert port.pending_tokens() == ref.pending_tokens()
        assert [r.uid for r in port.queued_requests()] == \
               [r.uid for r in ref.queued_requests()]
        assert port._vtime == ref._vtime
    assert popped > 0
    assert registry.get_registry().snapshot() == j_registry.get_registry().snapshot()


def test_take_keeps_the_token_and_page_costs_apart():
    """The token budget counts prompt tokens and the page gate counts
    `cost_fn`'s price; neither stands in for the other."""
    s = FleetScheduler(token_budget=100)
    for i in range(4):
        s.submit(_req(i, 30), now=0)
    # pages are cheap: the token budget binds (3 x 30 <= 100 < 4 x 30)
    assert [r.uid for r in s.take(0, free_tokens=1000, cost_fn=lambda r: 1)] == [0, 1, 2]
    s = FleetScheduler(token_budget=100)
    for i in range(4):
        s.submit(_req(i, 30), now=0)
    # pages are dear: the page gate binds (2 x 64 <= 150 < 3 x 64)
    assert [r.uid for r in s.take(0, free_tokens=150, cost_fn=lambda r: 64)] == [0, 1]
    # the budget stops admission once it is used up, even with room left
    s = FleetScheduler(token_budget=60)
    for i in range(3):
        s.submit(_req(i, 30), now=0)
    assert [r.uid for r in s.take(0)] == [0, 1]


@pytest.mark.parametrize("window", [4, 64])
def test_ledger_matches_reference(window):
    rng = np.random.default_rng(window)
    port, ref = FleetLedger(window=window), JFleetLedger(window=window)
    registry.reset()
    j_registry.reset()
    slos = {"a": (SLOClass(name="i", ttft_deadline=5, latency_deadline=20),
                  JSLOClass(name="i", ttft_deadline=5, latency_deadline=20)),
            "b": (SLOClass(name="b", ttft_deadline=30, latency_deadline=90),
                  JSLOClass(name="b", ttft_deadline=30, latency_deadline=90))}
    for tick in range(50):
        for _ in range(int(rng.integers(0, 3))):
            ten = str(rng.choice(["a", "b"]))
            sub = int(rng.integers(0, tick + 1))
            first = sub + int(rng.integers(1, 20))
            toks = [int(x) for x in rng.integers(0, 9, int(rng.integers(1, 8)))]
            done = first + len(toks) + int(rng.integers(0, 3))
            for led, slo, cls in ((port, slos[ten][0], Request),
                                  (ref, slos[ten][1], JRequest)):
                r = cls(uid=tick, prompt=np.zeros(3, np.int32), tenant=ten)
                r.submitted_tick, r.first_token_tick, r.out_tokens = sub, first, list(toks)
                led.record_done(r, slo, done)
        acc = {"a": int(rng.integers(0, 3))} if tick % 3 else {}
        drf = {"a": 4} if tick % 3 else {}
        tick_kw = dict(wall_s=float(rng.random()),
                       prefill_work_rows=[float(x) for x in rng.integers(0, 50, 2)],
                       decode_work_rows=[float(x) for x in rng.integers(0, 4, 3)],
                       queue_depth=int(rng.integers(0, 9)), accepted=sum(acc.values()),
                       drafted=sum(drf.values()), accepted_by_tenant=acc,
                       drafted_by_tenant=drf)
        port.record_tick(**tick_kw)
        ref.record_tick(**tick_kw)
    assert port.snapshot() == ref.snapshot()
    assert port.load_samples() == ref.load_samples()
    for q in (50, 90, 99):
        for sel in ({}, {"tenant": "a"}, {"slo": "b"}, {"tenant": "b", "slo": "b"}):
            assert port.ttft_percentile(q, **sel) == ref.ttft_percentile(q, **sel)
            assert port.latency_percentile(q, **sel) == ref.latency_percentile(q, **sel)
    for ten in (None, "a", "b"):
        assert port.acceptance_rate(ten) == ref.acceptance_rate(ten)
    assert port.acceptance_rate("b") == FleetLedger.NO_SAMPLE
    assert FleetLedger().acceptance_rate() == FleetLedger.NO_SAMPLE
    assert registry.get_registry().snapshot() == j_registry.get_registry().snapshot()


# -- the reference's pure cases (tests/test_fleet.py) ---------------------------


@given(lens=st.lists(st.integers(1, 50), min_size=1, max_size=40),
       budget=st.integers(50, 200), inflight=st.integers(0, 100))
@settings(max_examples=40, deadline=None)
def test_admission_never_exceeds_token_budget(lens, budget, inflight):
    s = FleetScheduler(token_budget=budget)
    accepted = 0
    for i, n in enumerate(lens):
        accepted += s.submit(_req(i, n))
    got = s.take(0, inflight_tokens=inflight)
    assert sum(int(r.prompt.shape[0]) for r in got) <= max(budget - inflight, 0)
    assert accepted + s.rejected == len(lens)
    assert s.rejected == sum(n > budget for n in lens)


@given(lens=st.lists(st.integers(1, 30), min_size=1, max_size=30))
@settings(max_examples=30, deadline=None)
def test_work_conserving(lens):
    s = FleetScheduler(token_budget=100)
    for i, n in enumerate(lens):
        s.submit(_req(i, min(n, 100)))
    while s.pending():
        got = s.take(0, max_n=4, inflight_tokens=0)
        assert got, "scheduler idled with queued work and free budget"


def test_wfq_tracks_weights_under_backlog():
    tenants = (TenantSpec(name="a", weight=3.0), TenantSpec(name="b", weight=1.0))
    s = FleetScheduler(tenants)
    for i in range(60):
        s.submit(_req(i, 10, tenant="a"))
        s.submit(_req(1000 + i, 10, tenant="b"))
    taken = {"a": 0, "b": 0}
    for r in s.take(0, max_n=40):
        taken[r.tenant] += int(r.prompt.shape[0])
    assert taken["a"] == pytest.approx(3 * taken["b"], rel=0.34)


@given(heavy_rate=st.integers(2, 6), light_at=st.integers(0, 10))
@settings(max_examples=20, deadline=None)
def test_wfq_starvation_free(heavy_rate, light_at):
    tenants = (TenantSpec(name="heavy", weight=8.0), TenantSpec(name="light", weight=0.1))
    s = FleetScheduler(tenants, aging=0.0)
    uid = 0
    target = _req(99999, 20, tenant="light")
    popped_at = None
    for t in range(400):
        if t == light_at:
            s.submit(target, now=t)
        for _ in range(heavy_rate):
            s.submit(_req(uid, 10, tenant="heavy"), now=t)
            uid += 1
        for r in s.take(t, max_n=2):
            if r.uid == target.uid:
                popped_at = t
        if popped_at is not None:
            break
    assert popped_at is not None, "light tenant starved"


def test_deadline_pull_forward():
    tight = SLOClass(name="tight", ttft_deadline=3, weight=1.0)
    loose = SLOClass(name="loose", ttft_deadline=1000, weight=1.0)
    tenants = (TenantSpec(name="vip", weight=100.0, slo=loose),
               TenantSpec(name="slo", weight=0.01, slo=tight))
    s = FleetScheduler(tenants, urgent_slack=2)
    for i in range(5):
        s.submit(_req(i, 10, tenant="vip"), now=0)
    s.submit(_req(100, 10, tenant="slo"), now=0)
    got = s.take(2, max_n=1)  # slack = 0+3-2 = 1 <= urgent_slack
    assert got[0].uid == 100


def test_fifo_policy_matches_deque_order():
    s = FleetScheduler.fifo()
    ref = deque()
    rng = np.random.default_rng(0)
    for i in range(50):
        r = _req(i, int(rng.integers(1, 30)), tenant=["a", "b"][i % 2])
        s.submit(r, now=i)
        ref.append(r)
    while ref:
        k = int(rng.integers(1, 4))
        got = s.take(0, max_n=k)
        want = [ref.popleft() for _ in range(len(got))]
        assert [r.uid for r in got] == [r.uid for r in want]
    assert s.pending() == 0


def test_scheduler_rejects_an_unknown_policy():
    with pytest.raises(ValueError, match="policy"):
        FleetScheduler(policy="lifo")


def test_ledger_percentiles_and_goodput():
    led = FleetLedger()
    slo = SLOClass(name="s", ttft_deadline=5, latency_deadline=10)
    for i, (sub, first, done) in enumerate([(0, 2, 6), (0, 4, 9), (0, 9, 20)]):
        r = _req(i, 4, max_new=3)
        r.submitted_tick, r.first_token_tick = sub, first
        r.out_tokens = [1, 2, 3]
        led.record_done(r, slo, done)
    assert led.ttft_percentile(50) == 4.0
    assert led.latency_percentile(99) >= 19.0
    assert led.good_tokens() == 6
    snap = led.snapshot()
    assert snap["completions"] == 3 and snap["by_class"]["s"]["completions"] == 3


def test_ledger_load_samples_bridge():
    led = FleetLedger(window=4)
    for k in range(6):
        led.record_tick(wall_s=0.1 * (k + 1), prefill_work_rows=[k, 2 * k],
                        decode_work_rows=[1.0, 2.0], queue_depth=k)
    samples = led.load_samples()
    assert len(samples) == 4  # sliding window
    wall, work, items = samples[-1]
    assert wall == pytest.approx(0.6)
    assert work == [1.0, 2.0]
    assert items == {"prefill": 15.0}
