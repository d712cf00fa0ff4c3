"""PyTorch port, traffic scenarios (`repro_torch.serve.traffic`): every
named scenario generates the reference's events and materializes its
prompts bit for bit (the same seeded draws through the copied
`ImbalanceModel`, lognormal and pareto branches alike); a trace recorded
by one package replays in the other; `replay` refuses fault hooks on the
colocated engine, as the reference's does; then the reference's pure
traffic cases of `tests/test_fleet.py` against the port.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.imbalance import ImbalanceModel as JImbalanceModel
from repro.serve import traffic as jt
from repro_torch.core.imbalance import ImbalanceModel
from repro_torch.serve import traffic as tt
from repro_torch.serve.engine import Request
from repro_torch.serve.faults import FaultEvent


@pytest.mark.parametrize("name", sorted(tt.SCENARIOS))
def test_scenarios_match_reference(name):
    port, ref = tt.scenario(name), jt.scenario(name)
    events = port.generate()
    assert [dataclasses.astuple(e) for e in events] == \
           [dataclasses.astuple(e) for e in ref.generate()]
    assert port.horizon == ref.horizon and port.seed == ref.seed
    for vocab in (512, 151_936):
        pairs, j_pairs = port.requests(vocab), ref.requests(vocab)
        assert len(pairs) == len(j_pairs) == len(events)
        for (e, r), (je, jr) in zip(pairs, j_pairs):
            assert isinstance(r, Request)
            assert dataclasses.astuple(e) == dataclasses.astuple(je)
            assert r.prompt.dtype == jr.prompt.dtype == np.int32
            np.testing.assert_array_equal(r.prompt, jr.prompt)
            assert (r.uid, r.tenant, r.max_new_tokens) == (jr.uid, jr.tenant, jr.max_new_tokens)


def test_bursty_prefix_carries_its_system_prompts():
    """The scenario the chip smoke replays: 145 requests, 12,429 prompt
    tokens, the longest 120; chat and rag requests start with their
    tenant's shared prefix."""
    sc = tt.scenario("bursty-prefix")
    pairs = sc.requests(151_936)
    assert len(pairs) == 145
    assert sum(int(r.prompt.shape[0]) for _, r in pairs) == 12_429
    assert max(int(r.prompt.shape[0]) for _, r in pairs) == 120
    for ten, n in (("chat", 24), ("rag", 48)):
        heads = {r.prompt[: min(n, r.prompt.shape[0])].tobytes()
                 for _, r in pairs if r.tenant == ten and r.prompt.shape[0] >= n}
        assert len(heads) == 1, ten


@pytest.mark.parametrize("direction", ["port->ref", "ref->port"])
def test_trace_saved_by_one_package_loads_in_the_other(tmp_path, direction):
    save, load = (tt, jt) if direction == "port->ref" else (jt, tt)
    sc = save.scenario("bursty-multitenant")
    events = sc.generate()
    path = str(tmp_path / "trace.json")
    save.save_trace(path, sc.name, events)
    name, loaded = load.load_trace(path)
    assert name == sc.name
    assert [dataclasses.astuple(e) for e in loaded] == \
           [dataclasses.astuple(e) for e in events]
    prompts = [r.prompt for _, r in load.scenario(name).requests(97, loaded)]
    for p, (_, r) in zip(prompts, sc.requests(97, events)):
        np.testing.assert_array_equal(p, r.prompt)


class _Colocated:
    """The colocated engine's surface as `replay` sees it: no
    ``inject_fault``. It must never be stepped."""

    def submit(self, req):
        raise AssertionError("replay submitted to an engine it should refuse")

    step = submit

    def idle(self):
        return True


@pytest.mark.parametrize("hook", [dict(fail_at=3), dict(preempt_at=2, preempt_duration=4)])
def test_replay_refuses_fault_hooks_on_the_colocated_engine(hook):
    sc = tt.scenario("single-fifo")
    with pytest.raises(ValueError, match="inject_fault"):
        tt.replay(_Colocated(), sc, 97, **hook)


def test_replay_refuses_declared_faults_on_the_colocated_engine():
    sc = dataclasses.replace(tt.scenario("single-fifo"),
                             faults=(FaultEvent(4, "device_loss"),))
    with pytest.raises(ValueError, match="inject_fault"):
        tt.replay(_Colocated(), sc, 97)
    with pytest.raises(TypeError):
        dataclasses.replace(tt.scenario("single-fifo"), faults=("not-an-event",))


def test_replay_submits_on_arrival_ticks_and_drains():
    """The replay loop: every event's request submitted at its tick before
    that tick's step, and stepping on past the horizon until idle."""

    class Recorder:
        def __init__(self):
            self.t, self.queue, self.log = 0, [], []

        def submit(self, req):
            self.log.append((self.t, req.uid))
            self.queue.append(req)

        def step(self):
            self.t += 1
            if self.queue:
                self.queue.pop(0)

        def idle(self):
            return not self.queue

    sc = tt.scenario("single-fifo")
    eng = Recorder()
    ticks = []
    pairs = tt.replay(eng, sc, 97, on_tick=lambda e: ticks.append(e.t))
    assert [(e.tick, r.uid) for e, r in pairs] == eng.log
    assert ticks == list(range(1, len(ticks) + 1)) and len(ticks) >= sc.horizon + 1
    assert eng.idle()


# -- the reference's pure traffic cases (tests/test_fleet.py) -------------------


def test_scenario_deterministic_and_replayable(tmp_path):
    sc = tt.scenario("bursty-multitenant")
    a, b = sc.generate(), sc.generate()
    assert a == b
    path = str(tmp_path / "trace.json")
    tt.save_trace(path, sc.name, a)
    name, c = tt.load_trace(path)
    assert name == sc.name and c == a
    ra = sc.requests(vocab_size=97, events=a[:8])
    rb = sc.requests(vocab_size=97, events=a[:8])
    for (_, x), (_, y) in zip(ra, rb):
        np.testing.assert_array_equal(x.prompt, y.prompt)
        assert x.tenant == y.tenant and x.max_new_tokens == y.max_new_tokens


def test_scenario_surge_shifts_the_mix():
    sc = tt.scenario("bursty-multitenant")
    events = sc.generate()
    rag = sc.tenant("rag")
    pre = sum(e.tenant == "rag" for e in events if e.tick < rag.surge_at)
    post = sum(e.tenant == "rag" for e in events if e.tick >= rag.surge_at)
    assert post / (sc.horizon - rag.surge_at) > 2.0 * pre / rag.surge_at
    with pytest.raises(KeyError):
        sc.tenant("nobody")
    with pytest.raises(KeyError, match="unknown scenario"):
        tt.scenario("nobody")


def test_length_skew_uses_imbalance_branches():
    rng = np.random.default_rng(0)
    heavy = ImbalanceModel(kind="pareto", mean=32.0, sigma=0.8, pareto_shape=2.5)
    light = ImbalanceModel(kind="lognormal", mean=32.0, sigma=0.2)
    h = heavy.sample_lengths(4000, rng, minimum=2)
    li = light.sample_lengths(4000, rng, minimum=2)
    assert h.min() >= 2 and li.min() >= 2
    assert h.std() > 2.0 * li.std()
    capped = heavy.sample_lengths(1000, rng, minimum=2, cap=64)
    assert capped.max() <= 64


@pytest.mark.parametrize("kind", ["lognormal", "pareto", "gaussian"])
def test_sample_lengths_draw_for_draw(kind):
    kw = dict(kind=kind, mean=40.0, sigma=0.7, pareto_shape=2.5)
    got = ImbalanceModel(**kw).sample_lengths(500, np.random.default_rng(3), minimum=2, cap=120)
    want = JImbalanceModel(**kw).sample_lengths(500, np.random.default_rng(3), minimum=2,
                                                cap=120)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal"])
def test_arrival_rates_match_reference(kind):
    port = tt.ArrivalProcess(kind=kind, period=16).rates(0.7, 50, np.random.default_rng(5))
    ref = jt.ArrivalProcess(kind=kind, period=16).rates(0.7, 50, np.random.default_rng(5))
    np.testing.assert_array_equal(port, ref)
    with pytest.raises(ValueError):
        tt.ArrivalProcess(kind="weekly").rates(0.7, 4, np.random.default_rng(0))
