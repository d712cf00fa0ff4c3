"""PyTorch port, the fault schedule and the failure monitor
(`repro_torch.serve.faults`, a copy of the reference's): the reference's
pure cases of `tests/test_faults.py` against the port, then seeded
schedules and monitors of both packages side by side (the same events
drawn, the same health polled tick by tick). The fleet that consumes the
monitor, with its recovery paths, is held against the reference's in
tests/test_torch_fleet.py.
"""
import dataclasses

import numpy as np
import pytest

from repro.serve import faults as jf
from repro_torch.serve.faults import (
    FailureMonitor,
    FaultEvent,
    FaultSchedule,
    events_from_hooks,
    validate_events,
)


def test_fault_event_validation():
    with pytest.raises(ValueError):
        FaultEvent(0, "meteor")
    with pytest.raises(ValueError):
        FaultEvent(-1, "device_loss")
    with pytest.raises(ValueError):
        FaultEvent(0, "device_loss", rows=0)
    with pytest.raises(ValueError):
        FaultEvent(0, "preempt", duration=-1)
    with pytest.raises(ValueError):
        FaultEvent(0, "slow_node", factor=0.5)
    FaultEvent(0, "slow_node", rows=0)  # rows unused for slow_node


def test_fault_schedule_generate_deterministic_and_sorted():
    a = FaultSchedule.generate(64, seed=7, p_loss=0.2, p_preempt=0.2, p_slow=0.1, max_rows=3)
    b = FaultSchedule.generate(64, seed=7, p_loss=0.2, p_preempt=0.2, p_slow=0.1, max_rows=3)
    assert a.events == b.events
    assert a.events, "seed 7 should draw at least one fault"
    ticks = [e.tick for e in a.events]
    assert ticks == sorted(ticks)
    c = FaultSchedule.generate(64, seed=8, p_loss=0.2, p_preempt=0.2, p_slow=0.1, max_rows=3)
    assert a.events != c.events
    t = a.events[0].tick
    assert all(e.tick == t for e in a.at(t))
    ev = (FaultEvent(5, "device_loss"), FaultEvent(1, "preempt", duration=2))
    assert [e.tick for e in FaultSchedule(ev).events] == [1, 5]


def test_events_from_hooks_clamp_into_horizon():
    evs = events_from_hooks(10, fail_at=99, preempt_at=-3, fault_rows=2, preempt_duration=4)
    kinds = {e.kind: e for e in evs}
    assert kinds["device_loss"].tick == 10 and kinds["device_loss"].rows == 2
    assert kinds["preempt"].tick == 0 and kinds["preempt"].duration == 4
    assert events_from_hooks(10) == ()
    with pytest.raises(TypeError):
        validate_events(("not-an-event",))


def test_monitor_clamps_loss_at_min_rows():
    m = FailureMonitor(FaultSchedule((FaultEvent(0, "device_loss", rows=5),
                                      FaultEvent(1, "device_loss", rows=1))),
                       n_rows=4, min_rows=2)
    h0 = m.poll(0)
    assert [e.rows for e in h0.events] == [2]  # clamped from 5
    assert m.healthy_rows == 2
    h1 = m.poll(1)
    assert h1.events == ()  # unrealizable: the floor holds the fleet up
    assert m.healthy_rows == 2
    with pytest.raises(ValueError):
        FailureMonitor(None, n_rows=1, min_rows=2)


def test_monitor_preempt_schedules_return():
    m = FailureMonitor(FaultSchedule((FaultEvent(0, "preempt", rows=1, duration=3),)),
                       n_rows=4, min_rows=2)
    assert m.poll(0).events[0].kind == "preempt"
    assert m.healthy_rows == 3
    assert m.poll(2).returned_rows == 0
    h = m.poll(3)
    assert h.returned_rows == 1
    assert m.healthy_rows == 4
    assert m.poll(9).returned_rows == 0  # a re-grow never exceeds the fleet


def test_monitor_nets_same_tick_return_and_loss():
    m = FailureMonitor(FaultSchedule((FaultEvent(0, "preempt", rows=1, duration=2),
                                      FaultEvent(2, "device_loss", rows=1))),
                       n_rows=4, min_rows=2)
    m.poll(0)
    assert m.healthy_rows == 3
    h = m.poll(2)  # the returning row absorbs the same-tick loss
    assert h.returned_rows == 1 and [e.rows for e in h.events] == [1]
    assert m.healthy_rows == 3


def test_monitor_slow_windows_multiply():
    m = FailureMonitor(FaultSchedule((FaultEvent(1, "slow_node", duration=3, factor=2.0),
                                      FaultEvent(2, "slow_node", duration=1, factor=3.0))),
                       n_rows=4, min_rows=2)
    m.poll(1)
    assert m.slow_factor(1) == 2.0
    m.poll(2)
    assert m.slow_factor(2) == 6.0  # overlapping stragglers compound
    assert m.slow_factor(3) == 2.0
    assert m.slow_factor(4) == 1.0
    assert m.healthy_rows == 4  # slow nodes never shrink the fleet


def test_monitor_prober_reports_devices():
    m = FailureMonitor(FaultSchedule((FaultEvent(0, "device_loss", rows=1),)),
                       n_rows=4, min_rows=2)
    probe = m.prober(devices_per_row=2)
    assert probe() == 8
    m.poll(0)
    assert probe() == 6


# -- both packages side by side -------------------------------------------------

GEN_CASES = [
    dict(seed=0, p_loss=0.1),
    dict(seed=7, p_loss=0.2, p_preempt=0.2, p_slow=0.1, max_rows=3),
    dict(seed=11, p_preempt=0.3, preempt_duration=3, max_rows=2),
    dict(seed=5, p_slow=0.4, slow_duration=2, slow_factor=2.5),
]


def _astuples(events):
    return [dataclasses.astuple(e) for e in events]


@pytest.mark.parametrize("kw", GEN_CASES)
def test_generate_matches_reference(kw):
    got = FaultSchedule.generate(96, **kw)
    want = jf.FaultSchedule.generate(96, **kw)
    assert got.events and _astuples(got.events) == _astuples(want.events)


@pytest.mark.parametrize("kw", GEN_CASES)
def test_monitor_polls_match_reference(kw):
    """Both monitors over the same drawn schedule, with one mid-run
    injection: the same health every tick and the same fired events."""
    port = FailureMonitor(FaultSchedule.generate(96, **kw), n_rows=8, min_rows=2)
    ref = jf.FailureMonitor(jf.FaultSchedule.generate(96, **kw), n_rows=8, min_rows=2)
    port.inject(FaultEvent(40, "preempt", rows=2, duration=5))
    ref.inject(jf.FaultEvent(40, "preempt", rows=2, duration=5))
    for tick in range(0, 110, 1 + kw["seed"] % 3):
        h, jh = port.poll(tick), ref.poll(tick)
        assert (h.tick, _astuples(h.events), h.returned_rows, h.slow_factor) == \
               (jh.tick, _astuples(jh.events), jh.returned_rows, jh.slow_factor)
        assert port.healthy_rows == ref.healthy_rows
        assert port.prober(2)() == ref.prober(2)()
    assert _astuples(port.fired) == _astuples(ref.fired)


def test_hooks_match_reference():
    for kw in (dict(fail_at=3), dict(preempt_at=50, fault_rows=2, preempt_duration=6),
               dict(fail_at=-1, preempt_at=0)):
        assert _astuples(events_from_hooks(24, **kw)) == \
               _astuples(jf.events_from_hooks(24, **kw))
