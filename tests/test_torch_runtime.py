"""``repro_torch.runtime`` against ``repro.runtime``, on the CPU: the mesh
plan, the heartbeat, the elastic controller and the straggler monitor give
the reference's answers on the inputs of ``tests/test_runtime.py``."""
import dataclasses

import pytest

from repro.runtime import elastic as jelastic
from repro.runtime import straggler as jstraggler
from repro_torch.runtime import elastic, straggler


@pytest.mark.parametrize("n,model,min_data", [
    (256, 16, 1), (240, 16, 1), (8, 16, 1), (16, 16, 2), (7, 1, 1), (0, 1, 1), (64, 4, 16),
])
def test_plan_mesh_equals_reference(n, model, min_data):
    def plan(mod):
        try:
            return mod.plan_mesh(n, mod.ElasticConfig(model_axis=model, min_data_axis=min_data))
        except RuntimeError as e:
            return f"raised: {e}"

    assert plan(elastic) == plan(jelastic)
    assert elastic.plan_mesh(256) == jelastic.plan_mesh(256) == (16, 16)


def _loss_scenario(mod):
    """``tests/test_runtime.py``'s heartbeat scenario: four workers ping,
    worker 3 goes silent, the controller plans the survivors' mesh."""
    hb = mod.Heartbeat(workers=[0, 1, 2, 3], timeout_s=10.0)
    ctl = mod.ElasticController(hb, mod.ElasticConfig(model_axis=1))
    now = 1000.0
    for w in range(4):
        hb.ping(w, now=now)
    devices = {w: [f"d{w}"] for w in range(4)}
    out = [ctl.check(step=1, devices_by_worker=devices, now=now + 1)]
    for w in (0, 1, 2):
        hb.ping(w, now=now + 20)
    out.append(hb.dead(now=now + 20))
    surviving, ev = ctl.check(step=2, devices_by_worker=devices, now=now + 20)
    out += [surviving, dataclasses.asdict(ev), sorted(hb.last)]
    out.append(ctl.check(step=3, devices_by_worker=devices, now=now + 21))
    hb.remove(7)  # unknown worker: no-op
    out.append([dataclasses.asdict(e) for e in ctl.events])
    return out


def test_heartbeat_and_controller_equal_reference():
    got = _loss_scenario(elastic)
    assert got == _loss_scenario(jelastic)
    assert got[1] == [3] and got[2] == ["d0", "d1", "d2"]
    assert got[3]["new_mesh_shape"] == (3, 1)


def test_heartbeat_uses_the_clock_when_no_time_is_given():
    hb = elastic.Heartbeat([0, 1], timeout_s=0.0)
    hb.ping(0)
    assert set(hb.dead(now=hb.last[0] + 1.0)) == {0, 1}
    assert hb.dead(now=min(hb.last.values())) == []


_STEPS = [
    # (evict_after, per-step worker times): test_runtime.py's two scenarios
    # and a longer mixed one
    (2, [{0: 100.0, 1: 105.0, 2: 98.0, 3: 102.0},
         {0: 100.0, 1: 105.0, 2: 500.0, 3: 102.0},
         {0: 100.0, 1: 105.0, 2: 500.0, 3: 102.0}]),
    (2, [{0: 100.0, 1: 100.0}, {0: 100.0, 1: 900.0}, {0: 100.0, 1: 101.0},
         {0: 100.0, 1: 900.0}]),
    (3, [{0: 10.0 + i, 1: 30.0 * (i % 3), 2: 12.0} for i in range(12)]),
]


@pytest.mark.parametrize("evict_after,steps", _STEPS)
def test_straggler_monitor_equals_reference(evict_after, steps):
    mons = [mod.StragglerMonitor(len(steps[0]), mod.StragglerConfig(evict_after=evict_after))
            for mod in (straggler, jstraggler)]
    for times in steps:
        got, want = (m.observe_step(dict(times)) for m in mons)
        assert got == want
        assert mons[0].flagged == mons[1].flagged
        assert mons[0].violations == mons[1].violations
        assert mons[0].ewma_ms == mons[1].ewma_ms


def test_straggler_detection_and_eviction():
    mon = straggler.StragglerMonitor(4, straggler.StragglerConfig(evict_after=2))
    base = {0: 100.0, 1: 105.0, 2: 98.0, 3: 102.0}
    assert mon.observe_step(base) == []
    slow = {**base, 2: 500.0}
    assert mon.observe_step(slow) == []  # first violation: flagged only
    assert 2 in mon.flagged
    assert mon.observe_step(slow) == [2]  # second consecutive -> evict


def test_step_timer_measures_a_step():
    t = straggler.StepTimer()
    assert t.last_ms is None
    with t:
        pass
    assert t.last_ms is not None and t.last_ms >= 0.0
