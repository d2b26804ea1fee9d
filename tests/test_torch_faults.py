"""``repro_torch.faults`` against ``repro.faults``: the same seeded plan
fires at the same consults and cursors in both packages, and a plan's wire
forms (its dict and the ``REPRO_FAULTS`` environment variable) cross
between them unchanged.  Everything compared is exact."""
import pytest

from repro import faults as jf
from repro_torch import faults as tf

SITE = "router.slow_consumer"


def _pattern(mod, trigger, cursors=None):
    """Which of 64 consults fire, for a plan built in ``mod``."""
    plan = mod.FaultPlan().add(SITE, trigger(mod))
    if cursors is None:
        return [plan.fire(SITE) is not None for _ in range(64)]
    return [plan.fire(SITE, cursor=c) is not None for c in cursors]


TRIGGERS = {
    "nth3": lambda m: m.Trigger.nth(3),
    "always": lambda m: m.Trigger.always(),
    "prob0": lambda m: m.Trigger.prob(0.3, seed=0),
    "prob7": lambda m: m.Trigger.prob(0.3, seed=7),
    "prob42": lambda m: m.Trigger.prob(0.5, seed=42),
}


@pytest.mark.parametrize("name", sorted(TRIGGERS))
def test_same_plan_fires_at_the_same_consults(name):
    want = _pattern(jf, TRIGGERS[name])
    assert _pattern(tf, TRIGGERS[name]) == want
    assert any(want)


def test_once_at_fires_at_the_same_cursor():
    cursors = [0, 40, 99, 100, 150, 999, 2000]
    trig = lambda m: m.Trigger.once_at(100)  # noqa: E731
    assert _pattern(tf, trig, cursors) == _pattern(jf, trig, cursors) == [
        False, False, False, True, False, False, False
    ]


def test_sites_and_env_names_are_the_reference_ones():
    assert tf.SITES == jf.SITES
    assert (tf.ENV_VAR, tf.WORKER_ENV_VAR, tf.GENERATION_ENV_VAR) == (
        jf.ENV_VAR, jf.WORKER_ENV_VAR, jf.GENERATION_ENV_VAR
    )


@pytest.mark.parametrize("src,dst", [(jf, tf), (tf, jf)])
def test_env_plan_fires_the_same_way_in_the_other_package(src, dst):
    """A plan set for one package (its env wire form, worker and
    generation binding included) fires at the same consults in the other."""
    plan = (
        src.FaultPlan()
        .add(SITE, src.Trigger.prob(0.25, seed=13), only_worker=3, only_generation=1)
        .add("checkpoint.torn_write", src.Trigger.nth(2), args={"keep_bytes": 7})
    )
    env = {src.ENV_VAR: plan.to_env(), src.WORKER_ENV_VAR: "3", src.GENERATION_ENV_VAR: "1"}
    a, b = src.FaultPlan.from_env(env), dst.FaultPlan.from_env(env)
    assert a.to_dict() == b.to_dict()
    for site in (SITE, "checkpoint.torn_write"):
        fa = [a.fire(site, cursor=i) for i in range(32)]
        fb = [b.fire(site, cursor=i) for i in range(32)]
        assert [x is None for x in fa] == [x is None for x in fb]
        assert [x.args for x in fa if x] == [x.args for x in fb if x]
    assert a.summary() == b.summary()


def test_retry_schedule_is_the_reference_one():
    kw = dict(max_attempts=6, base_delay_s=0.01, max_delay_s=0.1, jitter=0.2, seed=5)
    assert tf.RetryPolicy(**kw).delays() == jf.RetryPolicy(**kw).delays()


def test_serve_config_carries_plan_across_packages():
    from repro import d4m as jd4m
    from repro_torch import d4m as td4m

    plan = tf.FaultPlan().add(SITE, tf.Trigger.nth(2), only_worker=1)
    cfg = td4m.ServeConfig(faults=plan, max_batch=8)
    back = jd4m.ServeConfig.from_dict(cfg.to_dict())
    assert isinstance(back.faults, jf.FaultPlan)
    assert back.faults.to_dict() == plan.to_dict()
    again = td4m.ServeConfig.from_dict(back.to_dict())
    assert isinstance(again.faults, tf.FaultPlan) and again.to_dict() == cfg.to_dict()
