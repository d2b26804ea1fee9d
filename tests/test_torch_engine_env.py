"""The ``REPRO_D4M_ENGINE`` override and ``D4MStream.raw_update``, held to
the reference: the cases of ``tests/kernels/test_hier_cascade.py``'s
``test_auto_engine_env_override``, each resolved by both packages under the
same environment value (the reference's ``pallas`` is the port's ``cuda``)."""
import numpy as np
import pytest

from repro import d4m as jd4m
from repro.d4m.config import ENGINE_ENV_VAR as JAX_ENV_VAR
from repro_torch import d4m as td4m
from repro_torch.d4m.config import ENGINE_ALIASES, ENGINE_ENV_VAR, WIRE_ENGINES

from _torch_parity import assert_hier_same, to_torch


def _resolve(cfg, *args):
    """The engine, or the name of the error that resolution raised."""
    try:
        return cfg.resolved_engine(*args)
    except ValueError:
        return "ValueError"
    except NotImplementedError:
        return "mesh"  # the port does not run the mesh engine yet


@pytest.mark.parametrize("value", [None, "pallas", "cuda", "packed", "single", "auto", "mesh",
                                   "bogus", " packed "])
@pytest.mark.parametrize("k", [1, 4])
def test_env_override_resolves_as_the_reference(monkeypatch, value, k):
    assert ENGINE_ENV_VAR == JAX_ENV_VAR == "REPRO_D4M_ENGINE"
    kw = dict(cuts=(8,), top_capacity=64, batch_size=8, instances_per_device=k)
    if value is None:
        monkeypatch.delenv(ENGINE_ENV_VAR, raising=False)
        ref = _resolve(jd4m.StreamConfig(**kw))
    else:
        # the reference reads its own spelling of the port's engine names
        monkeypatch.setenv(ENGINE_ENV_VAR, WIRE_ENGINES.get(value.strip(), value))
        ref = _resolve(jd4m.StreamConfig(**kw))
        monkeypatch.setenv(ENGINE_ENV_VAR, value)
    assert _resolve(td4m.StreamConfig(**kw), "cpu") == ENGINE_ALIASES.get(ref, ref)


def test_env_override_cases_of_the_reference(monkeypatch):
    """The reference test's sequence, on the port, on both devices."""
    cfg = td4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8, instances_per_device=4)
    monkeypatch.delenv(ENGINE_ENV_VAR, raising=False)
    assert cfg.resolved_engine("cpu") == "packed" and cfg.resolved_engine("cuda") == "cuda"
    monkeypatch.setenv(ENGINE_ENV_VAR, "pallas")
    assert cfg.resolved_engine("cpu") == "cuda"
    monkeypatch.setenv(ENGINE_ENV_VAR, "packed")
    assert cfg.resolved_engine("cuda") == "packed"
    # a structurally unfit override is ignored, not an error
    monkeypatch.setenv(ENGINE_ENV_VAR, "single")
    assert cfg.resolved_engine("cpu") == "packed" and cfg.resolved_engine("cuda") == "cuda"
    monkeypatch.setenv(ENGINE_ENV_VAR, "bogus")
    with pytest.raises(ValueError, match="REPRO_D4M_ENGINE"):
        cfg.resolved_engine("cpu")
    # an explicit engine always beats the variable
    monkeypatch.setenv(ENGINE_ENV_VAR, "pallas")
    explicit = td4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8,
                                 instances_per_device=4, engine="packed")
    assert explicit.resolved_engine("cpu") == "packed"
    # a resolved mesh still raises until the mesh is ported
    monkeypatch.setenv(ENGINE_ENV_VAR, "mesh")
    with pytest.raises(NotImplementedError, match="mesh"):
        cfg.resolved_engine("cpu")


def test_session_takes_the_override(monkeypatch):
    monkeypatch.setenv(ENGINE_ENV_VAR, "pallas")
    cfg = td4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8, instances_per_device=4)
    assert td4m.D4MStream(cfg, device="cpu").kind == "cuda"
    monkeypatch.setenv(ENGINE_ENV_VAR, "single")
    one = td4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8)
    assert td4m.D4MStream(one, device="cpu").kind == "single"


def test_raw_update_is_the_reference_step(monkeypatch):
    """``raw_update`` is the session's ``(h, rows, cols, vals) -> h`` step: a
    few packed steps through it equal the reference's ``raw_update`` and the
    port's own ``update``."""
    monkeypatch.delenv(ENGINE_ENV_VAR, raising=False)
    kw = dict(cuts=(16, 64), top_capacity=256, batch_size=16, instances_per_device=2)
    ref = jd4m.D4MStream(jd4m.StreamConfig(**kw))
    port = td4m.D4MStream(td4m.StreamConfig(**kw), device="cpu")
    twin = td4m.D4MStream(td4m.StreamConfig(**kw), device="cpu")
    assert ref.kind == port.kind == "packed"
    assert not hasattr(port.raw_update, "lower")  # eager: nothing to lower
    rng = np.random.default_rng(3)
    h_ref, h_port = ref.state, port.state
    for _ in range(6):
        r, c = (rng.integers(0, 24, (2, 16)).astype(np.int32) for _ in range(2))
        v = rng.integers(1, 4, (2, 16)).astype(np.float32)
        h_ref = ref.raw_update(h_ref, r, c, v)
        h_port = port.raw_update(h_port, to_torch(r), to_torch(c), to_torch(v))
        twin.update(r, c, v)
    assert_hier_same(h_port, h_ref, "raw_update vs the reference")
    assert_hier_same(h_port, twin.state, "raw_update vs update")
