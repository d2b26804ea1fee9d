"""The D4M names the port copies from the reference: ``data.dictionary``
(the IPv4 fast path and the string dictionary), ``Semiring.add_identity``
(int32 saturating as ``zero_as``), ``rmat.stream_tensor`` (its shapes and
types; the bits are the port's own generator's) and the deprecated alias
``configs.d4m_stream.StreamConfig`` with the reference's warning."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import d4m_stream as JCFG
from repro.core import semiring as JSR
from repro.data import dictionary as JDICT
from repro.data import rmat as JRMAT
from repro_torch.configs import d4m_stream as TCFG
from repro_torch.core import semiring as TSR
from repro_torch.data import dictionary as TDICT
from repro_torch.data import rmat as TRMAT

ADDRS = ["1.1.1.1", "10.0.0.7", "8.8.8.8", "255.255.255.255", "0.0.0.0", "192.168.1.254", "128.0.0.1"]


def test_dictionary_matches_the_reference():
    got, want = TDICT.encode_ipv4(ADDRS), JDICT.encode_ipv4(ADDRS)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert TDICT.decode_ipv4(got) == JDICT.decode_ipv4(want) == ADDRS
    keys = ["a", "b", "a", "c", "b", "zz"]
    t, j = TDICT.StringDictionary(), JDICT.StringDictionary()
    np.testing.assert_array_equal(t.encode(keys), j.encode(keys))
    np.testing.assert_array_equal(t.encode(["zz", "new"]), j.encode(["zz", "new"]))
    assert len(t) == len(j) == 5
    assert t.decode([4, 0, 3]) == j.decode([4, 0, 3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int32"])
def test_add_identity_matches_the_reference(dtype):
    """An infinite or NaN zero in int32: the reference's ``jnp.asarray``
    raises ``OverflowError`` (or gives 0 for NaN), the port saturates as
    ``zero_as`` does (ROADMAP C15, C31)."""
    for name, sr in TSR.REGISTRY.items():
        got = sr.add_identity(getattr(torch, dtype))
        if dtype == "int32" and not np.isfinite(sr.zero):
            assert got.dtype == torch.int32 and int(got) == sr.zero_as(torch.int32), name
            continue
        want = np.asarray(JSR.REGISTRY[name].add_identity(getattr(jnp, dtype)).astype(jnp.float32))
        assert got.shape == () and got.dtype == getattr(torch, dtype), name
        np.testing.assert_array_equal(got.float().numpy(), want, err_msg=name)


def test_stream_tensor_shapes():
    want = JRMAT.stream_tensor(0, 3, 64, 10)
    gen = torch.Generator().manual_seed(0)
    got = TRMAT.stream_tensor(gen, 3, 64, 10)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and str(g.dtype).split(".")[1] == str(w.dtype)
    assert (got[2] == 1).all() and int(got[0].max()) < 2**10 and int(got[1].min()) >= 0
    again = TRMAT.stream_tensor(0, 3, 64, 10, device="cpu")
    torch.testing.assert_close(again[0], TRMAT.stream_tensor(0, 3, 64, 10, device="cpu")[0], rtol=0, atol=0)


def test_stream_config_alias_warns_as_the_reference():
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter("always")
        assert JCFG.StreamConfig is JCFG.WorkloadConfig
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        assert TCFG.StreamConfig is TCFG.WorkloadConfig
    assert [w.category for w in got] == [w.category for w in want] == [DeprecationWarning]
    assert str(got[0].message) == str(want[0].message)
    with pytest.raises(AttributeError):
        TCFG.NoSuchName  # noqa: B018
