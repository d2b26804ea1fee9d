"""The port's model configurations and token stream against the JAX
reference's, on the CPU: ``get_config``/``reduced``/``all_configs`` field
by field for all ten architectures (aliases included), derived quantities
(``vocab_padded``, ``param_count``), and ``TokenStream.batch_at`` and the
``Prefetcher`` hand-off bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.data import tokens as jtok
from repro_torch import configs as tcfg
from repro_torch.data import tokens as ttok

from _torch_parity import assert_same


def _fields(cfg):
    """Every field, nested configs as dicts, and the derived quantities."""
    out = dataclasses.asdict(cfg)
    out["vocab_padded"] = cfg.vocab_padded
    out["hd"] = cfg.hd
    out["param_count"] = cfg.param_count()
    out["active_param_count"] = cfg.active_param_count()
    out["layer_kinds"] = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    out["moe_layers"] = [cfg.layer_has_moe(i) for i in range(cfg.n_layers)]
    out["global_attn"] = [cfg.layer_is_global_attn(i) for i in range(cfg.n_layers)]
    return out


def test_registry_names_match():
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS
    assert tcfg.ALIASES == jcfg.ALIASES
    assert sorted(tcfg.all_configs()) == sorted(jcfg.all_configs())


@pytest.mark.parametrize("arch", sorted(jcfg.ALIASES))
def test_config_and_reduced_match_field_by_field(arch):
    """Looked up by the external alias and by the module id."""
    want = jcfg.get_config(arch)
    for name in (arch, jcfg.ALIASES[arch]):
        got = tcfg.get_config(name)
        assert _fields(got) == _fields(want), name
    assert _fields(tcfg.reduced(got)) == _fields(jcfg.reduced(want))


def test_granite_embedding_shape():
    """The configuration the embedding-gradient path runs at full width."""
    cfg = tcfg.get_config("granite-3-8b")
    assert (cfg.vocab, cfg.vocab_padded, cfg.d_model, cfg.dtype) == (49155, 49664, 4096, "bfloat16")
    assert not cfg.tied_embeddings and cfg.family == "dense"


@pytest.mark.parametrize("frontend", [None, (3, 4)])
def test_token_stream_bit_exact(frontend):
    """Batches at arbitrary steps, the cursor, seek and the frontend stub."""
    kw = dict(vocab=1000, batch=2, seq=64, seed=5, zipf=1.3, frontend_shape=frontend)
    js, ts = jtok.TokenStream(**kw), ttok.TokenStream(**kw)
    for step in (0, 1, 17, 4096):
        want, got = js.batch_at(step), ts.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k], (step, k))
    ts.seek(3)
    js.seek(3)
    for _ in range(2):
        a, b = next(ts), next(js)
        assert_same(a["tokens"], b["tokens"])
    assert ts.cursor() == js.cursor() == 5


def test_prefetcher_hands_over_tensors():
    """The background thread hands over the stream's batches, in order, as
    tensors on the device asked for; the stream's end ends the iteration."""

    class Short(ttok.TokenStream):
        def __next__(self):
            if self.step >= 3:
                raise StopIteration
            return super().__next__()

    stream = Short(vocab=100, batch=2, seq=8, seed=1)
    ref = jtok.TokenStream(vocab=100, batch=2, seq=8, seed=1)
    pf = ttok.Prefetcher(stream, depth=2, device="cpu")
    try:
        got = list(iter(lambda: next(pf, None), None))
    finally:
        pf.close()
    assert len(got) == 3
    for s, b in enumerate(got):
        assert isinstance(b["tokens"], torch.Tensor) and b["tokens"].device.type == "cpu"
        assert_same(b["tokens"], ref.batch_at(s)["tokens"])
        assert_same(b["labels"], ref.batch_at(s)["labels"])


def test_prefetcher_keeps_every_batch_for_a_slow_consumer():
    """A consumer that lags at the stream's end still gets every batch: the
    end-of-stream marker waits for room instead of evicting one."""
    import time

    class Short(ttok.TokenStream):
        def __next__(self):
            if self.step >= 3:
                raise StopIteration
            return super().__next__()

    pf = ttok.Prefetcher(Short(vocab=100, batch=2, seq=8, seed=1), depth=2, device="cpu")
    try:
        got = [next(pf)]
        time.sleep(0.3)  # the producer reaches the stream's end with the queue full
        got += list(iter(lambda: next(pf, None), None))
    finally:
        pf.close()
    ref = jtok.TokenStream(vocab=100, batch=2, seq=8, seed=1)
    assert len(got) == 3
    for s, b in enumerate(got):
        assert_same(b["tokens"], ref.batch_at(s)["tokens"])


def test_prefetcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttok.Prefetcher(ttok.TokenStream(vocab=10, batch=1, seq=4))
