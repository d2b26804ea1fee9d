"""The port's ``train_loss`` and its gradient against the JAX reference's
``jax.value_and_grad(train_loss)`` for the dense decoder architectures at
their reduced configs (float32: the loss within 1e-5, every gradient leaf
within 1e-4 of its max |value| and finite), ``remat=`` rematerialising
each layer without changing a bit, and one bfloat16 case.  Each
architecture's reference is computed once (``_torch_train.reference``)."""
import functools

import numpy as np
import pytest

import _torch_train as T
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TTF

ARCHS = ["h2o_danube3_4b", "gemma3_27b", "qwen2_0_5b", "granite_3_8b", "mamba2_1_3b"]


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return T.reference(request.param)


def test_train_loss_and_gradients_match_reference(ref):
    T.assert_matches(ref)


def test_remat_recomputes_each_layer_and_changes_nothing(ref, monkeypatch):
    """``remat=True`` (the default) runs each decoder layer under
    ``remat_call``; ``remat=False`` runs none there.  The gradients are the
    same bit for bit."""
    calls = []
    real = TL.remat_call

    def counted(fn, *args):
        calls.append(fn)
        return real(fn, *args)

    monkeypatch.setattr(TL, "remat_call", counted)
    _, _, on = T.port(ref)
    n_on = len(calls)
    calls.clear()
    monkeypatch.setattr(TTF, "forward", functools.partial(TTF.forward, remat=False))
    _, _, off = T.port(ref)
    # one call a layer, and one a loss chunk either way (the loss always
    # rematerialises its chunks, as the reference's scan body)
    assert n_on - len(calls) == ref.tc.n_layers, (n_on, len(calls))
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def test_bfloat16_train_loss_matches_reference():
    """qwen2 (the tied table: the gather's scatter-add and the LM head's
    matmul both feed its gradient) in bfloat16 compute over float32
    weights.  The loss within 5e-3.  Every gradient leaf is a bfloat16
    einsum's output in both packages, so two correct orders of operations
    differ by a few bfloat16 epsilons (2^-7) of a leaf's largest entry:
    within 2^-5 of the max |value|, and finite."""
    ref = T.reference("qwen2_0_5b", "bfloat16")
    worst = T.assert_matches(ref, rel=2.0**-5, loss_rel=5e-3)
    assert worst["['embed']['table']"] <= 2.0**-5
