"""Training parity for DeepSeek-V3 at its reduced config (MLA, MoE with a
shared expert and aux-free routing, one dense layer, and the depth-1
multi-token-prediction module) against ``jax.value_and_grad(train_loss)``:
the loss with its MTP term, and every gradient leaf, the MTP block's and
the router bias's (no path: zeros in both) included."""
import numpy as np
import pytest
import torch

import _torch_train as T
from repro_torch.models import transformer as TTF
from repro_torch.models.convert import params_from_numpy


@pytest.fixture(scope="module")
def ref():
    return T.reference("deepseek_v3")


def test_train_loss_and_gradients_match_reference(ref):
    T.assert_matches(ref)


def test_mtp_term_is_in_the_loss(ref):
    """``train_loss`` = the chunked next-token loss + 0.01 x the MoE aux
    loss + 0.3 x ``_mtp_loss``; the MTP leaves get gradient; the aux-free
    router bias gets none."""
    p = params_from_numpy(ref.params, device="cpu")
    tokens, labels = T.tensor(ref.tokens), T.tensor(ref.labels)
    with torch.no_grad():
        total, metrics = TTF.train_loss(p, ref.tc, tokens, labels, ep_axis=None)
        _, hidden, aux = TTF.forward(p, ref.tc, tokens, ep_axis=None, last_only=True)
        base, _ = TTF.chunked_lm_loss(p, ref.tc, hidden, labels)
        mtp = TTF._mtp_loss(p, ref.tc, hidden, tokens, labels)
    np.testing.assert_allclose(float(total), float(base + 0.01 * aux + 0.3 * mtp), rtol=1e-6)
    assert float(mtp) > 0
    grads = dict(ref.grads)
    _, _, got = T.port(ref)
    got = dict(zip((k for k, _ in ref.grads), got))
    mtp_keys = [k for k in got if k.startswith("['mtp']")]
    assert mtp_keys and all(np.abs(got[k]).max() > 0 for k in mtp_keys if "bias" not in k)
    bias_keys = [k for k in got if k.endswith("['router_bias']")]
    assert bias_keys and all(not got[k].any() and not grads[k].any() for k in bias_keys)
