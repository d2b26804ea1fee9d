"""Training parity for the MoE architectures (phi3.5-moe: top-2 of 16
experts; jamba: Mamba + attention + MoE every other layer) at their
reduced configs against ``jax.value_and_grad(train_loss)``, and the MoE
layer's gradient where its capacity drops tokens: a dropped assignment,
written to the cut-off extra row, gets no gradient, as the reference's
``mode="drop"`` gives none."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train as T
from repro.models import moe as JMOE
from repro_torch.models import moe as TMOE
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import tree_leaves

ARCHS = ["phi3_5_moe", "jamba_1_5_large"]


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return T.reference(request.param)


def test_train_loss_and_gradients_match_reference(ref):
    T.assert_matches(ref)


def test_moe_gradients_where_capacity_drops_tokens():
    cfg, tc = T.configs("phi3_5_moe")
    m = dataclasses.replace(cfg.moe, capacity_factor=0.25)  # capacity 8 of 16 assignments an expert
    cfg, tc = dataclasses.replace(cfg, moe=m), dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, capacity_factor=0.25))
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 16, cfg.d_model)) * 0.5).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    p = jax.tree.map(np.asarray, JMOE.init_moe(jax.random.PRNGKey(1), cfg))

    def jloss(p, x):
        out, aux = JMOE.apply_moe(p, cfg, x, ep_axis=None)
        return jnp.sum(out * ct) + aux["moe_aux_loss"], aux["moe_dropped"]

    (want, dropped), (gp, gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(p, x)
    tp = params_from_numpy(p, device="cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = TMOE.apply_moe(tp, tc, tx, ep_axis=None)
    loss = (out * torch.from_numpy(ct)).sum() + aux["moe_aux_loss"]
    got = torch.autograd.grad(loss, leaves + [tx], allow_unused=True)
    assert int(aux["moe_dropped"]) == int(dropped) > 0
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    want_g = jax.tree.leaves(gp) + [gx]
    for g, w in zip(got, want_g):
        g = np.zeros_like(w) if g is None else g.numpy()  # the router bias: no path, zeros
        assert np.isfinite(g).all()
        assert T.rel_err(g, np.asarray(w)) <= T.REL
