"""The port's full-sequence ``forward`` against the JAX reference's for all
ten architectures at their reduced configs (float32, the reference's
weights carried across by ``params_from_numpy``), and the stage plan and
the param tree (paths, shapes, dtypes) against the reference's at the full
published configs."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, reduced
from repro.models import transformer as JTF
from repro_torch import configs as tcfg
from repro_torch.models import transformer as TTF
from repro_torch.models.convert import params_from_numpy

REL = 1e-4


def inputs(cfg, seed=0, B=2, S=16):
    """Tokens and the stub frontend's embeddings, from a numpy seed."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    fe = None
    if cfg.frontend == "vision":
        fe = (rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    elif cfg.encoder_layers:
        fe = (rng.normal(size=(B, cfg.encoder_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return tokens, fe


def tensor(x):
    return None if x is None else torch.from_numpy(x)


def rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    cfg = reduced(get_config(arch))
    tc = tcfg.reduced(tcfg.get_config(arch))
    jp = JTF.init_params(jax.random.PRNGKey(0), cfg)
    tokens, fe = inputs(cfg)
    logits, hidden, aux = jax.jit(functools.partial(JTF.forward, cfg=cfg, ep_axis=None))(
        jp, tokens=tokens, frontend_embeds=fe)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    with torch.no_grad():
        g_logits, g_hidden, g_aux = TTF.forward(tp, tc, torch.from_numpy(tokens), tensor(fe), ep_axis=None)
        g_last, _, _ = TTF.forward(tp, tc, torch.from_numpy(tokens), tensor(fe), ep_axis=None, last_only=True)
    assert g_logits.shape == logits.shape and g_logits.dtype == torch.float32
    assert rel_err(g_logits.numpy(), logits) <= REL, arch
    assert rel_err(g_hidden.numpy(), hidden) <= REL, arch
    np.testing.assert_allclose(float(g_aux), float(aux), rtol=1e-5, atol=1e-7)
    assert rel_err(g_last.numpy(), g_logits[:, -1:].numpy()) <= 1e-6


def _plan(stages):
    return [(tuple((g.kind, g.is_global, g.has_moe) for g in st.specs), st.reps) for st in stages]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_and_param_tree_match_reference(arch):
    """At the full published config: the same stage plan, and the port's
    ``init_params`` tree (built on ``meta``: shapes only) has the
    reference's paths, shapes and dtypes leaf for leaf."""
    cfg, tc = get_config(arch), tcfg.get_config(arch)
    assert _plan(TTF.build_plan(tc)) == _plan(JTF.build_plan(cfg))
    want = jax.eval_shape(functools.partial(JTF.init_params, cfg=cfg), jax.random.PRNGKey(0))
    got = TTF.init_params(None, tc, device="meta")
    want_leaves = [(jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype))
                   for k, v in jax.tree_util.tree_leaves_with_path(want)]
    got_leaves = [(jax.tree_util.keystr(k), tuple(v.shape), str(v.dtype).removeprefix("torch."))
                  for k, v in jax.tree_util.tree_leaves_with_path(got)]
    assert got_leaves == want_leaves
    n = sum(int(np.prod(s)) for _, s, _ in got_leaves)
    # within a few percent of the config's count: the tree adds the padded
    # vocab rows and norm biases; deepseek's count takes its MTP block for
    # an MoE layer, where the tree builds it dense
    assert 0.98 < n / tc.param_count() < 1.05, (arch, n, tc.param_count())
