"""The port's top-k gradient compression with error feedback against the
reference's ``optim.compression``: the same sparse gradients and
residuals bit for bit, ``sparse + residual == g + old residual`` exactly,
ties at the threshold all kept, the byte accounting, and the train step
with compression on."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train as T
from repro.optim import compression as JC
from repro_torch.launch import steps as TST
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TC
from repro_torch.optim.adamw import tree_leaves


def _both(tree):
    return jax.tree.map(jnp.asarray, tree), {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_topk_compression_error_feedback_conserves_mass():
    """``tests/test_runtime.py``'s check, ported, and equal to the
    reference's output."""
    cfg = TC.CompressionConfig(enabled=True, top_k_frac=0.25, min_size=4)
    jcfg = JC.CompressionConfig(enabled=True, top_k_frac=0.25, min_size=4)
    jg, g = _both({"w": np.arange(16.0, dtype=np.float32).reshape(4, 4)})
    res = TC.init_error_feedback(g)
    sparse, res2 = TC.compress(g, res, cfg)
    np.testing.assert_allclose((sparse["w"] + res2["w"]).numpy(), g["w"].numpy(), rtol=1e-6)
    assert int((sparse["w"] != 0).sum()) <= 4 + 1  # top 25% of 16 (ties may add one)
    sparse2, res3 = TC.compress({"w": torch.zeros(4, 4)}, res2, cfg)
    np.testing.assert_allclose((sparse2["w"] + res3["w"]).numpy(), res2["w"].numpy(), rtol=1e-6)

    js, jr2 = JC.compress(jg, JC.init_error_feedback(jg), jcfg)
    js2, jr3 = JC.compress(jax.tree.map(jnp.zeros_like, jg), jr2, jcfg)
    for got, want in ((sparse, js), (res2, jr2), (sparse2, js2), (res3, jr3)):
        np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_compress_matches_reference_bit_for_bit(frac):
    """A tree of leaves around ``min_size`` (kept whole below it), with
    repeated magnitudes (ties at the threshold: every one kept, whatever
    order a top-k returns them in) and signed zeros; the residual re-enters
    twice.  ``sparse + residual`` is ``g + old residual`` exactly."""
    rng = np.random.default_rng(int(frac * 100))
    tree = {
        "a": rng.normal(size=(64, 64)).astype(np.float32),
        "b": np.round(rng.normal(size=(200, 100)) * 4).astype(np.float32) / 4,  # many ties
        "c": rng.normal(size=(15,)).astype(np.float32),  # under min_size
        "d": np.where(rng.random((128, 128)) < 0.3, -0.0, rng.normal(size=(128, 128))).astype(np.float32),
    }
    cfg = TC.CompressionConfig(enabled=True, top_k_frac=frac, min_size=1024)
    jcfg = JC.CompressionConfig(enabled=True, top_k_frac=frac, min_size=1024)
    jg, g = _both(tree)
    res, jres = TC.init_error_feedback(g), JC.init_error_feedback(jg)
    for _ in range(3):
        sparse, new_res = TC.compress(g, res, cfg)
        jsparse, jres = JC.compress(jg, jres, jcfg)
        for k in tree:
            np.testing.assert_array_equal(sparse[k].numpy(), np.asarray(jsparse[k]))
            np.testing.assert_array_equal(new_res[k].numpy(), np.asarray(jres[k]))
            assert torch.equal(sparse[k] + new_res[k], g[k] + res[k]), k
        k_b = max(1, int(tree["b"].size * frac))
        thresh = torch.topk((g["b"] + res["b"]).abs().reshape(-1), k_b).values[-1]
        assert int((sparse["b"] != 0).sum()) == int(((g["b"] + res["b"]).abs() >= thresh).sum()) >= k_b
        res = new_res
    assert TC.comm_bytes_saved(g, cfg) == JC.comm_bytes_saved(jg, jcfg) > 0
    assert TC.comm_bytes_saved(g, TC.CompressionConfig()) == 0


def test_disabled_compression_passes_through():
    g = {"w": torch.arange(4.0)}
    r = TC.init_error_feedback(g)
    out, res = TC.compress(g, r, TC.CompressionConfig())
    assert out is g and res is r


def test_train_step_with_compression():
    """The state gains ``residual``; the step equals the gradients, then
    ``compress``, then AdamW by hand, bit for bit, and the residual holds
    what the sparse update left out."""
    cfg, tc = T.configs("granite_3_8b")
    comp = TC.CompressionConfig(enabled=True, top_k_frac=0.05, min_size=1024)
    state = TST.init_train_state(torch.Generator().manual_seed(0), tc, "cpu")
    state["residual"] = TC.init_error_feedback(state["params"])
    tokens, labels, _ = T.batch(cfg)
    b = {"tokens": T.tensor(tokens), "labels": T.tensor(labels)}
    new, metrics = TST.make_train_step(tc, n_micro=1, ep_axis=None, comp_cfg=comp)(state, b)
    assert set(new) == {"params", "opt", "residual"}
    _, _, grads = TST.value_and_grad(tc, ep_axis=None)(state["params"], b["tokens"], b["labels"], None)
    sparse, res = TC.compress(grads, state["residual"], comp)
    want_p, _, want_m = TA.update(sparse, state["opt"], state["params"], TA.AdamWConfig())
    for a, c in zip(tree_leaves(new["params"]), tree_leaves(want_p)):
        assert torch.equal(a, c)
    for s, r, g in zip(tree_leaves(sparse), tree_leaves(new["residual"]), tree_leaves(grads)):
        assert torch.equal(s + r, g)
    assert torch.equal(metrics["grad_norm"], want_m["grad_norm"])
