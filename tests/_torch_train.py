"""Helpers of the training parity tests (``test_torch_train_*.py``): one
architecture's JAX reference, ``train_loss`` and its gradient over every
param leaf, jitted and computed once a process (``reference``), the port's on
the same weights (carried across by ``params_from_numpy``) and the same
numpy batch, and their comparison leaf for leaf."""
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.configs import get_config, reduced
from repro.models import transformer as JTF
from repro_torch import configs as tcfg
from repro_torch.launch import steps as TST
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import tree_leaves

B, S = 2, 16
REL = 1e-4  # each gradient leaf, of its max |value|, float32


def configs(arch, dtype="float32"):
    """The reference's and the port's reduced config of ``arch``."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
    tc = dataclasses.replace(tcfg.reduced(tcfg.get_config(arch)), dtype=dtype)
    return cfg, tc


def batch(cfg, seed=0, b=B, s=S):
    """Tokens, next-token labels (-100 at the end) and the stub frontend's
    embeddings, from a numpy seed."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -100, np.int32)], axis=1)
    fe = None
    if cfg.frontend == "vision":
        fe = (rng.normal(size=(b, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    elif cfg.encoder_layers:
        fe = (rng.normal(size=(b, cfg.encoder_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return tokens, labels, fe


def tensor(x):
    return None if x is None else torch.from_numpy(x)


@dataclasses.dataclass
class Ref:
    arch: str
    cfg: object
    tc: object
    params: object  # the reference's init_params tree, numpy leaves
    tokens: np.ndarray
    labels: np.ndarray
    fe: object
    loss: float
    metrics: dict
    grads: list  # (keystr path, numpy leaf) in jax.tree.leaves order


@functools.lru_cache(maxsize=None)
def reference(arch, dtype="float32") -> Ref:
    cfg, tc = configs(arch, dtype)
    jp = JTF.init_params(jax.random.PRNGKey(0), cfg)
    tokens, labels, fe = batch(cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: JTF.train_loss(p, cfg, tokens, labels, fe, ep_axis=None), has_aux=True
    ))(jp)
    return Ref(
        arch, cfg, tc, jax.tree.map(np.asarray, jp), tokens, labels, fe, float(loss),
        {k: np.asarray(v) for k, v in metrics.items()},
        [(jax.tree_util.keystr(k), np.asarray(v)) for k, v in jax.tree_util.tree_leaves_with_path(grads)],
    )


def port(ref: Ref):
    """The port's ``(loss, metrics, grads)`` on the reference's weights and
    batch; grads as a list in the same leaf order."""
    params = params_from_numpy(ref.params, device="cpu")
    loss, metrics, grads = TST.value_and_grad(ref.tc, ep_axis=None)(
        params, tensor(ref.tokens), tensor(ref.labels), tensor(ref.fe)
    )
    return loss, metrics, [g.numpy() for g in tree_leaves(grads)]


def rel_err(got, want) -> float:
    scale = float(np.abs(want).max())
    return float(np.abs(got.astype(np.float64) - want).max() / (scale if scale else 1.0))


def assert_matches(ref: Ref, rel=REL, loss_rel=1e-5):
    """Loss and metrics, then every gradient leaf: the same shapes and
    dtypes, finite, within ``rel`` of the leaf's max |value|."""
    loss, metrics, grads = port(ref)
    assert abs(float(loss) - ref.loss) <= loss_rel * abs(ref.loss), (ref.arch, float(loss), ref.loss)
    assert set(metrics) == set(ref.metrics), (sorted(metrics), sorted(ref.metrics))
    assert int(metrics["tokens"]) == int(ref.metrics["tokens"])
    assert abs(float(metrics["nll"]) - float(ref.metrics["nll"])) <= loss_rel * abs(float(ref.metrics["nll"]))
    np.testing.assert_allclose(float(metrics["moe_aux"]), float(ref.metrics["moe_aux"]), rtol=1e-5, atol=1e-7)
    assert len(grads) == len(ref.grads)
    worst = {}
    for got, (path, want) in zip(grads, ref.grads):
        assert got.shape == want.shape and got.dtype == want.dtype, (path, got.shape, want.shape)
        assert np.isfinite(got).all(), (ref.arch, path, "non-finite gradient")
        worst[path] = rel_err(got, want)
        assert worst[path] <= rel, (ref.arch, path, worst[path])
    return worst
