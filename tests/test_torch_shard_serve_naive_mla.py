"""The sharded MLA decode's naive form (``serving.MLA_ABSORBED["enabled"]``
off in both packages): deepseek-v3 ``reduced()`` in float32, the port's
sharded decode on a 2 x 2 ``(data, model)`` mesh (the batch over "data")
and on 4 x 2 (the batch below the data axis: the sequence-parallel
branch) against the port's unsharded naive decode and the JAX
reference's unsharded naive ``make_serve_step``, within 1e-4 of max
|logit|; ``launch.dryrun.serve_collectives`` against the mesh's counters
under either setting of the flag; the absorbed form beside it.  One
jitted reference step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve_shard as H
from repro.configs import get_config, reduced
from repro.launch import steps as JST
from repro.models import serving as JSV
from repro.models import transformer as JTF
from repro_torch.launch import dryrun as DR
from repro_torch.launch import shapes as SH
from repro_torch.models import mla as MLA
from repro_torch.models import serving as SV
from repro_torch.models import transformer as TF
from repro_torch.models.convert import params_from_numpy

ARCH, B = "deepseek_v3", 2
GRIDS = ((2, 2), (4, 2))
_REF = {}


@pytest.fixture
def forms(monkeypatch):
    """Counts of the port's calls of each form's scores."""
    n = {"naive": 0, "absorbed": 0}
    for form in n:
        fn = getattr(MLA, form + "_scores")

        def counted(*a, _fn=fn, _form=form):
            n[_form] += 1
            return _fn(*a)
        monkeypatch.setattr(MLA, form + "_scores", counted)
    return n


def reference():
    """The reference's unsharded naive decode (its weights carried to the
    port) from the seed-made cache: (port params, logits [B, STEPS, V])."""
    if not _REF:
        was = JSV.MLA_ABSORBED["enabled"]
        JSV.MLA_ABSORBED["enabled"] = False  # read when the step is traced
        try:
            _REF["params"], _REF["logits"] = _reference_run()
        finally:
            JSV.MLA_ABSORBED["enabled"] = was
    return _REF["params"], _REF["logits"]


def _reference_run():
    cfg = H.config(ARCH)
    jcfg = reduced(get_config(ARCH))
    jcfg = type(jcfg)(**{**jcfg.__dict__, "dtype": "float32"})
    jparams = JTF.init_params(jax.random.PRNGKey(0), jcfg)
    cache = JSV.init_cache(jcfg, B, H.CAP, jnp.float32)
    cache = jax.tree.unflatten(jax.tree.structure(cache), [jnp.asarray(x) for x in leaves(cfg)])
    step = jax.jit(JST.make_serve_step(jcfg, ep_axis=None))
    outs = []
    for t in range(H.STEPS):
        lg, cache = step(jparams, cache, jnp.asarray(tokens(cfg)[:, t:t + 1]))
        outs.append(np.asarray(lg))
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"), np.concatenate(outs, axis=1)


def leaves(cfg):
    return H.seed_cache_leaves(cfg, B)


def tokens(cfg):
    return H.tokens(cfg, B, H.STEPS)


def formula(cfg, m):
    return DR.serve_collectives(cfg, m, "tp", SH.ShapeSpec("d", "decode", H.CAP, B))


def test_naive_sharded_decode_matches_the_unsharded_steps(monkeypatch, forms):
    cfg = H.config(ARCH)
    params, want = reference()
    monkeypatch.setitem(SV.MLA_ABSORBED, "enabled", False)
    port, _ = H.unsharded_decode(params, cfg, leaves(cfg), tokens(cfg))
    assert H.rel(port, want) <= H.REL, H.rel(port, want)
    for grid in GRIDS:
        got, cache, _ = H.sharded_decode(params, cfg, H.mesh(*grid), "tp", leaves(cfg), tokens(cfg))
        assert got.shape == want.shape
        assert H.rel(got, want) <= H.REL, (grid, H.rel(got, want))
        assert H.rel(got, port) <= H.REL, (grid, H.rel(got, port))
        assert int(cache["pos"]) == H.POS0 + H.STEPS
    assert forms["naive"] > 0 and forms["absorbed"] == 0, forms


def narrow_values():
    """The reduced config with ``v_head_dim`` below ``kv_lora_rank`` (16 and
    16 in ``reduced()``), so the two forms' context all-reduces differ in
    bytes; the port's own weights."""
    cfg = H.config(ARCH)
    cfg = dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, v_head_dim=8))
    return cfg, TF.init_params(torch.Generator().manual_seed(0), cfg, "cpu")


@pytest.mark.parametrize("absorbed", [False, True])
def test_serve_collectives_follow_the_flag(monkeypatch, absorbed):
    monkeypatch.setitem(SV.MLA_ABSORBED, "enabled", absorbed)
    for cfg, params in (narrow_values(), (H.config(ARCH), reference()[0])):
        for grid in GRIDS:
            m = H.mesh(*grid)
            _, _, counted = H.sharded_decode(params, cfg, m, "tp", leaves(cfg), tokens(cfg)[:, :1])
            assert counted == formula(cfg, m), (cfg.mla, grid, absorbed)


def test_the_split_slot_axis_psums_the_flagged_context(monkeypatch):
    """Under the sequence-parallel branch the context's all-reduce is the
    latent context (b, 1, h, kv_lora_rank) absorbed and the value context
    (b, 1, h, v_head_dim) naive, one a layer; nothing else differs."""
    cfg, _ = narrow_values()
    for grid, split in (((2, 2), False), ((4, 2), True)):
        m = H.mesh(*grid)
        on = formula(cfg, m)
        monkeypatch.setitem(SV.MLA_ABSORBED, "enabled", False)
        off = formula(cfg, m)
        monkeypatch.setitem(SV.MLA_ABSORBED, "enabled", True)
        assert on[0] == off[0]
        per_layer = B * (cfg.n_heads // 2) * (cfg.mla.kv_lora_rank - cfg.mla.v_head_dim) * 4
        assert on[1]["all-reduce"] - off[1]["all-reduce"] == (cfg.n_layers * per_layer if split else 0)
        assert on[1]["all-gather"] == off[1]["all-gather"]


def test_absorbed_sharded_decode_is_unchanged(forms):
    """With the flag on (the default) the sharded decode is the absorbed
    form: it matches the port's unsharded absorbed decode, and the two
    forms' logits differ by rounding alone."""
    cfg = H.config(ARCH)
    params, naive_want = reference()
    port, _ = H.unsharded_decode(params, cfg, leaves(cfg), tokens(cfg))
    assert forms["absorbed"] > 0 and forms["naive"] == 0, forms
    for grid in GRIDS:
        got, _, _ = H.sharded_decode(params, cfg, H.mesh(*grid), "tp", leaves(cfg), tokens(cfg))
        assert H.rel(got, port) <= H.REL, (grid, H.rel(got, port))
    assert forms["naive"] == 0, forms
    assert H.rel(port, naive_want) <= H.REL
