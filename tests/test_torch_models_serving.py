"""The port's static-cache decode against the JAX reference's, on the CPU
at the reduced configs: teacher-forced ``decode_step`` logits for eight
architectures (ring-buffer SWA caches, local:global, MLA latent caches in
both decode forms, SSM state, MoE, enc-dec), ``greedy_generate``'s tokens,
one bfloat16 case at the reference's own 5e-3 criterion, the weight
carry-over's round trip and the ``TransformerLM`` module.  Each
architecture's reference is computed once (``_REFS``): one jitted step,
reused for the margins of the greedy check."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import serving as JSV
from repro.models import transformer as JTF
from repro_torch import configs as tcfg
from repro_torch.models import serving as TSV
from repro_torch.models import transformer as TTF
from repro_torch.models.convert import TransformerLM, params_from_numpy, params_to_numpy

DECODE_ARCHS = ["h2o_danube3_4b", "gemma3_27b", "deepseek_v3", "mamba2_1_3b", "jamba_1_5_large",
                "whisper_tiny", "qwen2_0_5b", "phi3_5_moe"]
B, S, PROMPT = 2, 12, 4  # greedy: a 4-token prompt and 8 new tokens fill the 12-slot cache
REL = 1e-4
NEAR_TIE = 1e-3  # a top-2 margin under this share of max|logit| is a tie

_REFS = {}


def carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def frontend(cfg, rng):
    if not cfg.encoder_layers:
        return None
    return (rng.normal(size=(B, cfg.encoder_tokens, cfg.d_model)) * 0.02).astype(np.float32)


def ref_decode(cfg, step, params, tokens, fe):
    """The reference's teacher-forced logits [B, S, V] over ``tokens``."""
    cache = JSV.init_cache(cfg, B, s_cap=S, dtype=jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32)
    if cfg.encoder_layers:
        cache = JSV.prefill_encoder(params, cfg, fe, cache)
    outs = []
    for i in range(tokens.shape[1]):
        lg, cache = step(params, cache=cache, token=tokens[:, i : i + 1])
        outs.append(np.asarray(lg.astype(jnp.float32)))
    return np.concatenate(outs, axis=1)


def port_decode(cfg, params, tokens, fe):
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    cache = TSV.init_cache(cfg, B, S, dtype, "cpu")
    if cfg.encoder_layers:
        cache = TSV.prefill_encoder(params, cfg, torch.from_numpy(fe), cache)
    outs = []
    with torch.no_grad():
        for i in range(tokens.shape[1]):
            lg, cache = TSV.decode_step(params, cfg, cache, torch.from_numpy(tokens[:, i : i + 1]), ep_axis=None)
            outs.append(lg.float().numpy())
    return np.concatenate(outs, axis=1)


def ref(arch, dtype="float32"):
    """The reference's params, inputs, jitted step and teacher-forced
    logits for ``arch``, made once."""
    if (arch, dtype) not in _REFS:
        cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype)
        tc = dataclasses.replace(tcfg.reduced(tcfg.get_config(arch)), dtype=dtype)
        params = JTF.init_params(jax.random.PRNGKey(0), cfg)
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        fe = frontend(cfg, rng)
        step = jax.jit(functools.partial(JSV.decode_step, cfg=cfg, ep_axis=None))
        _REFS[arch, dtype] = dict(cfg=cfg, tc=tc, params=params, tokens=tokens, fe=fe, step=step,
                                  logits=ref_decode(cfg, step, params, tokens, fe))
    return _REFS[arch, dtype]


def per_position(got, want):
    """max |delta| over batch and vocab at each position, over max|want|."""
    return np.abs(got - want).max(axis=(0, 2)) / np.abs(want).max()


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_reference(arch):
    r = ref(arch)
    got = port_decode(r["tc"], carry(r["params"]), r["tokens"], r["fe"])
    assert got.shape == r["logits"].shape
    assert per_position(got, r["logits"]).max() <= REL, arch
    if r["cfg"].mla is not None:  # the naive up-projection decode agrees too
        TSV.MLA_ABSORBED["enabled"] = False
        try:
            naive = port_decode(r["tc"], carry(r["params"]), r["tokens"], r["fe"])
        finally:
            TSV.MLA_ABSORBED["enabled"] = True
        assert per_position(naive, got).max() <= REL


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_greedy_generate_matches_reference(arch):
    """The port's tokens equal the reference's ``greedy_generate``'s up to
    each row's first difference, and a row may differ only where the
    reference's own top-2 margin is a near-tie (its logits re-read by
    teacher forcing over its output); ties are counted, never re-seeded
    away, and must stay few."""
    r = ref(arch)
    cfg, params, fe = r["cfg"], r["params"], r["fe"]
    prompt = r["tokens"][:, :PROMPT]
    steps = S - PROMPT
    want = np.asarray(JSV.greedy_generate(params, cfg, prompt, steps=steps, s_cap=S, frontend_embeds=fe))
    with torch.no_grad():
        got = TSV.greedy_generate(carry(params), r["tc"], torch.from_numpy(prompt), steps=steps, s_cap=S,
                                  frontend_embeds=None if fe is None else torch.from_numpy(fe)).numpy()
    assert got.shape == want.shape == (B, steps) and got.dtype == np.int32
    seq = np.concatenate([prompt, want], axis=1)
    lg = ref_decode(cfg, r["step"], params, seq[:, :-1], fe)[:, PROMPT - 1 :, : cfg.vocab]
    top2 = np.sort(lg, axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0]) / np.abs(lg).max()
    ties = 0
    for b in range(B):
        diff = np.flatnonzero(got[b] != want[b])
        if diff.size:
            i = diff[0]
            assert margin[b, i] <= NEAR_TIE, (arch, b, i, margin[b, i])
            ties += 1
    assert ties <= 1, (arch, ties)


def test_bfloat16_decode_within_reference_criterion():
    """bfloat16 compute: the port's decode logits within the reference's
    own decode-vs-forward criterion (5e-3 of max|logit| at every position)."""
    r = ref("qwen2_0_5b", "bfloat16")
    got = port_decode(r["tc"], carry(r["params"]), r["tokens"], r["fe"])
    assert per_position(got, r["logits"]).max() <= 5e-3


@pytest.mark.parametrize("arch", ["deepseek_v3", "whisper_tiny", "jamba_1_5_large"])
def test_params_round_trip_bit_exact(arch):
    want = jax.tree.map(np.asarray, JTF.init_params(jax.random.PRNGKey(3), reduced(get_config(arch))))
    got = params_to_numpy(params_from_numpy(want, device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_transformer_lm_module():
    """``state_dict`` keys are the tree paths; forward, decode and generate
    through the module are the functions on the same tree."""
    r = ref("jamba_1_5_large")
    tree = jax.tree.map(np.asarray, r["params"])
    lm = TransformerLM(r["tc"], params_from_numpy(tree, device="cpu"))
    paths = [jax.tree_util.keystr(k, simple=True, separator=".") for k, _ in jax.tree_util.tree_leaves_with_path(tree)]
    assert sorted(lm.state_dict()) == sorted(paths)
    assert "stages.0.0.norm_mix.scale" in lm.state_dict()
    assert not any(p.requires_grad for p in lm.parameters())
    tokens = torch.from_numpy(r["tokens"])
    with torch.no_grad():
        logits, _, _ = lm(tokens)
        want, _, _ = TTF.forward(carry(r["params"]), r["tc"], tokens, ep_axis=None)
        assert torch.equal(logits, want)
        cache = TSV.init_cache(r["tc"], B, S, torch.float32, "cpu")
        lg, cache = lm.decode_step(cache, tokens[:, :1])
        np.testing.assert_allclose(lg.numpy(), r["logits"][:, :1], atol=1e-4 * np.abs(r["logits"]).max())
        out = lm.generate(tokens[:, :PROMPT], steps=2, s_cap=S)
    assert out.shape == (B, 2)
