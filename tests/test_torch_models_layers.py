"""The port's LM building blocks against the JAX reference's, on the CPU,
at the reduced configs in float32: norms, RoPE, naive and blockwise
attention (window, softcap, prefix), the FFNs (silu, and gelu in its tanh
form), embedding and logits, MLA (absorbed and naive), the Mamba-2 chunked
scan and its recurrent step, and MoE (outputs, and its load and drop
counters exactly, drops included).  Inputs come from numpy seeds; the
JAX parameters are carried across by ``params_from_numpy``."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import layers as JL
from repro.models import mamba as JM
from repro.models import mla as JMLA
from repro.models import moe as JMOE
from repro_torch import configs as tcfg
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TM
from repro_torch.models import mla as TMLA
from repro_torch.models import moe as TMOE
from repro_torch.core.mesh import Mesh
from repro_torch.models.convert import params_from_numpy

ATOL = 1e-5


def cfgs(arch, **changes):
    """The reduced config of ``arch`` in both packages."""
    return (dataclasses.replace(reduced(get_config(arch)), **changes),
            dataclasses.replace(tcfg.reduced(tcfg.get_config(arch)), **changes))


def carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm(norm):
    jc, tc = cfgs("qwen2_0_5b", norm=norm)
    p = {k: v + normal(i, v.shape, 0.1) for i, (k, v) in enumerate(JL.init_norm(jc, 64).items())}
    x = normal(1, (2, 5, 64), 3.0)
    close(TL.apply_norm(carry(p), t(x)), JL.apply_norm(p, x))


def test_rope():
    x = normal(2, (2, 7, 3, 16))
    pos = np.random.default_rng(3).integers(0, 5000, (2, 7)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        close(TL.apply_rope(t(x), t(pos), theta), JL.apply_rope(x, pos, theta), atol=1e-4)


FLASH_CASES = [(True, None, 0, None), (True, 7, 0, None), (True, None, 5, None), (True, 7, 0, 3.0)]


@pytest.mark.parametrize("causal,window,prefix,softcap", FLASH_CASES)
def test_flash_attention(causal, window, prefix, softcap):
    """Blockwise attention equals the reference's, and the port's naive
    score path (``apply_attention``'s) on the same mask."""
    B, S, kvh, g, hd = 2, 48, 2, 3, 16
    q, k, v = normal(4, (B, S, kvh, g, hd)), normal(5, (B, S, kvh, hd)), normal(6, (B, S, kvh, hd))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    kw = dict(scale=1 / math.sqrt(hd), causal=causal, window=window, prefix_len=prefix,
              q_chunk=16, k_chunk=12, softcap=softcap)
    got = TL.flash_attention(t(q), t(k), t(v), t(pos), t(pos), **kw)
    close(got, JL.flash_attention(q, k, v, pos, pos, **kw))
    mask = TL.attention_mask(t(pos), t(pos), causal=causal, window=window, prefix_len=prefix)
    sc = torch.einsum("bskgh,btkh->bkgst", t(q), t(k)) / math.sqrt(hd)
    if softcap:
        sc = torch.tanh(sc / softcap) * softcap
    sc = torch.where(mask[:, None, None], sc, TL.BIG_NEG)
    naive = torch.einsum("bkgst,btkh->bskgh", torch.softmax(sc, -1), t(v))
    close(got, naive.numpy(), atol=2e-5)


@pytest.mark.parametrize("arch", ["gemma3_27b", "qwen2_0_5b"])  # softcap + SWA; qkv bias
@pytest.mark.parametrize("window", [None, 4])
def test_apply_attention(arch, window):
    jc, tc = cfgs(arch, qkv_bias=True)
    p = JL.init_attention(jax.random.PRNGKey(1), jc)
    p = {k: v + normal(7, v.shape, 0.1) for k, v in p.items()}  # nonzero biases
    x = normal(8, (2, 9, 64))
    pos = np.broadcast_to(np.arange(9, dtype=np.int32)[None], (2, 9)).copy()
    mask = JL.attention_mask(pos, pos, window=window)
    want, (wk, wv) = JL.apply_attention(p, jc, x, pos, mask)
    got, (gk, gv) = TL.apply_attention(carry(p), tc, t(x), t(pos),
                                       TL.attention_mask(t(pos), t(pos), window=window))
    close(got, want)
    close(gk, wk)
    close(gv, wv)


def test_all_masked_attention_is_the_mean_of_v():
    """A mask that hides every key (the reference encoder's float zeros mask,
    read as booleans) gives each query the plain mean of v, in both."""
    jc, tc = cfgs("whisper_tiny")
    p = JL.init_attention(jax.random.PRNGKey(2), jc)
    x = normal(9, (2, 6, 64))
    pos = np.broadcast_to(np.arange(6, dtype=np.int32)[None], (2, 6)).copy()
    want, (_, v) = JL.apply_attention(p, jc, x, pos, jnp.zeros((2, 6, 6), jnp.float32), use_rope=False)
    got, _ = TL.apply_attention(carry(p), tc, t(x), t(pos), torch.zeros((2, 6, 6), dtype=torch.bool),
                                use_rope=False)
    close(got, want)
    v = jnp.asarray(v)  # [B, T, kvh, hd]: each of a kv head's query groups gets its mean
    groups = jc.n_heads // jc.n_kv_heads
    mean_v = jnp.broadcast_to(v.mean(1)[:, None, :, None], (2, 6, jc.n_kv_heads, groups, jc.hd))
    mean_v = mean_v.reshape(2, 6, -1)
    close(got, jnp.einsum("bsh,hd->bsd", mean_v, p["wo"]), atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "whisper_tiny"])  # silu; gelu (tanh form)
def test_ffn(arch):
    jc, tc = cfgs(arch)
    p = JL.init_ffn(jax.random.PRNGKey(3), jc)
    x = normal(10, (2, 5, 64), 2.0)
    got = TL.apply_ffn(carry(p), tc, t(x))
    close(got, JL.apply_ffn(p, jc, x))
    if jc.act == "gelu":  # torch's default erf form is another function
        h = torch.nn.functional.gelu(t(x) @ carry(p)["wu"]) @ carry(p)["wd"]
        assert float((h - got).abs().max()) > 1e-4


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "h2o_danube3_4b"])  # tied; untied, padded vocab
def test_embed_and_logits(arch):
    jc, tc = cfgs(arch, vocab=500)
    p = JL.init_embed(jax.random.PRNGKey(4), jc)
    tokens = np.random.default_rng(11).integers(0, 500, (2, 7)).astype(np.int32)
    x = JL.embed_tokens(p, jc, tokens, jnp.float32)
    close(TL.embed_tokens(carry(p), tc, t(tokens), torch.float32), x)
    lg = JL.mask_pad_logits(jc, JL.lm_logits(p, jc, x))
    got = TL.mask_pad_logits(tc, TL.lm_logits(carry(p), tc, t(np.asarray(x))))
    close(got, lg, atol=1e-4)


def mla_inputs(seed, B=2, S=10):
    jc, tc = cfgs("deepseek_v3")
    p = JMLA.init_mla(jax.random.PRNGKey(seed), jc)
    x = normal(seed, (B, S, 64))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    return jc, tc, p, x, pos


def test_mla_naive_and_absorbed():
    jc, tc, p, x, pos = mla_inputs(5)
    tp = carry(p)
    mask = JL.attention_mask(pos, pos)
    want, (ckv, krope) = jax.jit(JMLA.apply_mla, static_argnums=1)(p, jc, x, pos, mask)
    got, (gckv, gkrope) = TMLA.apply_mla(tp, tc, t(x), t(pos), t(np.asarray(mask)))
    close(got, want)
    close(gckv, ckv)
    close(gkrope, krope)
    # the last position's decode against the whole latent cache, both ways
    last, lpos, lmask = x[:, -1:], pos[:, -1:], np.asarray(mask)[:, -1:]
    absorbed = TMLA.apply_mla_absorbed(tp, tc, t(last), t(lpos), t(lmask), (gckv, gkrope))
    absorbed_ref = jax.jit(JMLA.apply_mla_absorbed, static_argnums=1)
    close(absorbed, absorbed_ref(p, jc, last, lpos, lmask, (ckv, krope)))
    naive, _ = TMLA.apply_mla(tp, tc, t(last), t(lpos), t(lmask), latents=(gckv, gkrope))
    close(absorbed, naive.numpy())
    close(naive, np.asarray(want)[:, -1:])


def test_ssd_chunked_and_decode_step():
    """The chunked scan over a ragged length (20, chunk 8) from a nonzero
    state, and the recurrent step token by token, against the reference."""
    jc, tc = cfgs("mamba2_1_3b")
    s = jc.ssm
    H = s.expand * 64 // s.head_dim
    B, S = 2, 20
    xh = normal(12, (B, S, H, s.head_dim))
    dt = np.log1p(np.exp(normal(13, (B, S, H)))).astype(np.float32)
    A = np.exp(np.linspace(0.0, 2.7, H)).astype(np.float32)
    Bm, Cm = normal(14, (B, S, 1, s.d_state)), normal(15, (B, S, 1, s.d_state))
    st = normal(16, (B, H, s.head_dim, s.d_state), 0.1)
    ssd = jax.jit(JM.ssd_chunked, static_argnums=0)
    for init in (None, st):
        y, fin = ssd(jc, xh, dt, A, Bm, Cm, init)
        gy, gfin = TM.ssd_chunked(tc, t(xh), t(dt), t(A), t(Bm), t(Cm), None if init is None else t(init))
        close(gy, y, atol=2e-4)
        close(gfin, fin, atol=2e-4)

    p = JM.init_mamba(jax.random.PRNGKey(6), jc)
    p = {k: (v + normal(17, v.shape, 0.05) if k in ("dt_bias", "conv_b", "D") else v) for k, v in p.items()}
    tp = carry(p)
    x = normal(18, (B, 12, 64), 0.5)
    want, (wst, wtail) = jax.jit(JM.apply_mamba, static_argnums=1)(p, jc, x)
    got, (gst, gtail) = TM.apply_mamba(tp, tc, t(x))
    close(got, want, atol=2e-4)
    close(gst, wst, atol=2e-4)
    close(gtail, wtail)
    jstate = JM.init_mamba_state(jc, B, jnp.float32)
    tstate = TM.init_mamba_state(tc, B, torch.float32, "cpu")
    step = jax.jit(JM.decode_step_mamba, static_argnums=1)
    for i in range(12):
        wy, jstate = step(p, jc, x[:, i : i + 1], jstate)
        gy, tstate = TM.decode_step_mamba(tp, tc, t(x[:, i : i + 1]), tstate)
        close(gy, wy, atol=2e-4)
    close(tstate[0], jstate[0], atol=2e-4)
    close(tstate[1], jstate[1])


MOE_CASES = [
    ("phi3_5_moe", 1.25, 8),  # generous capacity: no drop
    ("phi3_5_moe", 0.25, 64),  # tight capacity: most assignments dropped
    ("deepseek_v3", 1.25, 16),  # shared expert, aux-free router bias
    ("jamba_1_5_large", 0.5, 32),
]


@pytest.mark.parametrize("arch,capacity,seq", MOE_CASES)
def test_apply_moe(arch, capacity, seq):
    jc, tc = cfgs(arch)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, capacity_factor=capacity))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, capacity_factor=capacity))
    p = JMOE.init_moe(jax.random.PRNGKey(7), jc)
    if "router_bias" in p:
        p["router_bias"] = p["router_bias"] + normal(19, p["router_bias"].shape, 0.1)
    x = normal(20, (2, seq, 64), 0.5)
    want, waux = jax.jit(JMOE.apply_moe, static_argnums=(1, 3))(p, jc, x, None)
    got, gaux = TMOE.apply_moe(carry(p), tc, t(x), ep_axis=None)
    close(got, want)
    np.testing.assert_array_equal(gaux["expert_load"].numpy(), np.asarray(waux["expert_load"]))
    assert int(gaux["moe_dropped"]) == int(waux["moe_dropped"])
    assert gaux["moe_dropped"].dtype == torch.int32
    assert (int(waux["moe_dropped"]) > 0) == (capacity < 1.0)
    np.testing.assert_allclose(float(gaux["moe_aux_loss"]), float(waux["moe_aux_loss"]), rtol=1e-6)
    load = gaux["expert_load"]
    rows, cols, vals = TMOE.router_stats_triples(load, 3)
    jr, jcol, jv = JMOE.router_stats_triples(waux["expert_load"], 3)
    for a, b in ((rows, jr), (cols, jcol), (vals, jv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bias = normal(21, load.shape, 0.1)
    close(TMOE.update_aux_free_bias(t(bias), load), JMOE.update_aux_free_bias(bias, waux["expert_load"]))


def test_expert_parallel_context_raises():
    """With ``EP_CONTEXT``'s mesh set, ``apply_moe`` takes the expert-parallel
    path: at one data shard its capacity is the local path's, so it agrees
    with the reference's local path, its load and dropped count exactly."""
    jc, tc = cfgs("phi3_5_moe")
    jp = JMOE.init_moe(jax.random.PRNGKey(8), jc)
    p = carry(jp)
    x = normal(9, (2, 8, 64))
    want, waux = JMOE.apply_moe(jp, jc, x, ep_axis=None)
    TMOE.EP_CONTEXT.update(mesh=Mesh([torch.device("cpu")] * 2, ("model",)), dp=None)
    try:
        got, gaux = TMOE.apply_moe(p, tc, t(x), ep_axis="model")
    finally:
        TMOE.EP_CONTEXT.update(mesh=None, dp=None)
    close(got, want, atol=1e-5 * float(np.abs(np.asarray(want)).max()))  # two shards' sums: another order
    np.testing.assert_array_equal(gaux["expert_load"].numpy(), np.asarray(waux["expert_load"]))
    assert int(gaux["moe_dropped"]) == int(waux["moe_dropped"])
    TMOE.apply_moe(p, tc, torch.zeros((1, 2, 64)), ep_axis="model")  # no mesh: the local path


def test_top_k_is_stable_on_ties():
    """``lax.top_k`` keeps the lower index first among equal values."""
    x = np.random.default_rng(22).integers(0, 3, (64, 8)).astype(np.float32)
    for k in (1, 2, 5):
        wv, wi = jax.lax.top_k(x, k)
        gv, gi = TMOE.top_k(t(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
