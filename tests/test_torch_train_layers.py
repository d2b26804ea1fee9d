"""The training path's building blocks against the JAX reference on the
CPU: flash attention's gradients (against the port's naive attention, as
the reference's own test, and against the reference's flash), the chunked
cross-entropy against the full one, and the embedding gather's backward,
which sums repeated tokens' cotangent rows in the compute dtype and goes
through ``row_accum.to_dense`` (the ``scatter_add`` kernel on the card)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train as T
from repro.models import layers as JL
from repro.models import transformer as JTF
from repro_torch import kernels
from repro_torch.kernels.scatter_add import ops as scatter_ops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TTF
from repro_torch.models.convert import params_from_numpy
from repro_torch.sparse import row_accum

MASKS = [(True, None, 0), (True, 7, 0), (True, None, 5)]  # causal; window 7 (fully masked blocks); prefix 5


def _qkv(seed=0, B=1, S=32, kvh=2, g=2, hd=8):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, kvh, g, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, kvh, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    return q, k, v, pos


def _naive(q, k, v, pos, hd, causal, window, prefix):
    """The port's naive attention (mask, softmax, weighted sum), summed."""
    mask = TL.attention_mask(pos, pos, causal=causal, window=window, prefix_len=prefix)
    sc = torch.einsum("bskgh,btkh->bkgst", q, k) / math.sqrt(hd)
    sc = torch.where(mask[:, None, None, :, :], sc, TL.BIG_NEG)
    return torch.einsum("bkgst,btkh->bskgh", torch.softmax(sc, -1), v).sum()


@pytest.mark.parametrize("causal,window,prefix", MASKS)
def test_flash_gradients_match_naive_and_reference(causal, window, prefix):
    q, k, v, pos = _qkv()
    hd = q.shape[-1]
    mask = dict(causal=causal, window=window, prefix_len=prefix)

    def j_flash(q, k, v):
        return JL.flash_attention(q, k, v, pos, pos, scale=1 / math.sqrt(hd), q_chunk=8, k_chunk=8, **mask).sum()

    want = jax.grad(j_flash, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tpos = torch.from_numpy(pos)
    out = TL.flash_attention(tq, tk, tv, tpos, tpos, scale=1 / math.sqrt(hd), q_chunk=8, k_chunk=8, **mask).sum()
    got = torch.autograd.grad(out, (tq, tk, tv))
    naive = torch.autograd.grad(_naive(tq, tk, tv, tpos, hd, causal, window, prefix), (tq, tk, tv))
    for a, b, w in zip(got, naive, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5)  # the reference's own tolerance
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=3e-5)


def test_chunked_ce_matches_full_and_reference():
    """``chunked_lm_loss`` (chunks of 8, and 16 on S=24: the largest
    divisor, 12) equals ``lm_loss`` over the full logits within the
    reference's 1e-4, and both equal the reference's; the chunked loss's
    gradient with respect to the hidden states too."""
    ref = T.reference("qwen2_0_5b")
    cfg, tc = ref.cfg, ref.tc
    tp = params_from_numpy(ref.params, device="cpu")
    for S, chunk in ((32, 8), (24, 16)):
        tokens, labels, _ = T.batch(cfg, seed=S, s=S)
        labels[0, 3] = -100
        logits, hidden, _ = JTF.forward(ref.params, cfg, tokens, None, ep_axis=None)
        full_j, _ = JTF.lm_loss(logits, labels)
        (ck_j, m_j), g_j = jax.value_and_grad(
            lambda h: JTF.chunked_lm_loss(ref.params, cfg, h, labels, chunk=chunk), has_aux=True
        )(hidden)
        with torch.no_grad():
            t_logits, t_hidden, _ = TTF.forward(tp, tc, torch.from_numpy(tokens), None, ep_axis=None)
            full, mf = TTF.lm_loss(t_logits, torch.from_numpy(labels))
        h = t_hidden.clone().requires_grad_()
        ck, m = TTF.chunked_lm_loss(tp, tc, h, torch.from_numpy(labels), chunk=chunk)
        (g,) = torch.autograd.grad(ck, h)
        ck = ck.detach()
        assert abs(float(full) - float(ck)) < 1e-4
        np.testing.assert_allclose(float(full), float(full_j), rtol=1e-5)
        np.testing.assert_allclose(float(ck), float(ck_j), rtol=1e-5)
        np.testing.assert_allclose(float(m["nll"].detach()), float(m_j["nll"]), rtol=1e-5)
        assert int(m["tokens"]) == int(mf["tokens"]) == int(m_j["tokens"]) == 2 * S - 3
        assert T.rel_err(g.numpy(), np.asarray(g_j)) <= T.REL


def _embed_case(seed, vocab_used, shape=(4, 32)):
    cfg, tc = T.configs("qwen2_0_5b")
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(cfg.vocab_padded, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, vocab_used, shape).astype(np.int32)
    ct = rng.normal(size=shape + (cfg.d_model,)).astype(np.float32)
    return cfg, tc, table, tokens, ct


def _vjps(cfg, tc, table, tokens, ct, jdt, tdt):
    """The reference's VJP of ``embed_tokens``, the port's, and PyTorch's
    own autograd of ``table[tokens].to(dtype)`` (float32 sums)."""
    _, vjp = jax.vjp(lambda t: JL.embed_tokens({"table": t}, cfg, tokens, jdt), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(ct).astype(jdt))
    tct = torch.from_numpy(ct).to(tdt)
    t = torch.from_numpy(table).requires_grad_()
    (got,) = torch.autograd.grad(TL.embed_tokens({"table": t}, tc, torch.from_numpy(tokens), tdt), t, tct)
    t2 = torch.from_numpy(table).requires_grad_()
    (default,) = torch.autograd.grad(t2[torch.from_numpy(tokens)].to(tdt) * math.sqrt(tc.d_model), t2, tct)
    return np.asarray(want), got.numpy(), default.numpy()


def test_embed_backward_float32_matches_reference():
    """20 distinct tokens over 128 positions: the folded rows, written by
    ``to_dense``, equal the reference's scatter-add to float32 rounding."""
    want, got, _ = _vjps(*_embed_case(0, 20), jnp.float32, torch.float32)
    assert got.dtype == np.float32
    assert T.rel_err(got, want) <= 1e-6


def test_embed_backward_sums_pairs_in_bfloat16_like_the_reference():
    """Each token at most twice: one bfloat16 add a row, so the order of
    the sum does not matter and the port equals the reference bit for bit.
    PyTorch's own autograd sums in float32 and does not: the test sees the
    dtype of the sum."""
    cfg, tc, table, _, ct = _embed_case(1, 512)
    tokens = np.random.default_rng(1).permutation(np.repeat(np.arange(64, dtype=np.int32), 2)).reshape(4, 32)
    want, got, default = _vjps(cfg, tc, table, tokens, ct, jnp.bfloat16, torch.bfloat16)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(default, want)


def test_embed_backward_bfloat16_many_repeats_within_the_bfloat16_sum_bound():
    """20 distinct tokens over 128 positions in bfloat16: every entry of
    the port's table gradient is a bfloat16 value (summed in bfloat16, then
    cast), and both packages' sums lie within the recursive-summation bound
    of the exact sum, (n - 1) 2^-8 sum |x| for a token seen n times; the
    order of the adds differs (a sorted fold against the reference's
    scatter)."""
    cfg, tc, table, tokens, ct = _embed_case(2, 20)
    want, got, _ = _vjps(cfg, tc, table, tokens, ct, jnp.bfloat16, torch.bfloat16)
    np.testing.assert_array_equal(got, torch.from_numpy(got).to(torch.bfloat16).float().numpy())
    x = (torch.from_numpy(ct).to(torch.bfloat16) * math.sqrt(tc.d_model)).double().numpy().reshape(-1, tc.d_model)
    ids = tokens.reshape(-1)
    exact = np.zeros(table.shape)
    mag = np.zeros(table.shape)
    np.add.at(exact, ids, x)
    np.add.at(mag, ids, np.abs(x))
    n = np.bincount(ids, minlength=table.shape[0])[:, None]
    bound = (np.maximum(n - 1, 0) * 2.0**-8 + 2.0**-9) * mag  # the adds, then the last rounding
    for g in (got, want):
        assert (np.abs(g - exact) <= bound).all()


def test_embed_backward_goes_through_to_dense(monkeypatch):
    """The backward is ``from_pairs`` (sorted, unique, PAD tail) then
    ``to_dense``, which on a CPU tensor is ``scatter_add_plain``, once a
    backward, inside ``kernels.plain_versions()`` or not."""
    seen = []
    real_plain, real_from_pairs = scatter_ops.scatter_add_plain, row_accum.from_pairs

    def plain(ids, rows, table):
        seen.append((ids.clone(), rows.dtype, table.dtype))
        return real_plain(ids, rows, table)

    def from_pairs(ids, rows, cap):
        acc = real_from_pairs(ids, rows, cap)
        seen.append(acc)
        return acc

    monkeypatch.setattr(scatter_ops, "scatter_add_plain", plain)
    monkeypatch.setattr(row_accum, "from_pairs", from_pairs)
    cfg, tc, table, tokens, ct = _embed_case(3, 20)
    for ctx in (kernels.plain_versions, lambda: torch.enable_grad()):
        seen.clear()
        with ctx():
            t = torch.from_numpy(table).requires_grad_()
            out = TL.embed_tokens({"table": t}, tc, torch.from_numpy(tokens), torch.bfloat16)
            torch.autograd.grad(out, t, torch.from_numpy(ct).to(torch.bfloat16))
        acc, (ids, rows_dtype, table_dtype) = seen
        assert rows_dtype == table_dtype == torch.bfloat16  # summed in the compute dtype
        n = len(np.unique(tokens))
        assert int(acc.nnz) == n and acc.ids.dtype == torch.int32
        np.testing.assert_array_equal(ids[:n].numpy(), np.unique(tokens))
        assert (ids[n:] == row_accum.PAD).all() and ids.shape[0] == tokens.size
