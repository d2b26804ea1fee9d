"""Dense building blocks shared by all architectures (port of
``repro.models.layers``).

Functional style, as the reference: ``init_*`` returns a param dict of
tensors, the ``apply`` functions are pure functions of it.  The math is the
reference's own, op for op: einsum, then the scale, then the optional
``tanh`` softcap, then ``where(mask, s, BIG_NEG)``, then a float32 softmax.
No attention library call stands in for it: the decode caches' ``kpos``
masks and the softcap must match the reference's.

Initialisers draw from an explicit ``torch.Generator`` on the generator's
own device and move the result to ``device``; ``device="meta"`` gives the
shapes without drawing or allocating.

Backward passes are autograd's, with two exceptions that keep the
reference's: :func:`remat_call` is ``jax.checkpoint`` (each flash
key/value block is recomputed in the backward, as the reference's
``kv_block``), and :func:`embed_tokens`' gather has the reference's VJP,
a scatter-add in the compute dtype through the ``scatter_add`` kernel.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .. import kernels
from ..sparse import row_accum
from .config import ModelConfig

Params = Dict[str, Any]

BIG_NEG = -2.0e38  # mask value safe in f32 softmax
FLASH_MIN_SEQ = 2048  # use blockwise attention at or above this Sq*Sk scale


def remat_call(fn: Callable, *args):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept (``jax.checkpoint``; non-reentrant ``torch.utils.checkpoint``)
    while autograd records; a plain call under ``torch.no_grad()``.  The
    model draws no random numbers, so no RNG state is kept."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _normal(gen: torch.Generator, shape, device: torch.device) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def _dense_init(gen, shape, device, scale=None, dtype=torch.float32) -> torch.Tensor:
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (_normal(gen, shape, device) * scale).to(dtype)


# ------------------------------------------------------------------ norms
def init_norm(cfg: ModelConfig, d: int, device) -> Params:
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), device=device), "bias": torch.zeros((d,), device=device)}
    return {"scale": torch.ones((d,), device=device)}


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Statistics in float32 whatever ``x``'s dtype, as the reference."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        var = (xf**2).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


# ------------------------------------------------------------------ RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] int32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # [D/2]
    angles = positions[..., None].float() * freqs  # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ flash
def flash_attention(
    q: torch.Tensor,  # [B, Sq, kvh, g, hd]
    k: torch.Tensor,  # [B, Sk, kvh, hd]
    v: torch.Tensor,  # [B, Sk, kvh, vd]
    q_pos: torch.Tensor,  # [B, Sq]
    k_pos: torch.Tensor,  # [B, Sk]
    scale: float,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
    q_chunk: int = 1024,
    k_chunk: int = 1024,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise attention with online softmax (the reference's
    ``lax.scan`` recurrence as Python loops over q and k chunks): O(chunk^2)
    live memory, semantically the naive path.  Returns [B, Sq, kvh, g, vd].
    """
    B, Sq, kvh, g, hd = q.shape
    Sk = k.shape[1]
    vd = v.shape[-1]
    qc = min(q_chunk, Sq)
    while Sq % qc:
        qc -= 1
    kc = min(k_chunk, Sk)
    while Sk % kc:
        kc -= 1
    block = functools.partial(
        _kv_block, scale=scale, causal=causal, window=window, prefix_len=prefix_len, softcap=softcap
    )
    outs = []
    for i in range(Sq // qc):
        qb, qp = q[:, i * qc : (i + 1) * qc], q_pos[:, i * qc : (i + 1) * qc]
        m = torch.full((B, kvh, g, qc), BIG_NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, kvh, g, qc), dtype=torch.float32, device=q.device)
        o = torch.zeros((B, kvh, g, qc, vd), dtype=torch.float32, device=q.device)
        for j in range(Sk // kc):
            kb, vb = k[:, j * kc : (j + 1) * kc], v[:, j * kc : (j + 1) * kc]
            kp = k_pos[:, j * kc : (j + 1) * kc]
            # rematerialised, as the reference's kv_block: the backward would
            # otherwise keep every block's [B, kvh, g, qc, kc] probabilities
            m, l, o = remat_call(block, qb, kb, vb, qp, kp, m, l, o)
        o = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.movedim(3, 1).to(qb.dtype))  # [B, qc, kvh, g, vd]
    return torch.cat(outs, dim=1)


def _kv_block(qb, kb, vb, qp, kp, m, l, o, scale, causal, window, prefix_len, softcap):
    """One key/value block of the online softmax: ``(m, l, o)`` updated."""
    s = torch.einsum("bqkgh,btkh->bkgqt", qb, kb) * scale  # [B,kvh,g,qc,kc]
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    ok = attention_mask(qp, kp, causal=causal, window=window, prefix_len=prefix_len)
    s = torch.where(ok[:, None, None, :, :], s.float(), BIG_NEG)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    o_new = o * corr[..., None] + torch.einsum("bkgqt,btkh->bkgqh", p.to(qb.dtype), vb).float()
    return m_new, l_new, o_new


# ------------------------------------------------------------------ attention
def init_attention(gen, cfg: ModelConfig, device) -> Params:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": _dense_init(gen, (d, h * hd), device),
        "wk": _dense_init(gen, (d, kvh * hd), device),
        "wv": _dense_init(gen, (d, kvh * hd), device),
        "wo": _dense_init(gen, (h * hd, d), device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), device=device)
        p["bk"] = torch.zeros((kvh * hd,), device=device)
        p["bv"] = torch.zeros((kvh * hd,), device=device)
    return p


def attention_mask(
    q_pos: torch.Tensor,  # [B, Sq]
    k_pos: torch.Tensor,  # [B, Sk]
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
    k_valid: Optional[torch.Tensor] = None,  # [B, Sk] cache-slot validity
) -> torch.Tensor:
    """[B, Sq, Sk] boolean mask, built from position arithmetic."""
    dq = q_pos[:, :, None]
    dk = k_pos[:, None, :]
    ok = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape), dtype=torch.bool, device=dq.device)
    if causal:
        ok &= dk <= dq
    if window is not None:
        ok &= dk > dq - window
    if prefix_len:
        ok |= (dq < prefix_len) & (dk < prefix_len)
    if k_valid is not None:
        ok &= k_valid[:, None, :]
    return ok


def apply_attention(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, S, d]
    positions: torch.Tensor,  # [B, S]
    mask: Optional[torch.Tensor],  # [B, Sq, Sk] bool (None = no masking)
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cached (k, v) incl. new
    use_rope: bool = True,
    flash: Optional[dict] = None,  # {causal, window, prefix_len} -> blockwise path
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (out [B, S, d], (k, v) [B, Sk, kvH, hd]); the caller manages
    the cache.  ``flash`` selects the blockwise path, with structural mask
    parameters in place of ``mask``."""
    B, S, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    q = project_heads(x, p["wq"], p.get("bq"), h, hd)
    if kv is None:
        k = project_heads(x, p["wk"], p.get("bk"), kvh, hd)
        v = project_heads(x, p["wv"], p.get("bv"), kvh, hd)
        k_pos = positions
        if use_rope:
            k = apply_rope(k, k_pos, cfg.rope_theta)
    else:
        k, v = kv  # already rope'd and cached
        k_pos = positions  # only used by the flash path (kv path passes mask)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    groups = h // kvh  # grouped-query: fold the group into q's head axis
    qg = q.reshape(B, S, kvh, groups, hd)
    if flash is not None:
        ctx = flash_attention(
            qg, k, v, positions, k_pos, scale=1.0 / math.sqrt(hd), softcap=cfg.logit_softcap, **flash
        ).reshape(B, S, h * hd)
    else:
        scores = finish_scores(cfg, head_scores(qg, k), hd, mask)
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        ctx = head_context(probs, v).reshape(B, S, h * hd)
    out = torch.einsum("bsh,hd->bsd", ctx, p["wo"].to(dt))
    return out, (k, v)


# ------------------------------------------------------------------ FFN
def init_ffn(gen, cfg: ModelConfig, device, d_ff: Optional[int] = None, d_in: Optional[int] = None) -> Params:
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act == "silu":
        return {
            "wg": _dense_init(gen, (d, f), device),
            "wu": _dense_init(gen, (d, f), device),
            "wd": _dense_init(gen, (f, d), device),
        }
    return {"wu": _dense_init(gen, (d, f), device), "wd": _dense_init(gen, (f, d), device)}


def apply_ffn(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if "wg" in p:
        g = F.silu(torch.einsum("bsd,df->bsf", x, p["wg"].to(dt)))
        u = torch.einsum("bsd,df->bsf", x, p["wu"].to(dt))
        h = g * u
    else:
        # jax.nn.gelu defaults to the tanh approximation; torch's to erf
        h = F.gelu(torch.einsum("bsd,df->bsf", x, p["wu"].to(dt)), approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["wd"].to(dt))


# ------------------------------------------------------------------ embedding
def init_embed(gen, cfg: ModelConfig, device) -> Params:
    vp = cfg.vocab_padded
    p = {"table": _dense_init(gen, (vp, cfg.d_model), device, scale=1.0)}
    if not cfg.tied_embeddings:
        p["head"] = _dense_init(gen, (cfg.d_model, vp), device)
    return p


def mask_pad_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Suppress the padded vocab region."""
    if cfg.vocab_padded == cfg.vocab:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab, logits, BIG_NEG)


class _EmbedGather(torch.autograd.Function):
    """``table[tokens].to(dtype)`` with the reference's VJP.

    The reference casts the whole table and then gathers; the cast is
    elementwise, so gathering first gives the same values without
    re-reading the table each call (vocab 32,256 x 3,840 float32 is 0.5 GB
    at full width).  Its VJP is the gather's, then the cast's: the
    cotangent rows of repeated tokens are summed in the compute dtype into
    a zero ``[V, d]`` table, and only that table is cast to the table's
    dtype.  Here the rows are folded by id (``row_accum.from_pairs``:
    sorted, unique, PAD tail) and written by ``row_accum.to_dense``, which
    is the ``scatter_add`` kernel on the card.  Autograd may run the
    backward on another thread, so whether the plain versions were asked
    for is read in the forward."""

    @staticmethod
    def forward(ctx, table, tokens, dtype):
        ctx.save_for_backward(tokens)
        ctx.rows, ctx.table_dtype = table.shape[0], table.dtype
        ctx.plain = kernels.plain_active()
        return table[tokens].to(dtype)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        ids = tokens.reshape(-1)
        with kernels.plain_versions() if ctx.plain else contextlib.nullcontext():
            acc = row_accum.from_pairs(ids, g.reshape(ids.shape[0], -1), cap=ids.shape[0])
            dense = row_accum.to_dense(acc, ctx.rows)
        return dense.to(ctx.table_dtype), None, None


def embed_tokens(p: Params, cfg: ModelConfig, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return _EmbedGather.apply(p["table"], tokens, dtype) * math.sqrt(cfg.d_model)


def lm_logits(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tied_embeddings:
        w = p["table"].to(x.dtype).T
    else:
        w = p["head"].to(x.dtype)
    return torch.einsum("bsd,dv->bsv", x, w)


# ------------------------------------------------------------------ head-split pieces
# Sharded serving (``serving``'s mesh steps) runs these on each model
# shard's slice of the weights; the mesh sums their partial outputs.

def embed_tokens_shard(table: torch.Tensor, cfg: ModelConfig, tokens: torch.Tensor, dtype, lo: int) -> torch.Tensor:
    """A vocabulary-parallel embedding's part on the shard holding table
    rows ``[lo, lo + len(table))``: the ids in that block gathered, zeros
    elsewhere (a ``psum`` over "model" gives :func:`embed_tokens`)."""
    local = tokens.long() - lo
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[torch.clamp(local, 0, max(table.shape[0] - 1, 0))].to(dtype)
    return torch.where(mine[..., None], rows, torch.zeros((), dtype=dtype, device=rows.device)) * math.sqrt(
        cfg.d_model)


def project_heads(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], n: int, hd: int) -> torch.Tensor:
    """``x @ w (+ b)`` as ``n`` heads of ``hd`` [B, S, n, hd] (``w`` the
    columns of those heads)."""
    y = torch.einsum("bsd,dh->bsh", x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y.reshape(x.shape[0], x.shape[1], n, hd)


def group_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_lo: int, n_heads: int, n_kv: int, kv_lo: int):
    """Query heads ``q`` [B, S, nq, hd] (heads ``q_lo...`` of ``n_heads``)
    against KV heads ``k``/``v`` [B, T, m, hd] (heads ``kv_lo...`` of
    ``n_kv``): ``(qg [B, S, kv, g, hd], k, v)`` grouped as the reference
    folds the group into q's head axis (views where the query heads cover
    whole groups or lie in one; else each query head's KV head is
    selected)."""
    B, S, nq, hd = q.shape
    g = n_heads // n_kv
    if q_lo % g == 0 and nq % g == 0:
        a = q_lo // g - kv_lo
        return q.reshape(B, S, nq // g, g, hd), k[:, :, a:a + nq // g], v[:, :, a:a + nq // g]
    if nq and q_lo // g == (q_lo + nq - 1) // g:
        a = q_lo // g - kv_lo
        return q.reshape(B, S, 1, nq, hd), k[:, :, a:a + 1], v[:, :, a:a + 1]
    idx = torch.tensor([(q_lo + t) // g - kv_lo for t in range(nq)], dtype=torch.long, device=k.device)
    return q.reshape(B, S, nq, 1, hd), k.index_select(2, idx), v.index_select(2, idx)


def head_scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Grouped-query scores [B, kv, g, S, T] before the scale."""
    return torch.einsum("bskgh,btkh->bkgst", qg, k)


def finish_scores(cfg: ModelConfig, s: torch.Tensor, hd: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The scale, the optional softcap and the mask, as
    :func:`apply_attention` applies them (``mask`` [B, S, T])."""
    s = s / math.sqrt(hd)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        s = torch.tanh(s / c) * c
    if mask is not None:
        s = torch.where(mask[:, None, None, :, :], s, BIG_NEG)
    return s


def head_context(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, S, kv, g, vd] from probabilities [B, kv, g, S, T]."""
    return torch.einsum("bkgst,btkh->bskgh", probs, v)
