"""Unified model assembly for all 10 assigned architectures (port of
``repro.models.transformer``).

A config is compiled into a *stage plan*: the decoder's per-layer kind
signature ``(mixer, global/local, moe?)`` is factored into
``prefix + period^reps + suffix``.  The reference runs each repeated period
under one ``lax.scan`` over ``[reps, ...]``-stacked parameters; the port
keeps those stacked leaves (the same tree) and runs the period as a Python
loop over ``reps``.

Families handled:
* dense / GQA / SWA / local:global  (danube, gemma3, qwen2, granite)
* MoE (phi3.5-moe), MLA+MoE+MTP (deepseek-v3)
* hybrid mamba+attn+MoE (jamba), pure SSM (mamba2, FFN-free blocks)
* prefix-LM VLM with stub vision embeddings (paligemma)
* encoder-decoder with stub audio frontend (whisper)

``remat=True`` (the default) runs each decoder layer, and each of
whisper's self+cross blocks, under ``layers.remat_call`` (the reference's
``jax.checkpoint``): while autograd records, a layer keeps only its input
and recomputes its activations in the backward.  Under ``torch.no_grad()``
it changes nothing.

Entry points: ``forward`` (training and prefill) and ``train_loss``
(the chunked cross-entropy, the MoE aux term and DeepSeek-V3's MTP term);
``serving.decode_step`` for one token against a static cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device

from . import layers as L
from . import mamba as M
from . import mla as MLA
from . import moe as MOE
from .config import ModelConfig

Params = Dict[str, Any]


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of trees of one structure: nested dicts,
    lists and tuples (the param and cache trees) with tensors at the
    leaves."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# stage plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupSpec:
    kind: str  # 'attn' | 'ssm'
    is_global: bool  # full-context attention (vs sliding window)
    has_moe: bool


@dataclasses.dataclass(frozen=True)
class Stage:
    specs: Tuple[GroupSpec, ...]  # layer kinds within one repetition
    reps: int  # repetitions (1 = apply once, unstacked params)

    @property
    def n_layers(self) -> int:
        return len(self.specs) * self.reps


def _sig(cfg: ModelConfig, i: int) -> GroupSpec:
    kind = cfg.layer_kind(i)
    return GroupSpec(
        kind,
        cfg.layer_is_global_attn(i) if kind == "attn" else False,
        cfg.layer_has_moe(i),
    )


def _consecutive_stages(sigs: List[GroupSpec]) -> List[Stage]:
    out: List[Stage] = []
    i = 0
    while i < len(sigs):
        j = i
        while j + 1 < len(sigs) and sigs[j + 1] == sigs[i]:
            j += 1
        out.append(Stage((sigs[i],), j - i + 1))
        i = j + 1
    return out


def build_plan(cfg: ModelConfig) -> Tuple[Stage, ...]:
    sigs = [_sig(cfg, i) for i in range(cfg.n_layers)]
    prefix = sigs[: cfg.first_dense]
    region = sigs[cfg.first_dense :]
    stages: List[Stage] = _consecutive_stages(prefix)
    if region:
        n = len(region)
        best_p = n
        for p in range(1, n + 1):
            if n // p >= 1 and all(region[k] == region[k % p] for k in range(n)):
                best_p = p
                break
        reps = n // best_p
        if reps > 1:
            stages.append(Stage(tuple(region[:best_p]), reps))
            stages.extend(_consecutive_stages(region[reps * best_p :]))
        else:
            stages.extend(_consecutive_stages(region))
    assert sum(s.n_layers for s in stages) == cfg.n_layers
    return tuple(stages)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg: ModelConfig, g: GroupSpec, device) -> Params:
    p: Params = {
        "norm_mix": L.init_norm(cfg, cfg.d_model, device),
        "norm_ffn": L.init_norm(cfg, cfg.d_model, device),
    }
    if g.kind == "ssm":
        p["ssm"] = M.init_mamba(gen, cfg, device)
    elif cfg.mla is not None:
        p["mla"] = MLA.init_mla(gen, cfg, device)
    else:
        p["attn"] = L.init_attention(gen, cfg, device)
    if g.has_moe:
        p["moe"] = MOE.init_moe(gen, cfg, device)
    elif cfg.d_ff > 0:
        p["ffn"] = L.init_ffn(gen, cfg, device)
    else:
        del p["norm_ffn"]  # pure-mamba blocks (mamba2) have no FFN sublayer
    return p


def _stack(trees: List[Params]) -> Params:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def init_stage(gen, cfg: ModelConfig, st: Stage, device):
    """Per-stage params: a tuple over specs; leaves stacked [reps, ...] if
    reps > 1."""
    if st.reps == 1:
        return tuple(_init_layer(gen, cfg, g, device) for g in st.specs)
    return tuple(_stack([_init_layer(gen, cfg, g, device) for _ in range(st.reps)]) for g in st.specs)


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Float32 master weights in the reference's tree shape and leaf names,
    drawn from ``gen`` (on its own device) and placed on ``device``
    (``cuda`` unless given; ``"meta"`` gives the shapes alone).  The
    values are not JAX's: carry those across with
    :func:`repro_torch.models.convert.params_from_numpy`."""
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    plan = build_plan(cfg)
    stages = [init_stage(gen, cfg, st, dev) for st in plan]
    params: Params = {
        "embed": L.init_embed(gen, cfg, dev),
        "stages": stages,
        "final_norm": L.init_norm(cfg, cfg.d_model, dev),
    }
    if cfg.encoder_layers:
        enc_layers = [
            {
                "norm1": L.init_norm(cfg, cfg.d_model, dev),
                "attn": L.init_attention(gen, cfg, dev),
                "norm2": L.init_norm(cfg, cfg.d_model, dev),
                "ffn": L.init_ffn(gen, cfg, dev),
            }
            for _ in range(cfg.encoder_layers)
        ]
        params["encoder"] = {"layers": _stack(enc_layers), "final_norm": L.init_norm(cfg, cfg.d_model, dev)}
        params["cross"] = _stack([
            {"norm": L.init_norm(cfg, cfg.d_model, dev), "attn": L.init_attention(gen, cfg, dev)}
            for _ in range(cfg.n_layers)
        ])
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": L._dense_init(gen, (2 * cfg.d_model, cfg.d_model), dev),
            "norm_h": L.init_norm(cfg, cfg.d_model, dev),
            "norm_e": L.init_norm(cfg, cfg.d_model, dev),
            "block": _init_layer(gen, cfg, GroupSpec("attn", True, False), dev),
            "final_norm": L.init_norm(cfg, cfg.d_model, dev),
        }
    return params


def layer_of(stacked: Params, r: int) -> Params:
    """Repetition ``r`` of a ``[reps, ...]``-stacked layer tree."""
    return tree_map(lambda w: w[r], stacked)


# Launch context (the reference's trace-time ``ACT_CTX``), set by the
# sharded launchers: ``cast_params`` casts float32 stage weights to the
# compute dtype before a ZeRO-3 gather, so the gather moves bfloat16
# (numerically identical for the matmul paths, which cast at use anyway).
# The sharded step's gather (``launch.steps._gather_params``) is the one
# place that reads it.  The reference's activation pin has no counterpart:
# each data shard's slice of the batch runs on that shard's own device.
ACT_CTX = {"cast_params": False}

# the MoE aux term's weight in ``train_loss`` (a sharded step adds the
# expert-parallel aux term's value with it after its data shards ran)
MOE_AUX_WEIGHT = 0.01


# ---------------------------------------------------------------------------
# one decoder layer (full-sequence path)
# ---------------------------------------------------------------------------

def _apply_layer_train(p, cfg: ModelConfig, g: GroupSpec, x, positions, ep_axis, prefix_len: int = 0):
    """Masks are structural (causal/window/prefix) and built inside the
    layer; at Sq >= FLASH_MIN_SEQ the blockwise online-softmax path runs."""
    aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.apply_norm(p["norm_mix"], x)
    if g.kind == "ssm":
        mix, _ = M.apply_mamba(p["ssm"], cfg, h)
    else:
        window = None if g.is_global or cfg.sliding_window is None else cfg.sliding_window
        if x.shape[1] >= L.FLASH_MIN_SEQ:
            flash = dict(causal=True, window=window, prefix_len=prefix_len)
            if cfg.mla is not None:
                mix, _ = MLA.apply_mla(p["mla"], cfg, h, positions, None, flash=flash)
            else:
                mix, _ = L.apply_attention(
                    p["attn"], cfg, h, positions, None, use_rope=cfg.rope_theta > 0, flash=flash
                )
        else:
            mask = L.attention_mask(positions, positions, causal=True, window=window, prefix_len=prefix_len)
            if cfg.mla is not None:
                mix, _ = MLA.apply_mla(p["mla"], cfg, h, positions, mask)
            else:
                mix, _ = L.apply_attention(p["attn"], cfg, h, positions, mask, use_rope=cfg.rope_theta > 0)
    x = x + mix
    if "norm_ffn" not in p:  # FFN-free block (pure mamba2)
        return x, aux_loss
    h = L.apply_norm(p["norm_ffn"], x)
    if g.has_moe:
        f, aux = MOE.apply_moe(p["moe"], cfg, h, ep_axis)
        aux_loss = aux_loss + aux["moe_aux_loss"]
    else:
        f = L.apply_ffn(p["ffn"], cfg, h)
    return x + f, aux_loss


def _run_stages_train(params, cfg, x, positions, ep_axis, remat: bool = True):
    plan = build_plan(cfg)
    prefix = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (st, sp) in enumerate(zip(plan, params["stages"])):
        for r in range(st.reps):
            for gi, (g, p_layer) in enumerate(zip(st.specs, sp)):
                if st.reps > 1:
                    p_layer = layer_of(p_layer, r)  # views: gradients reach the stacked leaf

                def blk(y, p_layer=p_layer, g=g, key=(si, r, gi)):
                    MOE.SHARD_CONTEXT["layer"] = key  # a sharded step's MoE statistics, by layer
                    return _apply_layer_train(p_layer, cfg, g, y, positions, ep_axis, prefix)

                x, a = L.remat_call(blk, x) if remat else blk(x)
                aux_total = aux_total + a
    return x, aux_total


# ---------------------------------------------------------------------------
# encoder (whisper): bidirectional, sinusoidal positions, stub frames
# ---------------------------------------------------------------------------

def _sinusoid(seq: int, d: int, dtype, device=None) -> torch.Tensor:
    return _sinusoid_of(torch.arange(seq, dtype=torch.float32, device=device), d, dtype)


def _sinusoid_of(pos: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """The rows of the sinusoid table at float32 positions ``pos`` [S]."""
    i = torch.arange(d // 2, dtype=torch.float32, device=pos.device)[None, :]
    ang = pos[:, None] / torch.pow(10000.0, 2 * i / (d // 2))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _run_encoder(params, cfg: ModelConfig, frames: torch.Tensor):
    """frames: [B, T_enc, d] stub embeddings (the conv frontend is a stub)."""
    B, T, d = frames.shape
    x = frames + _sinusoid(T, d, frames.dtype, frames.device)[None]
    positions = torch.arange(T, dtype=torch.int32, device=frames.device)[None].expand(B, T)
    # The reference passes jnp.zeros((B, T, T), float32) as the mask, which
    # jnp.where reads as all-False: every score becomes BIG_NEG and the
    # encoder's attention is the plain mean of v over all T frames.
    mask_b = torch.zeros((B, T, T), dtype=torch.bool, device=frames.device)
    enc = params["encoder"]["layers"]
    for li in range(cfg.encoder_layers):
        pp = layer_of(enc, li)
        h = L.apply_norm(pp["norm1"], x)
        mix, _ = L.apply_attention(pp["attn"], cfg, h, positions, mask_b, use_rope=False)
        y = x + mix
        h = L.apply_norm(pp["norm2"], y)
        x = y + L.apply_ffn(pp["ffn"], cfg, h)
    return L.apply_norm(params["encoder"]["final_norm"], x)


# ---------------------------------------------------------------------------
# full-sequence forward (training / prefill)
# ---------------------------------------------------------------------------

def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S_text]
    frontend_embeds: Optional[torch.Tensor] = None,  # [B, P, d] stub (vlm/audio enc)
    ep_axis: Optional[str] = "model",
    remat: bool = True,
    last_only: bool = False,  # prefill: logits for the final position only
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (logits [B, S_total, V], hidden [B, S_total, d], moe_aux)."""
    dtype = compute_dtype(cfg)
    B, S_text = tokens.shape
    x = L.embed_tokens(params["embed"], cfg, tokens, dtype)
    enc_out = None
    if cfg.frontend == "vision":
        assert frontend_embeds is not None
        x = torch.cat([frontend_embeds.to(dtype), x], dim=1)
    elif cfg.encoder_layers:
        assert frontend_embeds is not None
        enc_out = _run_encoder(params, cfg, frontend_embeds.to(dtype))
        x = x + _sinusoid(S_text, cfg.d_model, dtype, x.device)[None]
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)

    if cfg.encoder_layers:
        x, aux = _run_cross_train(params, cfg, x, positions, enc_out, remat)
    else:
        x, aux = _run_stages_train(params, cfg, x, positions, ep_axis, remat)
    x = L.apply_norm(params["final_norm"], x)
    logits = L.lm_logits(params["embed"], cfg, x[:, -1:] if last_only else x)
    return logits, x, aux


def _run_cross_train(params, cfg, x, positions, enc_out, remat: bool = True):
    """Decoder with interleaved cross-attention (whisper): one homogeneous
    stage, layer by layer with its cross block."""
    B, S, d = x.shape
    T = enc_out.shape[1]
    (st,) = build_plan(cfg)
    assert len(st.specs) == 1, "whisper decoder must be a single homogeneous stage"
    sp = params["stages"][0][0]
    kvh, hd = cfg.n_kv_heads, cfg.hd
    mask = L.attention_mask(positions, positions, causal=True)

    def blk(xx, pp, cp):
        h = L.apply_norm(pp["norm_mix"], xx)
        mix, _ = L.apply_attention(pp["attn"], cfg, h, positions, mask, use_rope=False)
        xx = xx + mix
        h = L.apply_norm(cp["norm"], xx)
        k = torch.einsum("btd,dh->bth", enc_out, cp["attn"]["wk"].to(xx.dtype))
        v = torch.einsum("btd,dh->bth", enc_out, cp["attn"]["wv"].to(xx.dtype))
        mix, _ = L.apply_attention(
            cp["attn"], cfg, h, positions, None,  # cross-attention: every encoder token visible
            kv=(k.reshape(B, T, kvh, hd), v.reshape(B, T, kvh, hd)), use_rope=False,
        )
        xx = xx + mix
        h = L.apply_norm(pp["norm_ffn"], xx)
        return xx + L.apply_ffn(pp["ffn"], cfg, h)

    for li in range(st.reps):
        pp = layer_of(sp, li) if st.reps > 1 else sp
        cp = layer_of(params["cross"], li)
        x = L.remat_call(blk, x, pp, cp) if remat else blk(x, pp, cp)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def lm_loss(
    logits: torch.Tensor,  # [B, S, V]
    labels: torch.Tensor,  # [B, S] (-100 = ignore)
    z_loss: float = 1e-4,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    valid = labels != -100
    safe = torch.where(valid, labels, 0).long()
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, safe[..., None])[..., 0]
    nll = lse - gold
    zl = z_loss * lse**2
    per_tok = torch.where(valid, nll + zl, 0.0)
    n = torch.clamp(valid.sum(dtype=torch.int32), min=1)
    loss = per_tok.sum() / n
    return loss, {"nll": torch.where(valid, nll, 0.0).sum() / n, "tokens": n}


def chunked_lm_loss(
    params: Params,
    cfg: ModelConfig,
    hidden: torch.Tensor,  # [B, S, d] (final-norm'd)
    labels: torch.Tensor,  # [B, S]
    chunk: int = 1024,
    z_loss: float = 1e-4,
    norm: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy without materialising [B, S, V] logits.

    ``norm`` (a sharded step's) divides the sums in place of this call's
    own count of valid labels: the whole microbatch's count, so that the
    data shards' losses sum to the microbatch's.

    The LM head and the softmax run a sequence chunk at a time, each chunk
    under ``layers.remat_call`` (the reference's checkpointed scan body),
    so no chunk's [B, chunk, V] logits outlive it in the forward; the
    backward recomputes them one chunk at a time.  The chunk is the largest
    divisor of S not above ``chunk``.
    """
    B, S, d = hidden.shape
    c = min(chunk, S)
    while S % c:
        c -= 1  # largest divisor <= chunk (shapes here are powers of two)

    def body(h, l):
        logits = L.mask_pad_logits(cfg, L.lm_logits(params["embed"], cfg, h)).float()
        valid = l != -100
        safe = torch.where(valid, l, 0).long()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
        nll = torch.where(valid, lse - gold, 0.0)
        zl = torch.where(valid, z_loss * lse**2, 0.0)
        return (nll + zl).sum(), nll.sum(), valid.sum(dtype=torch.int32)

    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for i in range(S // c):
        a, b, k = L.remat_call(body, hidden[:, i * c : (i + 1) * c], labels[:, i * c : (i + 1) * c])
        loss_sum, nll_sum, cnt = loss_sum + a, nll_sum + b, cnt + k
    nt = torch.clamp(cnt, min=1) if norm is None else norm
    return loss_sum / nt, {"nll": nll_sum / nt, "tokens": nt}


def train_loss(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    frontend_embeds: Optional[torch.Tensor] = None,
    ep_axis: Optional[str] = "model",
    moe_aux_weight: float = MOE_AUX_WEIGHT,
    mtp_weight: float = 0.3,
    loss_chunk: int = 1024,
    norm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss and its metrics.  ``norm`` (a sharded step's:
    the whole microbatch's counts of valid labels and of valid MTP labels)
    divides the sums in place of this call's own counts, so that the data
    shards' losses sum to the microbatch's."""
    # last_only=True: the [B, S, V] logits are never built; the loss
    # recomputes chunk logits inside chunked_lm_loss
    n_tok, n_mtp = (None, None) if norm is None else norm
    _, hidden, moe_aux = forward(params, cfg, tokens, frontend_embeds, ep_axis, last_only=True)
    hidden_text = hidden[:, cfg.frontend_tokens :] if cfg.frontend == "vision" else hidden  # text only
    loss, metrics = chunked_lm_loss(params, cfg, hidden_text, labels, loss_chunk, norm=n_tok)
    total = loss + moe_aux_weight * moe_aux
    if cfg.mtp_depth and "mtp" in params:
        total = total + mtp_weight * _mtp_loss(params, cfg, hidden, tokens, labels, norm=n_mtp)
    metrics["moe_aux"] = moe_aux
    metrics["loss"] = total
    return total, metrics


def _mtp_loss(params, cfg, hidden, tokens, labels, norm=None):
    """DeepSeek-V3 multi-token prediction (depth 1): combine h_t with
    emb(token_{t+1}) through one extra block, predict token_{t+2}."""
    mp = params["mtp"]
    dtype = hidden.dtype
    B, S, d = hidden.shape
    h = L.apply_norm(mp["norm_h"], hidden[:, :-1])
    e = L.apply_norm(mp["norm_e"], L.embed_tokens(params["embed"], cfg, tokens[:, 1:], dtype))
    x = torch.einsum("bsd,dk->bsk", torch.cat([h, e], -1), mp["proj"].to(dtype))
    positions = torch.arange(S - 1, dtype=torch.int32, device=x.device)[None].expand(B, S - 1)
    x, _ = _apply_layer_train(mp["block"], cfg, GroupSpec("attn", True, False), x, positions, None)
    x = L.apply_norm(mp["final_norm"], x)
    mtp_labels = torch.cat([labels[:, 2:], torch.full((B, 1), -100, dtype=labels.dtype, device=labels.device)], 1)
    loss, _ = chunked_lm_loss(params, cfg, x, mtp_labels, norm=norm)
    return loss


# the reference's alias for serving
group_plan = build_plan
