"""Serving path: single-token decode against static caches (port of
``repro.models.serving``).

Cache design (mirroring the stage plan, see ``transformer.build_plan``):

* global attention — ``(k, v)`` ``[B, S_cap, kvH, hd]`` plus a ``kpos``
  validity array; one token is written a step at slot ``pos``.
* sliding-window attention — a ring buffer of ``min(S_cap, window)``
  slots, written at ``pos % window``; ``kpos`` keeps wraparound right.
* MLA — compressed latents ``(ckv [B, S_cap, r], krope [B, S_cap, dr])``.
* SSM — ``(ssm, conv)``: O(1) in context length.
* whisper cross-attention — encoder K/V computed once at prefill.

``pos`` is a 0-d int32 tensor on the cache's device, and every slot write
is an index op on the device (no ``int(pos)`` a step), so a step never
waits on the host.  Where the reference returns fresh buffers (donated
under ``jit``), :func:`decode_step` updates the cache's buffers in place
(a stacked stage's through views of repetition ``r``) and returns a cache
over them with ``pos + 1``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device

from . import layers as L
from . import mamba as M
from . import mla as MLA
from . import moe as MOE
from .config import ModelConfig
from .transformer import GroupSpec, _run_encoder, _sinusoid_of, build_plan, compute_dtype, layer_of, tree_map

Params = Dict[str, Any]
Cache = Dict[str, Any]

# Absorbed-matmul MLA decode (see mla.apply_mla_absorbed).  Exact; default
# ON.  Set False for the naive cache up-projection.
MLA_ABSORBED = {"enabled": True}

SINUSOID_ROWS = 65536  # whisper's decoder position table


def _cache_len(cfg: ModelConfig, g: GroupSpec, s_cap: int) -> int:
    if g.kind == "attn" and not g.is_global and cfg.sliding_window:
        return min(s_cap, cfg.sliding_window)
    return s_cap


def _layer_cache(cfg: ModelConfig, g: GroupSpec, batch: int, s_cap: int, dtype, device) -> Cache:
    L_c = _cache_len(cfg, g, s_cap)
    if g.kind == "ssm":
        ssm, tail = M.init_mamba_state(cfg, batch, dtype, device)
        return {"ssm": ssm, "conv": tail}
    kpos = torch.full((batch, L_c), -1, dtype=torch.int32, device=device)
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "ckv": torch.zeros((batch, L_c, m.kv_lora_rank), dtype=dtype, device=device),
            "krope": torch.zeros((batch, L_c, m.qk_rope_dim), dtype=dtype, device=device),
            "kpos": kpos,
        }
    return {
        "k": torch.zeros((batch, L_c, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, L_c, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=device),
        "kpos": kpos,
    }


def init_cache(cfg: ModelConfig, batch: int, s_cap: int, dtype=torch.bfloat16, device=None) -> Cache:
    """The full decode cache (zeros, invalid positions), on ``device``
    (``cuda`` unless given; ``"meta"`` gives the shapes alone)."""
    dev = torch.device("meta") if device == "meta" else resolve_device(device)
    stages = []
    for st in build_plan(cfg):
        if st.reps == 1:
            stages.append(tuple(_layer_cache(cfg, g, batch, s_cap, dtype, dev) for g in st.specs))
        else:
            stages.append(tuple(
                tree_map(lambda *xs: torch.stack(xs),
                         *[_layer_cache(cfg, g, batch, s_cap, dtype, dev) for _ in range(st.reps)])
                for g in st.specs
            ))
    cache: Cache = {"stages": stages, "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.encoder_layers:
        cache["enc_kv"] = torch.zeros(
            (cfg.n_layers, 2, batch, cfg.encoder_tokens, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=dev
        )
    return cache


# ---------------------------------------------------------------------------
# single-layer decode
# ---------------------------------------------------------------------------

def _write_slot(buf: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``buf[:, slot] = new[:, 0]`` in place (``lax.dynamic_update_slice``
    at ``(0, slot, 0...)``); ``slot`` is a 0-d device tensor."""
    return buf.index_copy_(1, slot.reshape(1).long(), new.to(buf.dtype))


def _positions(pos: torch.Tensor, B: int) -> torch.Tensor:
    return pos.reshape(1, 1).expand(B, 1)


def _decode_attn(p, cfg: ModelConfig, g: GroupSpec, x, pos, c):
    """x: [B, 1, d]; pos: [] int32 (the current position).  Writes the
    token's slot of the cache ``c`` and returns the attention output."""
    B = x.shape[0]
    slot = pos % c["kpos"].shape[1]
    positions = _positions(pos, B)
    kvh, hd = cfg.n_kv_heads, cfg.hd
    use_rope = cfg.rope_theta > 0 and not cfg.encoder_layers
    a = p["attn"]
    k_new = torch.einsum("bsd,dh->bsh", x, a["wk"].to(x.dtype))
    v_new = torch.einsum("bsd,dh->bsh", x, a["wv"].to(x.dtype))
    if "bk" in a:
        k_new = k_new + a["bk"].to(x.dtype)
        v_new = v_new + a["bv"].to(x.dtype)
    k_new = k_new.reshape(B, 1, kvh, hd)
    v_new = v_new.reshape(B, 1, kvh, hd)
    if use_rope:
        k_new = L.apply_rope(k_new, positions, cfg.rope_theta)
    k = _write_slot(c["k"], slot, k_new)
    v = _write_slot(c["v"], slot, v_new)
    kpos = _write_slot(c["kpos"], slot, positions)
    ok = (kpos >= 0) & (kpos <= pos)
    if not g.is_global and cfg.sliding_window:
        ok &= kpos > pos - cfg.sliding_window
    out, _ = L.apply_attention(a, cfg, x, positions, ok[:, None, :], kv=(k, v), use_rope=use_rope)
    return out


def _decode_mla(p, cfg: ModelConfig, x, pos, c):
    B = x.shape[0]
    positions = _positions(pos, B)
    ckv_new, krope_new = MLA.mla_latents(p["mla"], cfg, x, positions)
    slot = pos % c["kpos"].shape[1]
    ckv = _write_slot(c["ckv"], slot, ckv_new)
    krope = _write_slot(c["krope"], slot, krope_new)
    kpos = _write_slot(c["kpos"], slot, positions)
    ok = (kpos >= 0) & (kpos <= pos)
    if MLA_ABSORBED["enabled"]:
        return MLA.apply_mla_absorbed(p["mla"], cfg, x, positions, ok[:, None, :], latents=(ckv, krope))
    out, _ = MLA.apply_mla(p["mla"], cfg, x, positions, ok[:, None, :], latents=(ckv, krope))
    return out


def _decode_mixer(p, cfg: ModelConfig, g: GroupSpec, x, pos, c):
    h = L.apply_norm(p["norm_mix"], x)
    if g.kind == "ssm":
        mix, (ssm, tail) = M.decode_step_mamba(p["ssm"], cfg, h, (c["ssm"], c["conv"]))
        c["ssm"].copy_(ssm)
        c["conv"].copy_(tail)
    elif cfg.mla is not None:
        mix = _decode_mla(p, cfg, h, pos, c)
    else:
        mix = _decode_attn(p, cfg, g, h, pos, c)
    return x + mix


def _decode_ffn(p, cfg: ModelConfig, g: GroupSpec, x, ep_axis):
    if "norm_ffn" not in p:  # FFN-free block (pure mamba2)
        return x
    h = L.apply_norm(p["norm_ffn"], x)
    if g.has_moe:
        f, _ = MOE.apply_moe(p["moe"], cfg, h, ep_axis)
    else:
        f = L.apply_ffn(p["ffn"], cfg, h)
    return x + f


def _decode_layer(p, cfg: ModelConfig, g: GroupSpec, x, pos, c, ep_axis):
    return _decode_ffn(p, cfg, g, _decode_mixer(p, cfg, g, x, pos, c), ep_axis)


def _decode_cross(cp, cfg, x, enc_kv):
    B = x.shape[0]
    k, v = enc_kv[0], enc_kv[1]
    positions = torch.zeros((B, 1), dtype=torch.int32, device=x.device)
    h = L.apply_norm(cp["norm"], x)
    out, _ = L.apply_attention(cp["attn"], cfg, h, positions, None, kv=(k, v), use_rope=False)
    return x + out


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def decode_step(
    params: Params,
    cfg: ModelConfig,
    cache: Cache,
    token: torch.Tensor,  # [B, 1] int
    ep_axis: Optional[str] = "model",
) -> Tuple[torch.Tensor, Cache]:
    """One decode step: returns (logits [B, 1, V], the updated cache)."""
    dtype = compute_dtype(cfg)
    pos = cache["pos"]
    x = L.embed_tokens(params["embed"], cfg, token, dtype)
    if cfg.encoder_layers:
        # lax.dynamic_slice of the 65,536-row table clamps its start: the
        # row at min(pos, 65535), computed alone
        row = torch.clamp(pos, max=SINUSOID_ROWS - 1).float().reshape(1)
        x = x + _sinusoid_of(row, cfg.d_model, dtype)[None]
    plan = build_plan(cfg)
    if cfg.encoder_layers:
        (st,) = plan
        g = st.specs[0]
        sp, sc = params["stages"][0][0], cache["stages"][0][0]
        for li in range(st.reps):  # whisper layer order: self-attn -> cross-attn -> FFN
            pp, c1 = (layer_of(sp, li), layer_of(sc, li)) if st.reps > 1 else (sp, sc)
            x = _decode_mixer(pp, cfg, g, x, pos, c1)
            x = _decode_cross(layer_of(params["cross"], li), cfg, x, cache["enc_kv"][li])
            x = _decode_ffn(pp, cfg, g, x, ep_axis)
    else:
        for st, sp, sc in zip(plan, params["stages"], cache["stages"]):
            for r in range(st.reps):
                for g, pp, c1 in zip(st.specs, sp, sc):
                    if st.reps > 1:
                        pp, c1 = layer_of(pp, r), layer_of(c1, r)
                    x = _decode_layer(pp, cfg, g, x, pos, c1, ep_axis)
    x = L.apply_norm(params["final_norm"], x)
    logits = L.lm_logits(params["embed"], cfg, x)
    new_cache: Cache = {"stages": cache["stages"], "pos": pos + 1}
    if cfg.encoder_layers:
        new_cache["enc_kv"] = cache["enc_kv"]
    return logits, new_cache


def prefill_encoder(params: Params, cfg: ModelConfig, frames: torch.Tensor, cache: Cache) -> Cache:
    """Whisper: run the encoder once and stage cross-attn K/V into the cache."""
    enc = _run_encoder(params, cfg, frames)
    B, T, d = enc.shape
    kvh, hd = cfg.n_kv_heads, cfg.hd
    kvs = []
    for li in range(cfg.n_layers):
        a = layer_of(params["cross"], li)["attn"]
        k = torch.einsum("btd,dh->bth", enc, a["wk"].to(enc.dtype)).reshape(B, T, kvh, hd)
        v = torch.einsum("btd,dh->bth", enc, a["wv"].to(enc.dtype)).reshape(B, T, kvh, hd)
        kvs.append(torch.stack([k, v]))
    cache = dict(cache)
    cache["enc_kv"] = torch.stack(kvs).to(cache["enc_kv"].dtype)
    return cache


def greedy_generate(
    params: Params,
    cfg: ModelConfig,
    prompt: torch.Tensor,  # [B, P]
    steps: int,
    s_cap: int,
    ep_axis=None,
    frontend_embeds=None,
) -> torch.Tensor:
    """Greedy decode loop (prefill by repeated decode), on the prompt's
    device; nothing waits on the host between steps."""
    B, P = prompt.shape
    dtype = compute_dtype(cfg)
    cache = init_cache(cfg, B, s_cap, dtype, prompt.device)
    if cfg.encoder_layers:
        cache = prefill_encoder(params, cfg, frontend_embeds.to(dtype), cache)
    tok = prompt[:, :1]
    outs = []
    for t in range(P + steps - 1):
        logits, cache = decode_step(params, cfg, cache, tok, ep_axis=ep_axis)
        logits = logits[..., : cfg.vocab]  # drop the TP-padding region
        # the first index of the maximum, as jnp.argmax
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        tok = prompt[:, t + 1 : t + 2] if t + 1 < P else nxt
        if t + 1 >= P:
            outs.append(nxt)
    return torch.cat(outs, dim=1) if outs else torch.zeros((B, 0), dtype=torch.int32, device=prompt.device)
