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

Sharded serving (:func:`sharded_decode_step`, :func:`sharded_prefill`,
:func:`sharded_prefill_encoder`; ``launch.steps`` dispatches to them for
params placed over a mesh) splits heads, FFN columns, experts and the
vocabulary over "model" as ``sharding.ServeLayout`` says, the batch over
the data axes, and below them the cache's slot axis over "data".
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.mesh import NamedSharding, P, Sharded
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import tree_unflatten

from . import layers as L
from . import mamba as M
from . import mla as MLA
from . import moe as MOE
from . import sharding as SD
from .config import ModelConfig
from .transformer import (ACT_CTX, GroupSpec, _run_encoder, _sinusoid, _sinusoid_of, build_plan, compute_dtype,
                          layer_of, tree_map)

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


# ---------------------------------------------------------------------------
# sharded serving: prefill and decode over a mesh, heads split over "model"
# ---------------------------------------------------------------------------
# The step runs the reference's one SPMD program layer by layer: every
# activation is a list holding one tensor a mesh device (``core.mesh``'s
# convention), each device computes its part of a layer (its data shard's
# rows, or with the slot axis split its block of the cache; its model
# shard's heads, FFN columns, experts or vocabulary block), and the
# collectives between the parts run over the whole mesh at once, counted
# once each on ``mesh.collectives``.  Values that every device of a model
# group computes alike (norms, residual adds, router logits) are computed
# once a distinct device and input and shared (``_Run.same``).

def _named(tree, names=()):
    """``(names, leaf)`` in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k], names + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _named(t, names)]
    return [(names, tree)]


def is_sharded(tree) -> bool:
    """Whether ``tree``'s leaves are placed over a mesh (``Sharded``)."""
    leaves = _named(tree)
    return bool(leaves) and isinstance(leaves[0][1], Sharded)


class _Run:
    """One sharded serve step's view of the mesh: each device's data shard,
    model shard and slot block; its param tree (the slices its shard
    reads, gathered where the placement does not line up); its rows; and
    the collectives over the model and data axes."""

    def __init__(self, params, cfg: ModelConfig, kind: str, batch: int, ep_axis):
        named = _named(params)
        self.mesh = mesh = named[0][1].sharding.mesh
        self.cfg = cfg
        self.lay = lay = SD.serve_layout(cfg, mesh, batch, kind)
        self.n = mesh.size
        self.dev = mesh.device_list
        self.j = mesh.axis_index("model")
        self.s = mesh.axis_index("data") if "data" in mesh.shape else [0] * self.n
        self.c, self.D = mesh.chunk_of(P(lay.dp))
        self.ep = ep_axis is not None and MOE.EP_CONTEXT["mesh"] is not None
        if self.ep and cfg.moe is not None and cfg.moe.n_experts % lay.tp:
            raise ValueError(f"expert parallelism splits {cfg.moe.n_experts} experts over a model axis of "
                             f"{lay.tp}: it must divide them (the reference's shard_map blocks)")
        self.dtype = compute_dtype(cfg)
        if lay.seq_shard:
            self.rows = [(0, batch)] * self.D
        else:
            b = -(-batch // self.D)
            self.rows = [(min(c * b, batch), min((c + 1) * b, batch)) for c in range(self.D)]
        # each device's param tree: what its shard reads of each leaf
        cast = ACT_CTX["cast_params"]
        vals = []
        for names, sh in named:
            shape = tuple(sh.shape) if sh.shape is not None else _padded(mesh, sh)
            need = SD.serve_leaf_need(lay, names, shape)
            if need is None:
                vals.append([None] * self.n)
                continue
            spec = sh.sharding.spec
            mode, gathers = SD.serve_leaf_access(mesh, spec, shape, need)
            blocks = list(sh.shards)
            if gathers and cast and names[0] == "stages" and blocks[0].dtype == torch.float32 \
                    and self.dtype != torch.float32:
                made: Dict[int, torch.Tensor] = {}
                blocks = [made.setdefault(id(b), b.to(self.dtype)) for b in blocks]
            for d, axes in gathers:
                blocks = mesh.all_gather(blocks, axes, dim=d)
            if sh.shape is not None and gathers:  # strip the padding of the gathered dimensions
                crop = [slice(None)] * len(shape)
                for d, _ in gathers:
                    crop[d] = slice(0, shape[d])
                made = {}
                blocks = [made.setdefault(id(b), b[tuple(crop)]) for b in blocks]
            if isinstance(need, tuple):
                dim = need[0] % len(shape)
                own = mode == "local" and spec.dim_axes(dim) == ("model",) and mesh.shape["model"] > 1
                if not own:  # the whole extent here: this shard's ranges of it
                    blocks = [b.narrow(dim, need[1][self.j[i]][0], need[1][self.j[i]][1] - need[1][self.j[i]][0])
                              for i, b in enumerate(blocks)]
            vals.append(blocks)
        self.params = [tree_unflatten(params, [v[i] for v in vals]) for i in range(self.n)]

    # -- helpers ------------------------------------------------------------
    def same(self, fn, *lists):
        """``fn(*args)`` on each device, computed once a distinct device
        and inputs and shared (values a model group computes alike)."""
        out, memo = [], {}
        for i in range(self.n):
            args = [xs[i] for xs in lists]
            key = (self.dev[i],) + tuple(id(a) for a in args)
            if key not in memo:
                memo[key] = fn(*args)
            out.append(memo[key])
        return out

    def psum_model(self, xs):
        return self.mesh.psum(xs, "model") if self.lay.tp > 1 else list(xs)

    def seq_split(self) -> bool:
        return self.lay.seq_shard and self.mesh.shape.get("data", 1) > 1

    def data_rows(self, i: int) -> Tuple[int, int]:
        return self.rows[self.c[i]]

    def local(self, x, i: int):
        """Device ``i``'s rows of a whole batch tensor (or its own block of
        a placed one, padding rows cut)."""
        lo, hi = self.data_rows(i)
        if isinstance(x, Sharded):
            if x.sharding.spec.dim_axes(0):
                return x.shards[i][: hi - lo]
            x = x.shards[i]  # the whole batch on this device
        return x[lo:hi].to(self.dev[i], non_blocking=True)


def _padded(mesh, sh) -> Tuple[int, ...]:
    spec = sh.sharding.spec
    return tuple(b * (mesh.axis_size(spec.dim_axes(d)) if spec.dim_axes(d) else 1)
                 for d, b in enumerate(sh.shards[0].shape))


def _full_len(sh, dim: int) -> int:
    """A placed leaf's own extent along ``dim`` (padding left out)."""
    if sh.shape is not None:
        return sh.shape[dim]
    spec = sh.sharding.spec
    d = dim % sh.shards[0].ndim
    axes = spec.dim_axes(d)
    return sh.shards[0].shape[d] * (sh.sharding.mesh.axis_size(axes) if axes else 1)


def _blocks(sh, r: Optional[int], run: _Run):
    """Each device's block of a placed cache leaf (repetition ``r`` of a
    stacked stage), its padding rows cut where the batch is split."""
    out = []
    for i, b in enumerate(sh.shards):
        if r is not None:
            b = b[r]
        if run.lay.batch_sharded:
            lo, hi = run.data_rows(i)
            b = b[: hi - lo]
        out.append(b)
    return out


def _write_block(run: _Run, i: int, buf: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``new`` [B, 1, ...] written at the global ``slot`` of device ``i``'s
    block of a cache leaf [B, Lb, ...]: where the slot axis is split over
    "data", only the device whose block holds the slot writes (the others
    write back what they hold); on the device, no host wait."""
    if not run.lay.seq_shard:
        return _write_slot(buf, slot, new)
    Lb = buf.shape[1]
    local = slot - run.s[i] * Lb
    owns = (local >= 0) & (local < Lb)
    idx = torch.clamp(local, 0, max(Lb - 1, 0)).reshape(1).long()
    return buf.index_copy_(1, idx, torch.where(owns, new.to(buf.dtype), buf.index_select(1, idx)))


def _slots_valid(run: _Run, i: int, Lb: int, total: int, device) -> Optional[torch.Tensor]:
    """[Lb] bool: the slots of device ``i``'s block that exist (GSPMD's
    padding of an uneven split does not), or ``None`` where all do."""
    if not run.lay.seq_shard or Lb * run.mesh.shape.get("data", 1) == total:
        return None
    return torch.arange(run.s[i] * Lb, (run.s[i] + 1) * Lb, device=device) < total


def _softmax_ctx(run: _Run, scores, vals, ctx_fn, dt):
    """The softmax over the slot axis and its weighted values, each device
    on its block of slots: where the slot axis is split over "data" as
    GSPMD partitions it (the local max, a ``pmax``; the local sums of
    exponentials, a ``psum``; the local weighted values, a ``psum``);
    otherwise the reference's ``softmax(s.float()).to(dt)``."""
    if not run.seq_split():
        return [ctx_fn(torch.softmax(s.float(), dim=-1).to(dt), v) for s, v in zip(scores, vals)]
    sf = [s.float() for s in scores]
    m = run.mesh.pmax([x.amax(-1, keepdim=True) for x in sf], "data")
    p = [torch.exp(x - mm) for x, mm in zip(sf, m)]
    den = run.mesh.psum([x.sum(-1, keepdim=True) for x in p], "data")
    return run.mesh.psum([ctx_fn((x / d).to(dt), v) for x, d, v in zip(p, den, vals)], "data")


def _sh_attention(run: _Run, ps, hs, pos, kv_fn, mask_fn, use_rope: bool, key: str = "attn"):
    """One attention sublayer against per-device K/V blocks: model shard
    ``j``'s query heads (or, under "hd", its ``head_dim`` block of every
    head) over its KV heads; the partial output summed over "model" by one
    ``psum`` after ``wo``.  ``kv_fn(i)`` returns device ``i``'s ``(k, v)``
    blocks [B, T, m, hd_b] and the first KV head they hold (writing the
    cache first), ``mask_fn(i, T)`` its [B, 1, T] mask or ``None``."""
    cfg, lay = run.cfg, run.lay
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    scores, vals, metas = [], [], []
    for i in range(run.n):
        j = run.j[i]
        a, x = ps[i][key], hs[i]
        B = x.shape[0]
        q_lo, q_hi = lay.q_heads(j)
        e0, e1 = lay.hd_block(j)
        q = L.project_heads(x, a["wq"], a.get("bq"), q_hi - q_lo, hd)
        if use_rope:
            q = L.apply_rope(q, _positions(pos[i], B), cfg.rope_theta)
        k, v, kv_lo = kv_fn(i)
        if lay.attn == "hd":
            q = q[..., e0:e1]
        qg, kk, vv = L.group_kv(q, k, v, q_lo, h, kvh, kv_lo) if q_hi > q_lo else (None, None, None)
        if qg is None:  # a shard of padding heads alone
            scores.append(torch.zeros((B, 0, 0, 1, k.shape[1]), dtype=x.dtype, device=x.device))
            vals.append(v[:, :, :0])
        else:
            scores.append(L.head_scores(qg, kk))
            vals.append(vv)
        metas.append((B, q_lo, q_hi))
    if lay.attn == "hd" and lay.tp > 1:  # the scores' sum over head_dim blocks
        scores = run.mesh.psum(scores, "model")
    scores = [L.finish_scores(cfg, s, hd, mask_fn(i, s.shape[-1])) for i, s in enumerate(scores)]
    ctx = _softmax_ctx(run, scores, vals, L.head_context, run.dtype)
    outs = []
    for i in range(run.n):
        j = run.j[i]
        a = ps[i][key]
        B, q_lo, q_hi = metas[i]
        c = ctx[i].reshape(B, 1, -1)
        wo = a["wo"]
        if lay.attn == "hd":
            e0, e1 = lay.hd_block(j)
            wo = wo.reshape(h, hd, -1)[:, e0:e1].reshape(h * (e1 - e0), -1)
        outs.append(torch.einsum("bsh,hd->bsd", c, wo.to(c.dtype)) if q_hi > q_lo
                    else torch.zeros((B, 1, cfg.d_model), dtype=hs[i].dtype, device=hs[i].device))
    return run.psum_model(outs)


def _sh_decode_attn(run: _Run, ps, g: GroupSpec, hs, pos, cache_sh: Dict[str, Any], r):
    """Self-attention decode (``_decode_attn``) on the shards: each device
    writes its token's slot into the cache block that owns it."""
    cfg, lay = run.cfg, run.lay
    hd = cfg.hd
    use_rope = cfg.rope_theta > 0 and not cfg.encoder_layers
    ks, vs, kps = (_blocks(cache_sh[n], r, run) for n in ("k", "v", "kpos"))
    total = _full_len(cache_sh["kpos"], -1)
    oks = [None] * run.n

    def kv_fn(i):
        j, x = run.j[i], hs[i]
        a = ps[i]["attn"]
        B = x.shape[0]
        p = pos[i]
        kv_lo, kv_hi = lay.kv_heads(j)
        e0, e1 = lay.hd_block(j)
        k_new = L.project_heads(x, a["wk"], a.get("bk"), kv_hi - kv_lo, hd)
        v_new = L.project_heads(x, a["wv"], a.get("bv"), kv_hi - kv_lo, hd)
        if use_rope:
            k_new = L.apply_rope(k_new, _positions(p, B), cfg.rope_theta)
        slot = p % total
        k = _write_block(run, i, ks[i], slot, k_new[..., e0:e1])
        v = _write_block(run, i, vs[i], slot, v_new[..., e0:e1])
        kpos = _write_block(run, i, kps[i], slot, _positions(p, B))
        ok = (kpos >= 0) & (kpos <= p)
        if not g.is_global and cfg.sliding_window:
            ok &= kpos > p - cfg.sliding_window
        valid = _slots_valid(run, i, kpos.shape[1], total, kpos.device)
        if valid is not None:
            ok &= valid
        oks[i] = ok[:, None, :]
        return k, v, kv_lo

    return _sh_attention(run, ps, hs, pos, kv_fn, lambda i, T: oks[i], use_rope)


def _sh_decode_cross(run: _Run, ps, hs, enc_sh, li: int):
    """Whisper's cross-attention decode (``_decode_cross``) against the
    staged ``enc_kv`` blocks."""
    lay = run.lay
    ekv = [b[li] for b in _blocks_enc(run, enc_sh)]
    total = _full_len(enc_sh, 3)
    hn = run.same(lambda p, x: L.apply_norm(p, x), [p["norm"] for p in ps], hs)

    def kv_fn(i):
        return ekv[i][0], ekv[i][1], lay.kv_heads(run.j[i])[0]

    def mask_fn(i, T):
        valid = _slots_valid(run, i, T, total, hs[i].device)
        return None if valid is None else valid[None, None, :].expand(hs[i].shape[0], 1, T)

    zero = [torch.zeros((), dtype=torch.int32, device=d) for d in run.dev]
    out = _sh_attention(run, ps, hn, zero, kv_fn, mask_fn, use_rope=False)
    return run.same(torch.add, hs, out)


def _blocks_enc(run: _Run, enc_sh):
    """``enc_kv`` [L, 2, B, T, kvh, hd] blocks, padding rows cut."""
    out = []
    for i, b in enumerate(enc_sh.shards):
        if run.lay.batch_sharded:
            lo, hi = run.data_rows(i)
            b = b[:, :, : hi - lo]
        out.append(b)
    return out


def _sh_decode_mla(run: _Run, ps, hs, pos, cache_sh, r):
    """MLA decode (``_decode_mla``), absorbed or naive as ``MLA_ABSORBED``
    picks: the latents computed alike on every model shard and written
    into its (replicated) latent cache block; each shard its heads.
    Absorbed, W_uk folds into the shard's queries and the softmax weighs
    the latents; naive, the latents are up-projected through the shard's
    columns of ``wukv`` to its heads' K and V.  Either way the shard's
    rows of ``wo``, then one ``psum`` over "model"."""
    cfg = run.cfg
    absorbed = MLA_ABSORBED["enabled"]
    ckvs, krs, kps = (_blocks(cache_sh[n], r, run) for n in ("ckv", "krope", "kpos"))
    total = _full_len(cache_sh["kpos"], -1)
    lats = run.same(lambda w, x, p: MLA.mla_latents(w, cfg, x, _positions(p, x.shape[0])),
                    [q["mla"] for q in ps], hs, pos)
    scores, vals, wuvs = [], [], []
    for i in range(run.n):
        p, x = pos[i], hs[i]
        positions = _positions(p, x.shape[0])
        slot = p % total
        ckv = _write_block(run, i, ckvs[i], slot, lats[i][0])
        kr = _write_block(run, i, krs[i], slot, lats[i][1])
        kpos = _write_block(run, i, kps[i], slot, positions)
        ok = (kpos >= 0) & (kpos <= p)
        valid = _slots_valid(run, i, kpos.shape[1], total, kpos.device)
        if valid is not None:
            ok &= valid
        h0, h1 = run.lay.mla_heads(run.j[i])
        lcfg = dataclasses.replace(cfg, n_heads=h1 - h0, n_kv_heads=max(h1 - h0, 1), head_dim=cfg.hd)
        if absorbed:
            s, wuv = MLA.absorbed_scores(ps[i]["mla"], lcfg, x, positions, (ckv, kr))
            vals.append(ckv)
            wuvs.append((lcfg, wuv))
        else:
            s, v = MLA.naive_scores(ps[i]["mla"], lcfg, x, positions, (ckv, kr))
            vals.append(v)
        scores.append(torch.where(ok[:, None, None, :], s, L.BIG_NEG))
    if not absorbed:
        ctx = _softmax_ctx(run, scores, vals, MLA.naive_context, run.dtype)
        return run.psum_model([MLA.naive_out(ps[i]["mla"], c) for i, c in enumerate(ctx)])
    ctx = _softmax_ctx(run, scores, vals, lambda pr, c: torch.einsum("bhst,btr->bshr", pr, c), run.dtype)
    return run.psum_model([MLA.absorbed_out(ps[i]["mla"], lcfg, ctx[i], wuv) for i, (lcfg, wuv) in enumerate(wuvs)])


def _sh_mamba(run: _Run, ps, hs, state=None):
    """Mamba-2 on the shards, decode (``state``: each device's ``(ssm,
    conv)`` cache blocks, written in place) or a whole sequence (prefill).
    Every shard projects with the whole ``in_proj`` (its column blocks cut
    across z | x | B | C | dt); the conv runs on the shard's channel block
    (``conv_tp``) and one ``all-gather`` over "model" joins them; the SSM
    runs the shard's state heads (``ssm_tp``), the gated norm's sum of
    squares is one ``psum`` and ``out_proj``'s rows a second.  A state
    block two replicas share (a repeated device) is written once every
    shard has read it."""
    cfg, lay = run.cfg, run.lay
    d_inner = cfg.ssm.expand * cfg.d_model
    proj = run.same(lambda p, x: M.project(p, cfg, x), [q["ssm"] for q in ps], hs)
    conv = []
    for i in range(run.n):
        p = ps[i]["ssm"]
        c0, c1 = lay.conv_channels(run.j[i])
        conv.append(M._conv_causal(proj[i][1][..., c0:c1], p["conv_w"], p["conv_b"],
                                   None if state is None else state[i][1]))
    mixed = [x for x, _ in conv]
    if lay.conv_tp and lay.tp > 1:
        mixed = run.mesh.all_gather(mixed, "model", dim=-1)
    ys, new = [], []
    for i in range(run.n):
        z, _, dt = proj[i]
        y, st = M.ssm_heads(ps[i]["ssm"], cfg, mixed[i], z, dt, lay.ssm_heads(run.j[i]),
                            None if state is None else state[i][0], step=state is not None)
        ys.append(y)
        new.append(st)
    if state is not None:
        for (ssm, tail), st, (_, t) in zip(state, new, conv):
            ssm.copy_(st)
            tail.copy_(t)
    if not (lay.ssm_tp and lay.tp > 1):
        return [M.gated_out(ps[i]["ssm"], y) for i, y in enumerate(ys)]
    # the gated norm over d_inner, its statistics summed over "model"
    ss = run.mesh.psum([(y.float() ** 2).sum(-1, keepdim=True) for y in ys], "model")
    outs = []
    for i, (y, q) in enumerate(zip(ys, ss)):
        h0, h1 = lay.ssm_heads(run.j[i])
        hd = cfg.ssm.head_dim
        p = ps[i]["ssm"]
        y = (y.float() * torch.rsqrt(q / d_inner + 1e-6) * p["out_norm"]["scale"][h0 * hd:h1 * hd]).to(y.dtype)
        outs.append(torch.einsum("bsi,id->bsd", y, p["out_proj"].to(y.dtype)))
    return run.psum_model(outs)


def _sh_ffn(run: _Run, ps, hs, key: str = "ffn"):
    """A dense FFN on the shards: each its column block of ``wg``/``wu``
    and rows of ``wd``, one ``psum`` over "model"."""
    return run.psum_model([L.apply_ffn(ps[i][key], run.cfg, hs[i]) for i in range(run.n)])


def _sh_moe(run: _Run, ps, hs):
    """An MoE FFN on the shards: each model shard its block of experts
    (and of the shared experts' columns), one ``psum`` over "model".  On
    the local path the dispatch is the reference's global one: each data
    shard ranks its assignments after the earlier shards' (their loads, an
    ``all-gather`` over the data axes) with the capacity of the whole
    batch; on the expert-parallel path (``EP_CONTEXT``) each data shard
    dispatches alone (``apply_moe_shardmap``)."""
    cfg, lay = run.cfg, run.lay
    m = cfg.moe
    E = m.n_experts
    pm = [p["moe"] for p in ps]
    outs = []
    if run.ep:
        for i in range(run.n):
            x = hs[i]
            B, S, d = x.shape
            rb = pm[i].get("router_bias") if m.router_aux_free else None
            o, _, _ = MOE._ep_shard(x.reshape(B * S, d), pm[i]["router"], rb, pm[i]["wg"], pm[i]["wu"],
                                    pm[i]["wd"], cfg, run.j[i], lay.tp)
            outs.append(o.reshape(B, S, d))
    else:
        routed = run.same(lambda p, x: MOE.route(p, cfg, x.reshape(-1, x.shape[-1])), pm, hs)
        loads = [rt["load"][None] for rt in routed]
        split = lay.batch_sharded and run.D > 1
        if split:
            loads = run.mesh.all_gather(loads, lay.dp, dim=0)
        for i in range(run.n):
            x = hs[i]
            B, S, d = x.shape
            rt = routed[i]
            c = run.c[i] if split else 0
            offsets = loads[i][:c].sum(0) if split else None
            total = int(sum(hi - lo for lo, hi in run.rows)) * S if split else B * S
            e0, e1 = SD.ceil_ranges(E, lay.tp)[run.j[i]]
            out, _ = MOE.experts_partial(pm[i], cfg, x.reshape(B * S, d), rt, offsets, total, e0, e1)
            outs.append(out.reshape(B, S, d))
    if "shared" in pm[0]:
        outs = [o + L.apply_ffn(pm[i]["shared"], cfg, hs[i]) for i, o in enumerate(outs)]
    return run.psum_model(outs)


def _layer(tree, r: Optional[int]):
    """Repetition ``r`` of a stacked layer tree (``None``: the tree);
    leaves a step does not read stay ``None``."""
    if r is None:
        return tree
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return None if tree is None else tree[r]


def _stage_params(run: _Run, *path, r=None):
    out = []
    for i in range(run.n):
        t = run.params[i]
        for k in path:
            t = t[k]
        out.append(_layer(t, r))
    return out


def _norm(run: _Run, ps, key: str, xs):
    return run.same(lambda p, x: L.apply_norm(p, x), [p[key] for p in ps], xs)


def _embed(run: _Run, toks):
    """The vocabulary-parallel embedding: each model shard its block of
    the table's rows, one ``psum`` over "model"."""
    parts = [L.embed_tokens_shard(run.params[i]["embed"]["table"], run.cfg, toks[i], run.dtype,
                                  run.lay.vocab(run.j[i])[0]) for i in range(run.n)]
    return run.psum_model(parts)


def _logits(run: _Run, xs):
    """Each model shard's vocabulary block of the logits (``lm_logits``
    on its block of the table's rows or the head's columns; the padded
    region unmasked, as the reference's prefill and decode leave it),
    placed as the reference's out_shardings place them: ``P(dp, None,
    "model")`` (the batch over the data axes) or ``P(None, None,
    "model")``."""
    lay = run.lay
    vb = -(-run.cfg.vocab_padded // lay.tp)
    rb = run.rows[0][1] - run.rows[0][0]
    parts = []
    for i in range(run.n):
        lg = L.lm_logits(run.params[i]["embed"], run.cfg, xs[i])
        pad_v, pad_r = vb - lg.shape[-1], rb - lg.shape[0]
        if pad_v or pad_r:
            lg = F.pad(lg, [0, pad_v, 0, 0, 0, pad_r])
        parts.append(lg)
    spec = P(lay.dp if len(lay.dp) > 1 else lay.dp[0], None, "model") if lay.batch_sharded else P(None, None, "model")
    full = (lay.batch, xs[0].shape[1], run.cfg.vocab_padded)
    even = rb * (run.D if lay.batch_sharded else 1) == lay.batch and vb * lay.tp == run.cfg.vocab_padded
    return Sharded(NamedSharding(run.mesh, spec), tuple(parts), None if even else full)


def _sh_decode_layer(run: _Run, pp, g: GroupSpec, xs, pos, c_sh, r, ep_axis, cross=None):
    hs = _norm(run, pp, "norm_mix", xs)
    if g.kind == "ssm":
        state = list(zip(_blocks(c_sh["ssm"], r, run), _blocks(c_sh["conv"], r, run)))
        mix = _sh_mamba(run, pp, hs, state)
    elif run.cfg.mla is not None:
        mix = _sh_decode_mla(run, pp, hs, pos, c_sh, r)
    else:
        mix = _sh_decode_attn(run, pp, g, hs, pos, c_sh, r)
    xs = run.same(torch.add, xs, mix)
    if cross is not None:  # whisper: self-attn -> cross-attn -> FFN
        xs = _sh_decode_cross(run, cross[0], xs, cross[1], cross[2])
    return _sh_ffn_block(run, pp, g, xs)


def _sh_ffn_block(run: _Run, pp, g: GroupSpec, xs):
    if "norm_ffn" not in pp[0]:  # FFN-free block (pure mamba2)
        return xs
    hs = _norm(run, pp, "norm_ffn", xs)
    f = _sh_moe(run, pp, hs) if g.has_moe else _sh_ffn(run, pp, hs)
    return run.same(torch.add, xs, f)


def sharded_decode_step(params, cfg: ModelConfig, cache, token, ep_axis: Optional[str] = "model"):
    """:func:`decode_step` over the mesh ``params`` are placed on
    (``sharding.param_specs``), against a cache placed by
    ``sharding.cache_specs``; ``token`` [B, 1] whole or placed.  Returns
    (logits [B, 1, V] vocabulary-sharded over "model", the cache with
    ``pos + 1``); the cache's blocks are written in place.

    Each layer: the norms alike on every model shard; attention on the
    shard's heads (or ``head_dim`` block) against its cache block, the
    token's slot written by the block that owns it, one ``psum`` over
    "model" after ``wo``; where the slot axis is split over "data" the
    softmax combines over it (a ``pmax`` and two ``psum``\\ s); the FFN's
    column block and one ``psum`` after ``wd``; MoE experts as
    :func:`_sh_moe`; Mamba-2 as :func:`_sh_mamba`.  The embedding and the
    head are vocabulary-parallel.  ``launch.dryrun.serve_collectives`` is
    this schedule as a formula."""
    batch = token.shape[0] if not isinstance(token, Sharded) else _full_len(token, 0)
    run = _Run(params, cfg, "decode", batch, ep_axis)
    pos = list(cache["pos"].shards)
    toks = [run.local(token, i) for i in range(run.n)]
    xs = _embed(run, toks)
    if cfg.encoder_layers:
        xs = run.same(lambda x, p: x + _sinusoid_of(torch.clamp(p, max=SINUSOID_ROWS - 1).float().reshape(1),
                                                     cfg.d_model, x.dtype)[None], xs, pos)
    plan = build_plan(cfg)
    for si, st in enumerate(plan):
        for r in range(st.reps):
            for gi, g in enumerate(st.specs):
                rr = r if st.reps > 1 else None
                pp = _stage_params(run, "stages", si, gi, r=rr)
                cross = None
                if cfg.encoder_layers:
                    cross = (_stage_params(run, "cross", r=r), cache["enc_kv"], r)
                xs = _sh_decode_layer(run, pp, g, xs, pos, cache["stages"][si][gi], rr, ep_axis, cross)
    xs = run.same(lambda p, x: L.apply_norm(p, x), [p["final_norm"] for p in run.params], xs)
    logits = _logits(run, xs)
    new_pos = Sharded(cache["pos"].sharding, tuple(run.same(lambda p: p + 1, pos)), cache["pos"].shape)
    new_cache = {"stages": cache["stages"], "pos": new_pos}
    if cfg.encoder_layers:
        new_cache["enc_kv"] = cache["enc_kv"]
    return logits, new_cache


# ---- prefill (the full sequence, last-position logits) ---------------------

def _sh_prefill_attn(run: _Run, lay, ps, hs, positions, mask, flash, use_rope: bool, src=None, key="attn"):
    """Attention over the whole sequence on each model shard's query heads
    and the KV heads they read (``src``: the encoder output a
    cross-attention reads, else ``hs``), the blockwise path where
    ``flash``; one ``psum`` over "model" after ``wo``."""
    cfg = run.cfg
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    outs = []
    for i in range(run.n):
        j, x = run.j[i], hs[i]
        a = ps[i][key]
        B, S, _ = x.shape
        q_lo, q_hi = lay.q_heads(j)
        kv_lo, kv_hi = lay.kv_heads(j)
        if q_hi <= q_lo:
            outs.append(torch.zeros_like(x))
            continue
        kx = x if src is None else src[i]
        q = L.project_heads(x, a["wq"], a.get("bq"), q_hi - q_lo, hd)
        k = L.project_heads(kx, a["wk"], a.get("bk"), kv_hi - kv_lo, hd)
        v = L.project_heads(kx, a["wv"], a.get("bv"), kv_hi - kv_lo, hd)
        if use_rope:
            k = L.apply_rope(k, positions[i], cfg.rope_theta)
            q = L.apply_rope(q, positions[i], cfg.rope_theta)
        qg, kk, vv = L.group_kv(q, k, v, q_lo, h, kvh, kv_lo)
        if flash is not None:
            ctx = L.flash_attention(qg, kk, vv, positions[i], positions[i], scale=1.0 / math.sqrt(hd),
                                    softcap=cfg.logit_softcap, **flash)
        else:
            s = L.finish_scores(cfg, L.head_scores(qg, kk), hd, None if mask is None else mask[i])
            ctx = L.head_context(torch.softmax(s.float(), dim=-1).to(x.dtype), vv)
        ctx = ctx.reshape(B, S, (q_hi - q_lo) * hd)
        outs.append(torch.einsum("bsh,hd->bsd", ctx, a["wo"].to(x.dtype)))
    return run.psum_model(outs)


def _sh_prefill_mla(run: _Run, ps, hs, positions, mask, flash):
    cfg = run.cfg
    outs = []
    for i in range(run.n):
        h0, h1 = run.lay.mla_heads(run.j[i])
        if h1 <= h0 or hs[i].shape[0] == 0:  # padding heads alone, or a data shard of padding rows alone
            outs.append(torch.zeros_like(hs[i]))
            continue
        lcfg = dataclasses.replace(cfg, n_heads=h1 - h0, n_kv_heads=h1 - h0, head_dim=cfg.hd)
        out, _ = MLA.apply_mla(ps[i]["mla"], lcfg, hs[i], positions[i], None if mask is None else mask[i],
                               flash=flash)
        outs.append(out)
    return run.psum_model(outs)


def _sh_prefill_layer(run: _Run, pp, g: GroupSpec, xs, positions, prefix: int):
    """``transformer._apply_layer_train`` on the shards."""
    cfg = run.cfg
    hs = _norm(run, pp, "norm_mix", xs)
    if g.kind == "ssm":
        mix = _sh_mamba(run, pp, hs)
    else:
        window = None if g.is_global or cfg.sliding_window is None else cfg.sliding_window
        S = xs[0].shape[1]
        flash = mask = None
        if S >= L.FLASH_MIN_SEQ:
            flash = dict(causal=True, window=window, prefix_len=prefix)
        else:
            mask = run.same(lambda p: L.attention_mask(p, p, causal=True, window=window, prefix_len=prefix),
                            positions)
        if cfg.mla is not None:
            mix = _sh_prefill_mla(run, pp, hs, positions, mask, flash)
        else:
            mix = _sh_prefill_attn(run, run.lay, pp, hs, positions, mask, flash, cfg.rope_theta > 0)
    xs = run.same(torch.add, xs, mix)
    return _sh_ffn_block(run, pp, g, xs)


def _sh_encoder(run: _Run, frames):
    """Whisper's encoder (``transformer._run_encoder``) on the shards:
    heads as a prefill splits them, every score masked (the reference's
    all-False mask: each query the mean of v)."""
    cfg = run.cfg
    lay = run.lay.prefill()
    xs = run.same(lambda f: f + _sinusoid(f.shape[1], cfg.d_model, f.dtype, f.device)[None], frames)
    positions = run.same(lambda f: torch.arange(f.shape[1], dtype=torch.int32, device=f.device)[None]
                         .expand(f.shape[0], f.shape[1]), frames)
    mask = run.same(lambda f: torch.zeros((f.shape[0], f.shape[1], f.shape[1]), dtype=torch.bool, device=f.device),
                    frames)
    for li in range(cfg.encoder_layers):
        pp = _stage_params(run, "encoder", "layers", r=li)
        hs = _norm(run, pp, "norm1", xs)
        ys = run.same(torch.add, xs, _sh_prefill_attn(run, lay, pp, hs, positions, mask, None, False))
        hs = _norm(run, pp, "norm2", ys)
        xs = run.same(torch.add, ys, _sh_ffn(run, pp, hs))
    return run.same(lambda p, x: L.apply_norm(p, x), [p["encoder"]["final_norm"] for p in run.params], xs)


def sharded_prefill(params, cfg: ModelConfig, tokens, frontend=None, ep_axis: Optional[str] = "model"):
    """``transformer.forward(..., last_only=True)``'s logits over the mesh
    ``params`` are placed on: the batch over the data axes, heads split
    over "model" (:class:`sharding.ServeLayout`), the last position's
    logits vocabulary-sharded over "model"."""
    batch = tokens.shape[0] if not isinstance(tokens, Sharded) else _full_len(tokens, 0)
    run = _Run(params, cfg, "prefill", batch, ep_axis)
    toks = [run.local(tokens, i) for i in range(run.n)]
    fes = None if frontend is None else [run.local(frontend, i).to(run.dtype) for i in range(run.n)]
    xs = _embed(run, toks)
    S_text = toks[0].shape[1]
    enc = None
    if cfg.frontend == "vision":
        xs = run.same(lambda f, x: torch.cat([f, x], dim=1), fes, xs)
    elif cfg.encoder_layers:
        enc = _sh_encoder(run, fes)
        xs = run.same(lambda x: x + _sinusoid(S_text, cfg.d_model, x.dtype, x.device)[None], xs)
    positions = run.same(lambda x: torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None]
                         .expand(x.shape[0], x.shape[1]), xs)
    plan = build_plan(cfg)
    if cfg.encoder_layers:
        (st,) = plan
        mask = run.same(lambda p: L.attention_mask(p, p, causal=True), positions)
        lay = run.lay
        for li in range(st.reps):
            pp = _stage_params(run, "stages", 0, 0, r=li if st.reps > 1 else None)
            cp = _stage_params(run, "cross", r=li)
            hs = _norm(run, pp, "norm_mix", xs)
            xs = run.same(torch.add, xs, _sh_prefill_attn(run, lay, pp, hs, positions, mask, None, False))
            hs = _norm(run, cp, "norm", xs)
            xs = run.same(torch.add, xs, _sh_prefill_attn(run, lay, cp, hs, positions, None, None, False, src=enc))
            hs = _norm(run, pp, "norm_ffn", xs)
            xs = run.same(torch.add, xs, _sh_ffn(run, pp, hs))
    else:
        prefix = cfg.frontend_tokens if cfg.frontend == "vision" else 0
        for si, st in enumerate(plan):
            for r in range(st.reps):
                for gi, g in enumerate(st.specs):
                    pp = _stage_params(run, "stages", si, gi, r=r if st.reps > 1 else None)
                    xs = _sh_prefill_layer(run, pp, g, xs, positions, prefix)
    xs = run.same(lambda p, x: L.apply_norm(p, x[:, -1:]), [p["final_norm"] for p in run.params], xs)
    return _logits(run, xs)


def sharded_prefill_encoder(params, cfg: ModelConfig, frames, cache):
    """:func:`prefill_encoder` over the mesh: the encoder on the shards,
    then each device's block of ``enc_kv`` (its rows, or where the batch
    is below the data axes its block of encoder tokens; its KV heads or
    ``head_dim`` block) written in place."""
    enc_sh = cache["enc_kv"]
    batch = _full_len(enc_sh, 2)
    run = _Run(params, cfg, "encoder", batch, None)
    lay = run.lay
    fes = [run.local(frames, i).to(run.dtype) for i in range(run.n)]
    enc = _sh_encoder(run, fes)
    blocks = _blocks_enc(run, enc_sh)
    for i in range(run.n):
        j = run.j[i]
        kv_lo, kv_hi = lay.kv_heads(j)
        e0, e1 = lay.hd_block(j)
        blk = blocks[i]
        Tb = blk.shape[3]
        t0 = run.s[i] * Tb if lay.seq_shard else 0
        x = enc[i][:, t0:t0 + Tb]
        for li in range(cfg.n_layers):
            a = _layer(run.params[i]["cross"], li)["attn"]
            k = L.project_heads(x, a["wk"], None, kv_hi - kv_lo, cfg.hd)[..., e0:e1]
            v = L.project_heads(x, a["wv"], None, kv_hi - kv_lo, cfg.hd)[..., e0:e1]
            blk[li, 0, :, : k.shape[1]].copy_(k)
            blk[li, 1, :, : v.shape[1]].copy_(v)
    return cache
