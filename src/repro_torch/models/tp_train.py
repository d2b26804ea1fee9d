"""Head-split tensor-parallel training: one data shard's rows of a
microbatch run over its model group, as the sharded prefill runs them
(``serving``'s head-split pieces), forward and backward.

Each model shard computes its query and KV heads (or MLA heads), its FFN
columns, its Mamba-2 heads and conv channels, its experts (the local MoE
path: ``moe.route`` plus ``experts_partial`` over the whole microbatch's
dispatch; "ep": ``moe._ep_shard``'s per-shard capacity) and its vocabulary
block of the embedding and the head.  The embedding, ``wo``, ``wd`` and
``out_proj`` end in a sum over "model".  The layout is
:func:`sharding.serve_layout`'s for a prefill, and a leaf whose blocks do
not line up with it is gathered at use, as ``serve_leaf_need`` and
``serve_leaf_access`` decide (:func:`leaf_plans`).

Every device holds its own copy of what is replicated over "model" (the
residual stream, the norms, the loss), so the boundaries between the two
regions take Megatron's pair (``core.mesh.ModelGroup``): ``to_split``
(f) before a column-split block, ``to_replicas`` (g) after a row-split
one.  Each device's loss is seeded with 1, and each replicated leaf's
gradient comes out whole and equal on every model shard.  The loss reads
the logits split by vocabulary by gathering each chunk's blocks onto every
device (``gather_to_replicas``: an ``all-gather`` forward, each device its
own block of the gradient back); the padded vocabulary stays masked.  The
embedding's gradient on each shard is ``_EmbedGatherShard``'s: the ids
outside the block dropped (PAD), then ``row_accum.from_pairs`` and
``to_dense`` over the block's rows, the ``scatter_add`` kernel on the card.

A leaf read in the split region but not as the shard's own block (a
replicated leaf a shard reads part of, a gathered leaf) gets a partial
gradient on each shard; the step sums it over "model" after the
microbatches (:class:`LeafPlan`'s ``reduce``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch import kernels
from repro_torch.core.assoc import PAD
from repro_torch.core.mesh import Mesh, ModelGroup
from repro_torch.sparse import row_accum

from . import layers as L
from . import moe as MOE
from . import serving as SV
from . import sharding as SD
from .config import ModelConfig
from .transformer import GroupSpec, _sinusoid, build_plan, compute_dtype

#: the norms: they read the replicated residual stream
NORM_KEYS = ("norm_mix", "norm_ffn", "final_norm", "norm1", "norm2", "norm", "norm_h", "norm_e")


def train_layout(cfg: ModelConfig, mesh: Mesh) -> SD.ServeLayout:
    """A prefill's layout (no cache, no "hd" split); the conv channels
    split only where the state heads do (a conv whose channels split ahead
    of heads that do not would need the gather's output replicated)."""
    lay = SD.serve_layout(cfg, mesh, 1, "prefill")
    return dataclasses.replace(lay, conv_tp=lay.conv_tp and lay.ssm_tp)


def leaf_need(lay: SD.ServeLayout, names: Tuple[str, ...], shape) -> Any:
    """``serve_leaf_need`` for training: DeepSeek-V3's MTP block reads as a
    layer does, its ``proj`` whole."""
    if names and names[0] == "mtp":
        if names[-1] == "proj":
            return "whole"
        return SD.serve_leaf_need(lay, ("stages",) + tuple(names[1:]), shape)
    return SD.serve_leaf_need(lay, names, shape)


def replicated_use(names: Tuple[str, ...], ep: bool) -> bool:
    """Whether the leaf is read by values replicated over "model" (the
    norms, MTP's ``proj``, the local path's router), so that its gradient
    is whole on every shard."""
    if len(names) >= 2 and names[-2] in NORM_KEYS:
        return True
    if names[0] == "mtp" and names[-1] == "proj":
        return True
    return names[-1] in ("router", "router_bias") and not ep


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How a head-split step reads one placed leaf and reduces its
    gradient over "model".

    * ``need``/``mode``/``gathers``: as ``serve_leaf_need``/``_access``
      (``need`` ``None``: the step does not read it).
    * ``narrow``: ``(dim, ranges)`` a shard narrows its value to, or ``None``.
    * ``reduce``: ``"none"`` (the shard's own block, or a whole gradient
      on every shard), ``"psum"`` (the shards' parts summed over "model";
      for a gathered model-split leaf each shard then keeps its block along
      ``mdim``) or ``"select"`` (a gathered leaf read whole by replicated
      values: each shard keeps its block)."""

    need: Any
    mode: Optional[str]
    gathers: Tuple[Tuple[int, Tuple[str, ...]], ...]
    narrow: Optional[Tuple[int, Tuple[Tuple[int, int], ...]]]
    reduce: str
    mdim: Optional[int]


def leaf_plans(lay: SD.ServeLayout, mesh: Mesh, named_specs, ep: bool) -> List[LeafPlan]:
    """One :class:`LeafPlan` a leaf; ``named_specs``: ``(names, shape,
    spec)`` a leaf (``shape`` the leaf's own, unpadded)."""
    tp = mesh.shape.get("model", 1)
    out = []
    for names, shape, spec in named_specs:
        shape = tuple(shape)
        nd = len(shape)
        need = leaf_need(lay, names, shape)
        if need is None:
            out.append(LeafPlan(None, None, (), None, "none", None))
            continue
        mode, gathers = SD.serve_leaf_access(mesh, spec, shape, need)
        mdim = next((d for d in range(nd) if "model" in spec.dim_axes(d) and mesh.axis_size(spec.dim_axes(d)) > 1),
                    None)
        narrow = None
        own = False
        if isinstance(need, tuple):
            dim = need[0] % nd
            own = mode == "local" and spec.dim_axes(dim) == ("model",) and tp > 1
            if not own:
                narrow = (dim, tuple(need[1]))
        if tp == 1 or own:
            red = "none"
        elif replicated_use(names, ep):
            red = "select" if mdim is not None else "none"
        else:
            red = "psum"
        out.append(LeafPlan(need, mode, tuple(gathers), narrow, red, mdim))
    return out


def gather_bases(mesh: Mesh, named, plans: Sequence[LeafPlan]) -> List[Optional[List[torch.Tensor]]]:
    """Each leaf's per-device value before the shard narrows it: its block,
    gathered over ``plan.gathers`` (counted ``all-gather``\\ s, once a step)
    and cropped to the leaf's own extent along the gathered dimensions;
    ``None`` for a leaf the step does not read."""
    out = []
    for (names, sh), lp in zip(named, plans):
        if lp.need is None:
            out.append(None)
            continue
        blocks = list(sh.shards)
        for d, axes in lp.gathers:
            blocks = mesh.all_gather(blocks, axes, dim=d)
        if sh.shape is not None and lp.gathers:
            crop = [slice(None)] * len(sh.shape)
            for d, _ in lp.gathers:
                crop[d] = slice(0, sh.shape[d])
            made = {}
            blocks = [made.setdefault(id(b), b[tuple(crop)]) for b in blocks]
        out.append(blocks)
    return out


def device_value(lp: LeafPlan, base: Optional[torch.Tensor], j: int) -> Optional[torch.Tensor]:
    """Model shard ``j``'s value of a leaf from its base."""
    if base is None or lp.narrow is None:
        return base
    dim, ranges = lp.narrow
    lo, hi = ranges[j]
    return base.narrow(dim, lo, hi - lo)


# ---------------------------------------------------------------------------
# the vocabulary-parallel embedding, its backward through scatter_add
# ---------------------------------------------------------------------------

class _EmbedGatherShard(torch.autograd.Function):
    """A vocabulary block's part of the embedding gather (rows ``[lo, lo +
    len(table))``; zeros for the ids outside it), with
    ``layers._EmbedGather``'s VJP on the block: the ids outside it become
    PAD, the rows fold by id (``row_accum.from_pairs``, in the compute
    dtype) and ``row_accum.to_dense`` writes the block's rows, the
    ``scatter_add`` kernel on the card."""

    @staticmethod
    def forward(ctx, table, tokens, lo, dtype):
        ctx.save_for_backward(tokens)
        ctx.lo, ctx.rows, ctx.table_dtype = lo, table.shape[0], table.dtype
        ctx.plain = kernels.plain_active()
        local = tokens.long() - lo
        mine = (local >= 0) & (local < table.shape[0])
        rows = table[torch.clamp(local, 0, max(table.shape[0] - 1, 0))].to(dtype)
        return torch.where(mine[..., None], rows, torch.zeros((), dtype=dtype, device=rows.device))

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        local = tokens.reshape(-1).long() - ctx.lo
        mine = (local >= 0) & (local < ctx.rows)
        ids = torch.where(mine, local, PAD).to(torch.int32)
        with kernels.plain_versions() if ctx.plain else contextlib.nullcontext():
            acc = row_accum.from_pairs(ids, g.reshape(ids.shape[0], -1), cap=ids.shape[0])
            dense = row_accum.to_dense(acc, ctx.rows)
        return dense.to(ctx.table_dtype), None, None, None


class GroupRun(SV._Run):
    """``serving._Run``'s view for one model group of a training step: its
    devices (``j`` the model shard), each device's param tree, the group's
    collectives (``mesh``: the split region's, as ``serving`` calls them;
    ``psum_model``: g; :meth:`split`: f)."""

    def __init__(self, mesh: Mesh, idx: Sequence[int], cfg: ModelConfig, lay: SD.ServeLayout, trees, ep: bool):
        self.group = self.mesh = ModelGroup(mesh, idx)
        self.cfg, self.lay = cfg, lay
        self.n = len(idx)
        self.dev = self.group.devs
        self.j = list(range(self.n))
        self.params = trees
        self.ep = ep
        self.dtype = compute_dtype(cfg)

    def psum_model(self, xs):
        return self.group.to_replicas(xs)

    def split(self, xs):
        return self.group.to_split(xs)


def _embed(run: GroupRun, toks):
    parts = [_EmbedGatherShard.apply(run.params[i]["embed"]["table"], toks[i], run.lay.vocab(run.j[i])[0], run.dtype)
             * math.sqrt(run.cfg.d_model) for i in range(run.n)]
    return run.psum_model(parts)


def _norm(run: GroupRun, ps, key: str, xs):
    return [L.apply_norm(p[key], x) for p, x in zip(ps, xs)]


def _add(xs, ys):
    return [x + y for x, y in zip(xs, ys)]


def _zeros(run: GroupRun):
    return [torch.zeros((), dtype=torch.float32, device=d) for d in run.dev]


def _moe(run: GroupRun, ps, hs):
    """An MoE FFN over the group; returns (out, each device's aux term)."""
    cfg = run.cfg
    m = cfg.moe
    E = m.n_experts
    pm = [p["moe"] for p in ps]
    stats = MOE.SHARD_CONTEXT["stats"]
    B, S, d = hs[0].shape
    T = B * S
    if run.ep:
        xf = run.split(hs)
        outs, loads = [], []
        for i in range(run.n):
            rb = pm[i].get("router_bias") if m.router_aux_free else None
            o, ld, _ = MOE._ep_shard(xf[i].reshape(T, d), pm[i]["router"], rb, pm[i]["wg"], pm[i]["wu"], pm[i]["wd"],
                                     cfg, run.j[i], run.n)
            o = o.reshape(B, S, d)
            if "shared" in pm[i]:  # the shared experts' column block
                o = o + L.apply_ffn(pm[i]["shared"], cfg, xf[i])
            outs.append(o)
            loads.append(ld)
        if stats is not None:  # summed over the data shards after the microbatch (moe.EPLoads)
            stats.record(loads)
            aux = _zeros(run)
        else:
            aux = [MOE._ep_aux(E, torch.cat([ld.to(dev) for ld in loads])) for dev in run.dev]
        return run.psum_model(outs), aux
    routed = [MOE.route(pm[i], cfg, hs[i].reshape(T, d)) for i in range(run.n)]
    aux = []
    for rt in routed:
        load, importance = rt["load"], rt["gates"].sum(0)
        if stats is not None:
            aux.append(stats.local_aux(cfg, load, importance, T))
        else:
            aux.append(E * torch.mean((load / (T * m.top_k)) * (importance / torch.clamp(importance.sum(), min=1e-9))))
    xf = run.split(hs)
    gates = run.split([rt["top_gates"] for rt in routed])
    outs = []
    for i in range(run.n):
        rt = dict(routed[i], top_gates=gates[i])
        e0, e1 = SD.ceil_ranges(E, run.lay.tp)[run.j[i]]
        offsets = None if stats is None else stats.offsets(E, run.dev[i])
        out, _ = MOE.experts_partial(pm[i], cfg, xf[i].reshape(T, d), rt, offsets, T if stats is None else stats.tokens,
                                     e0, e1)
        out = out.reshape(B, S, d)
        if "shared" in pm[i]:
            out = out + L.apply_ffn(pm[i]["shared"], cfg, xf[i])
        outs.append(out)
    return run.psum_model(outs), aux


def _mixer(run: GroupRun, pp, g: GroupSpec, xs, positions, prefix: int):
    cfg = run.cfg
    hs = _norm(run, pp, "norm_mix", xs)
    if g.kind == "ssm":
        if run.lay.ssm_tp:
            return SV._sh_mamba(run, pp, run.split(hs))
        return SV._sh_mamba(run, pp, hs)  # every shard every head: replicated, no sum
    window = None if g.is_global or cfg.sliding_window is None else cfg.sliding_window
    S = xs[0].shape[1]
    flash = mask = None
    if S >= L.FLASH_MIN_SEQ:
        flash = dict(causal=True, window=window, prefix_len=prefix)
    else:
        mask = run.same(lambda p: L.attention_mask(p, p, causal=True, window=window, prefix_len=prefix), positions)
    hf = run.split(hs)
    if cfg.mla is not None:
        return SV._sh_prefill_mla(run, pp, hf, positions, mask, flash)
    return SV._sh_prefill_attn(run, run.lay, pp, hf, positions, mask, flash, cfg.rope_theta > 0)


def _layer(run: GroupRun, pp, g: GroupSpec, xs, positions, prefix: int):
    """``transformer._apply_layer_train`` over the group: (xs, aux)."""
    xs = _add(xs, _mixer(run, pp, g, xs, positions, prefix))
    if "norm_ffn" not in pp[0]:  # FFN-free block (pure mamba2)
        return xs, _zeros(run)
    hs = _norm(run, pp, "norm_ffn", xs)
    if g.has_moe:
        f, aux = _moe(run, pp, hs)
    else:
        f, aux = SV._sh_ffn(run, pp, run.split(hs)), _zeros(run)
    return _add(xs, f), aux


def _attn(run: GroupRun, ps, hs, positions, mask, src=None, key="attn"):
    return SV._sh_prefill_attn(run, run.lay, ps, run.split(hs), positions, mask, None, False,
                               src=None if src is None else run.split(src), key=key)


def _encoder(run: GroupRun, frames):
    """Whisper's encoder (``transformer._run_encoder``) over the group."""
    cfg = run.cfg
    xs = [f + _sinusoid(f.shape[1], cfg.d_model, f.dtype, f.device)[None] for f in frames]
    positions = run.same(lambda f: torch.arange(f.shape[1], dtype=torch.int32, device=f.device)[None]
                         .expand(f.shape[0], f.shape[1]), frames)
    mask = run.same(lambda f: torch.zeros((f.shape[0], f.shape[1], f.shape[1]), dtype=torch.bool, device=f.device),
                    frames)
    for li in range(cfg.encoder_layers):
        pp = SV._stage_params(run, "encoder", "layers", r=li)
        ys = _add(xs, _attn(run, pp, _norm(run, pp, "norm1", xs), positions, mask))
        xs = _add(ys, SV._sh_ffn(run, pp, run.split(_norm(run, pp, "norm2", ys))))
    return [L.apply_norm(p["encoder"]["final_norm"], x) for p, x in zip(run.params, xs)]


def _stages(run: GroupRun, xs, positions, enc, remat: bool):
    cfg = run.cfg
    aux = _zeros(run)
    plan = build_plan(cfg)
    if cfg.encoder_layers:
        (st,) = plan
        mask = run.same(lambda p: L.attention_mask(p, p, causal=True), positions)
        for li in range(st.reps):
            pp = SV._stage_params(run, "stages", 0, 0, r=li if st.reps > 1 else None)
            cp = SV._stage_params(run, "cross", r=li)

            def blk(ys, pp=pp, cp=cp):
                ys = _add(ys, _attn(run, pp, _norm(run, pp, "norm_mix", ys), positions, mask))
                ys = _add(ys, _attn(run, cp, _norm(run, cp, "norm", ys), positions, None, src=enc))
                return _add(ys, SV._sh_ffn(run, pp, run.split(_norm(run, pp, "norm_ffn", ys))))

            xs = L.remat_call(blk, xs) if remat else blk(xs)
        return xs, aux
    prefix = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    for si, st in enumerate(plan):
        for r in range(st.reps):
            for gi, g in enumerate(st.specs):
                pp = SV._stage_params(run, "stages", si, gi, r=r if st.reps > 1 else None)

                def blk(ys, pp=pp, g=g, key=(si, r, gi)):
                    MOE.SHARD_CONTEXT["layer"] = key  # a sharded step's MoE statistics, by layer
                    return _layer(run, pp, g, ys, positions, prefix)

                xs, a = L.remat_call(blk, xs) if remat else blk(xs)
                aux = _add(aux, a)
    return xs, aux


def _vocab_loss(run: GroupRun, hs, labels, norm, chunk: int = 1024, z_loss: float = 1e-4):
    """``transformer.chunked_lm_loss`` over the group: each shard its
    vocabulary block of a chunk's logits, gathered onto every device (one
    ``all-gather`` a chunk, and again in the chunk's recompute), the loss
    on each device's copy.  Returns each device's (loss, nll)."""
    cfg = run.cfg
    B, S, _ = hs[0].shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    hf = run.split(hs)  # f: the head's input

    def body(hc, lc):
        blocks = [L.lm_logits(run.params[i]["embed"], cfg, hc[i]) for i in range(run.n)]
        full = run.group.gather_to_replicas(blocks, dim=-1)
        out = []
        for lg, lab in zip(full, lc):
            logits = L.mask_pad_logits(cfg, lg[..., :cfg.vocab_padded]).float()
            valid = lab != -100
            safe = torch.where(valid, lab, 0).long()
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, safe[..., None])[..., 0]
            nll = torch.where(valid, lse - gold, 0.0)
            zl = torch.where(valid, z_loss * lse**2, 0.0)
            out.append(torch.stack([(nll + zl).sum(), nll.sum()]))
        return out

    sums = [torch.zeros((2,), dtype=torch.float32, device=d) for d in run.dev]
    for k in range(S // c):
        part = L.remat_call(body, [h[:, k * c:(k + 1) * c] for h in hf], [lb[:, k * c:(k + 1) * c] for lb in labels])
        sums = _add(sums, part)
    return [(s[0] / n, s[1] / n) for s, n in zip(sums, norm)]


def _mtp(run: GroupRun, hidden, toks, labels, norm):
    """``transformer._mtp_loss`` over the group."""
    cfg = run.cfg
    dtype = hidden[0].dtype
    B, S, _ = hidden[0].shape
    mp = [p["mtp"] for p in run.params]
    h = [L.apply_norm(m["norm_h"], x[:, :-1]) for m, x in zip(mp, hidden)]
    e = _norm(run, mp, "norm_e", _embed(run, [t[:, 1:] for t in toks]))
    x = [torch.einsum("bsd,dk->bsk", torch.cat([a, b], -1), m["proj"].to(dtype)) for a, b, m in zip(h, e, mp)]
    positions = run.same(lambda y: torch.arange(S - 1, dtype=torch.int32, device=y.device)[None].expand(B, S - 1), x)
    x, _ = _layer(run, [m["block"] for m in mp], GroupSpec("attn", True, False), x, positions, 0)
    x = [L.apply_norm(m["final_norm"], y) for m, y in zip(mp, x)]
    mtp_labels = [torch.cat([lb[:, 2:], torch.full((B, 1), -100, dtype=lb.dtype, device=lb.device)], 1) for lb in labels]
    return [loss for loss, _ in _vocab_loss(run, x, mtp_labels, norm)]


def group_train_loss(run: GroupRun, tokens, labels, frontend, norm, aux_weight: float, mtp_weight: float = 0.3,
                     remat: bool = True):
    """``transformer.train_loss`` of one data shard's rows over its model
    group: each device's (total, nll).  ``norm`` is the whole microbatch's
    counts of valid labels and of valid MTP labels."""
    cfg = run.cfg
    dt = run.dtype
    toks = [tokens.to(d, non_blocking=True) for d in run.dev]
    labs = [labels.to(d, non_blocking=True) for d in run.dev]
    xs = _embed(run, toks)
    enc = None
    if cfg.frontend == "vision":
        xs = [torch.cat([frontend.to(d).to(dt), x], dim=1) for d, x in zip(run.dev, xs)]
    elif cfg.encoder_layers:
        enc = _encoder(run, [frontend.to(d).to(dt) for d in run.dev])
        xs = [x + _sinusoid(tokens.shape[1], cfg.d_model, dt, x.device)[None] for x in xs]
    positions = run.same(lambda x: torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None]
                         .expand(x.shape[0], x.shape[1]), xs)
    xs, aux = _stages(run, xs, positions, enc, remat)
    hidden = [L.apply_norm(p["final_norm"], x) for p, x in zip(run.params, xs)]
    text = [h[:, cfg.frontend_tokens:] for h in hidden] if cfg.frontend == "vision" else hidden
    n_tok = [norm[0].to(d) for d in run.dev]
    losses = _vocab_loss(run, text, labs, n_tok)
    totals = [loss + aux_weight * a for (loss, _), a in zip(losses, aux)]
    if cfg.mtp_depth and "mtp" in run.params[0]:
        mtp = _mtp(run, hidden, toks, labs, [norm[1].to(d) for d in run.dev])
        totals = [t + mtp_weight * m for t, m in zip(totals, mtp)]
    return totals, [nll for _, nll in losses]
