"""Mixture-of-Experts layer with sort-based token dispatch (port of the
local path of ``repro.models.moe``).

Router logits -> top-k experts a token; the ``T*k`` assignments are ranked
within their expert by a stable argsort, those under capacity are written
into an ``[E, C, d]`` buffer, the expert FFNs run as grouped einsums, and
each token gathers its k outputs weighted by its router gates.  Dropped
tokens (over capacity) contribute zero and are counted in the aux
telemetry.  Router load statistics come out as associative-array triples
(:func:`router_stats_triples`).

With ``EP_CONTEXT``'s mesh set, :func:`apply_moe` runs the expert-parallel
path (:func:`apply_moe_shardmap`, the reference's ``shard_map``): every
model shard sees its data shard's tokens, ranks only the assignments to its
``E / tp`` local experts, runs them, and one ``psum`` over ``model``
combines the outputs.  A sharded train step (``launch.steps``) runs one data
shard at a time.  What the reference reads across data shards within one
program travels as follows: on the local path, :class:`ShardStats` carries
the global dispatch order and the aux loss' statistics from a first,
gradient-free pass over the shards; on the expert-parallel path,
:class:`EPLoads` keeps each shard's load and sums it over the data axes
after the microbatch's one pass.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import mesh as MESH
from repro_torch.core.mesh import axis_tuple

from .config import ModelConfig, MoEConfig
from .layers import _dense_init

Params = Dict[str, Any]

#: set by a launcher: the mesh of the expert-parallel path, its data axes,
#: and (inside a sharded step) the flat mesh indices of the model group of
#: the data shard that runs
EP_CONTEXT = {"mesh": None, "dp": None, "group": None}
#: set by a sharded step: the microbatch's cross-shard statistics (a
#: :class:`ShardStats` on the local path, an :class:`EPLoads` on the
#: expert-parallel one), and (by ``transformer``'s layer loop, a
#: checkpointed layer's recompute included) the layer that runs
SHARD_CONTEXT = {"stats": None, "layer": None}


def init_moe(gen, cfg: ModelConfig, device) -> Params:
    m = cfg.moe
    d, f = cfg.d_model, m.d_expert
    p = {
        "router": _dense_init(gen, (d, m.n_experts), device),
        "wg": _dense_init(gen, (m.n_experts, d, f), device),
        "wu": _dense_init(gen, (m.n_experts, d, f), device),
        "wd": _dense_init(gen, (m.n_experts, f, d), device),
    }
    if m.n_shared:
        p["shared"] = {
            "wg": _dense_init(gen, (d, m.n_shared * f), device),
            "wu": _dense_init(gen, (d, m.n_shared * f), device),
            "wd": _dense_init(gen, (m.n_shared * f, d), device),
        }
    if m.router_aux_free:
        p["router_bias"] = torch.zeros((m.n_experts,), device=device)
    return p


def _capacity(m: MoEConfig, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(8, ((c + 7) // 8) * 8)  # pad to vector-lane multiple


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: ties keep the lower index first
    (a stable descending sort; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, S, d]
    ep_axis: Optional[str] = "model",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (out [B, S, d], aux telemetry dict)."""
    if ep_axis is not None and EP_CONTEXT["mesh"] is not None:
        return apply_moe_shardmap(p, cfg, x, ep_axis)
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    xt = x.reshape(T, d)
    rt = route(p, cfg, xt)

    # ---- dispatch: rank within expert, drop over capacity; the experts
    stats = SHARD_CONTEXT["stats"]
    # the data shards before this one came first in the global order
    offsets = None if stats is None else stats.offsets(E, x.device)
    out, keep = experts_partial(p, cfg, xt, rt, offsets, T if stats is None else stats.tokens, 0, E)
    gates = rt["gates"]

    # ---- shared experts (always-on dense path)
    if "shared" in p:
        s = p["shared"]
        sg = F.silu(torch.einsum("td,df->tf", xt, s["wg"].to(x.dtype)))
        su = torch.einsum("td,df->tf", xt, s["wu"].to(x.dtype))
        out = out + torch.einsum("tf,fd->td", sg * su, s["wd"].to(x.dtype))

    # ---- telemetry: streaming load stats as associative-array triples
    load = rt["load"]
    importance = gates.sum(0)
    if stats is not None:
        aux_loss = stats.local_aux(cfg, load, importance, T)
    else:
        # Switch-style aux loss (used when not aux-free)
        aux_loss = E * torch.mean((load / (T * k)) * (importance / torch.clamp(importance.sum(), min=1e-9)))
    dropped = (T * k) - keep.sum()
    aux = {
        "expert_load": load,
        "moe_aux_loss": aux_loss,
        "moe_dropped": dropped.to(torch.int32),
    }
    return out.reshape(B, S, d), aux


def route(p: Params, cfg: ModelConfig, xt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Router logits -> top-k experts a token [T, d]: the gates, the
    chosen experts and their normalised gates [T, k], each assignment's
    rank among this call's assignments to its expert (token-major), and
    the load (assignments an expert, float32 [E])."""
    m = cfg.moe
    logits = torch.einsum("td,de->te", xt, p["router"].to(xt.dtype))
    logits = logits.float() * m.router_scale
    gates = torch.softmax(logits, dim=-1)
    select_scores = logits + p["router_bias"] if m.router_aux_free else logits
    _, top_idx = top_k(select_scores, m.top_k)  # [T, k]
    top_gates = torch.gather(gates, 1, top_idx)  # [T, k]
    top_gates = top_gates / (top_gates.sum(-1, keepdim=True) + 1e-9)
    load = torch.zeros((m.n_experts,), dtype=torch.float32, device=xt.device)
    ones = torch.ones((xt.shape[0],), dtype=torch.float32, device=xt.device)
    for kk in range(m.top_k):  # expert ids are always in range: nothing to drop
        load.index_add_(0, top_idx[:, kk], ones)
    return {"gates": gates, "top_idx": top_idx, "top_gates": top_gates, "rank": _rank_in_expert(top_idx),
            "load": load}


def experts_partial(p: Params, cfg: ModelConfig, xt: torch.Tensor, rt: Dict[str, torch.Tensor],
                    offsets: Optional[torch.Tensor], tokens: int, e0: int, e1: int):
    """The routed experts ``[e0, e1)``'s share of the output [T, d] (the
    whole output for ``[0, E)``), and which assignments are kept [T, k].

    ``p``'s expert weights hold those experts first (a model shard's
    block, or all of them); ``offsets`` [E] counts the assignments made by
    tokens earlier in the global order (other data shards'); ``tokens`` is
    the global count the capacity is drawn from.  Under capacity the
    assignments are written into an ``[E, C, d]`` buffer, the expert FFNs
    run as grouped einsums, and each token gathers its outputs weighted by
    its gates; dropped assignments contribute zero."""
    m = cfg.moe
    T, d = xt.shape
    ne = e1 - e0
    C = _capacity(m, tokens)
    top_idx = rt["top_idx"]
    rank = rt["rank"]
    if offsets is not None:
        rank = rank + offsets.long()[top_idx]
    keep = rank < C  # [T, k]
    out = torch.zeros((T, d), dtype=xt.dtype, device=xt.device)
    if ne <= 0:
        return out, keep
    mine = keep if (e0, e1) == (0, m.n_experts) else keep & (top_idx >= e0) & (top_idx < e1)
    slot = torch.where(mine, (top_idx - e0) * C + rank, ne * C)  # a drop -> out of range

    # The reference's .at[slot].set(xt, mode="drop") drops out-of-range
    # slots; here they land in one extra row that is cut off (an index out
    # of range is an error in torch, and masking by a boolean index would
    # wait on the host)
    buf = torch.zeros((ne * C + 1, d), dtype=xt.dtype, device=xt.device)
    for kk in range(m.top_k):  # each token is written to up to k expert slots
        buf.index_copy_(0, slot[:, kk], xt)
    buf = buf[: ne * C].reshape(ne, C, d)

    # ---- expert FFN (grouped einsum)
    g = F.silu(torch.einsum("ecd,edf->ecf", buf, p["wg"][:ne].to(xt.dtype)))
    u = torch.einsum("ecd,edf->ecf", buf, p["wu"][:ne].to(xt.dtype))
    eo = torch.einsum("ecf,efd->ecd", g * u, p["wd"][:ne].to(xt.dtype)).reshape(ne * C, d)

    # ---- combine
    for kk in range(m.top_k):
        safe = torch.clamp(slot[:, kk], max=ne * C - 1)
        contrib = eo[safe] * rt["top_gates"][:, kk : kk + 1].to(xt.dtype)
        out = out + torch.where(mine[:, kk : kk + 1], contrib, 0)
    return out, keep


def router_stats_triples(load: torch.Tensor, layer_idx: int):
    """Per-step expert load as (row=layer, col=expert, val=count) triples
    for the hierarchical associative-array telemetry stream."""
    e = load.shape[0]
    rows = torch.full((e,), layer_idx, dtype=torch.int32, device=load.device)
    cols = torch.arange(e, dtype=torch.int32, device=load.device)
    return rows, cols, load


def update_aux_free_bias(bias: torch.Tensor, load: torch.Tensor, lr: float = 1e-3) -> torch.Tensor:
    """DeepSeek-v3 aux-free balancing: nudge under-loaded experts up,
    over-loaded down (sign update on the violation)."""
    mean = load.mean()
    return bias + lr * torch.sign(mean - load)


def _rank_in_expert(top_idx: torch.Tensor) -> torch.Tensor:
    """Each assignment's rank among the assignments to its expert, in
    token-major order (the reference's stable argsort and searchsorted)."""
    T, k = top_idx.shape
    flat = top_idx.reshape(T * k)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    arange_a = torch.arange(T * k, dtype=torch.int64, device=flat.device)
    run_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    return torch.empty_like(arange_a).index_copy_(0, order, arange_a - run_start).reshape(T, k)


# ---------------------------------------------------------------------------
# shard_map expert parallelism
# ---------------------------------------------------------------------------
# The local dispatch above sorts the whole [T*k] assignment vector.  The EP
# path below routes locally: every model shard sees its data shard's tokens
# (replicated over "model"), ranks only the assignments destined to ITS
# E/tp experts, runs its local expert FFNs, and a single psum over "model"
# combines contributions.


def _group_psum(parts: Sequence[torch.Tensor], mesh) -> torch.Tensor:
    """The sum of one tensor a model shard, in shard order, on the first
    shard's device: ``lax.psum`` over one model group (``mesh.sum_to_one``,
    Megatron's g), counted as one ``all-reduce`` on ``mesh`` each time it
    runs; its backward hands each shard the gradient unchanged.  In a
    checkpointed layer it runs once: the combine saves no tensor for the
    backward and is the layer's last work, and the recompute in the
    backward stops once the saved tensors are rebuilt
    (``torch.utils.checkpoint``'s early stop)."""
    return MESH.sum_to_one(mesh, parts)


def _ep_aux(n_experts: int, load: torch.Tensor) -> torch.Tensor:
    """The expert-parallel path's aux proxy from the load over the data
    axes (no gradient: the load counts assignments)."""
    importance = load / torch.clamp(load.sum(), min=1.0)
    return n_experts * torch.mean(importance * importance)


def _ep_shard(xt, router, router_bias, wg, wu, wd, cfg: ModelConfig, index: int, size: int):
    """Model shard ``index`` of ``size``: its partial output [T, d] (only
    its experts' contributions), its experts' load and its dropped count."""
    m = cfg.moe
    T, d = xt.shape
    E_local = m.n_experts // size
    my_lo = index * E_local
    logits = torch.einsum("td,de->te", xt, router.to(xt.dtype)).float() * m.router_scale
    gates = torch.softmax(logits, dim=-1)
    select = logits + router_bias if router_bias is not None else logits
    _, top_idx = top_k(select, m.top_k)
    top_gates = torch.gather(gates, 1, top_idx)
    top_gates = top_gates / (top_gates.sum(-1, keepdim=True) + 1e-9)

    C = _capacity(m, T)
    mine = (top_idx >= my_lo) & (top_idx < my_lo + E_local)  # [T, k]
    local_e = torch.where(mine, top_idx - my_lo, E_local)
    rank = _rank_in_expert(local_e)
    keep = mine & (rank < C)
    slot = torch.where(keep, local_e * C + rank, E_local * C)

    # out-of-range slots land in one extra row that is cut off (the
    # reference's mode="drop")
    buf = torch.zeros((E_local * C + 1, d), dtype=xt.dtype, device=xt.device)
    for kk in range(m.top_k):
        buf.index_copy_(0, slot[:, kk], xt)
    buf = buf[: E_local * C].reshape(E_local, C, d)
    g = F.silu(torch.einsum("ecd,edf->ecf", buf, wg.to(xt.dtype)))
    u = torch.einsum("ecd,edf->ecf", buf, wu.to(xt.dtype))
    eo = torch.einsum("ecf,efd->ecd", g * u, wd.to(xt.dtype)).reshape(E_local * C, d)

    out = torch.zeros((T, d), dtype=xt.dtype, device=xt.device)
    for kk in range(m.top_k):
        safe = torch.clamp(slot[:, kk], max=E_local * C - 1)
        contrib = eo[safe] * top_gates[:, kk : kk + 1].to(xt.dtype)
        out = out + torch.where(keep[:, kk : kk + 1], contrib, 0)

    load_local = torch.zeros((E_local + 1,), dtype=torch.float32, device=xt.device)
    ones = torch.ones((T,), dtype=torch.float32, device=xt.device)
    for kk in range(m.top_k):
        load_local.index_add_(0, local_e[:, kk], ones)
    dropped = ((~keep) & mine).sum()
    return out, load_local[:E_local], dropped


def apply_moe_ep_local(
    xt: torch.Tensor,  # [T, d] a data shard's tokens (replicated across the ep axis)
    router,
    router_bias,
    wg: Sequence[torch.Tensor],
    wu: Sequence[torch.Tensor],
    wd: Sequence[torch.Tensor],  # each model shard's local expert weights [E_local, ...]
    cfg: ModelConfig,
    ep_axis: str,
    mesh=None,
    group: Optional[Sequence[int]] = None,
):
    """One model group of the reference's ``apply_moe_ep_local``: model
    shard ``j`` (on ``mesh``'s device ``group[j]``; ``xt``'s device without
    a mesh) ranks and runs its experts ``wg[j]``, ``wu[j]``, ``wd[j]``.
    Returns the output after the ``psum`` over ``ep_axis`` (on ``xt``'s
    device), each shard's load ``[E_local]`` (before any sum over the data
    axes) and the dropped count after the ``psum``."""
    size = len(wg)
    devs = [mesh.device_list[group[j]] if mesh is not None else xt.device for j in range(size)]
    # f: the tokens and the router enter each shard's split compute; their
    # gradients are summed over the group (``shard_map``'s transpose of a
    # replicated input), one counted all-reduce each in the backward
    xs = MESH.copy_to_group(mesh, xt, devs)
    rs = MESH.copy_to_group(mesh, router, devs)
    outs, loads, drops = [], [], []
    for j, dev in enumerate(devs):
        rb = None if router_bias is None else router_bias.to(dev)
        o, ld, dr = _ep_shard(xs[j], rs[j], rb, wg[j], wu[j], wd[j], cfg, j, size)
        outs.append(o)
        loads.append(ld)
        drops.append(dr)
    out = _group_psum(outs, mesh).to(xt.device)
    dropped = _group_psum(drops, mesh)
    return out, loads, dropped


def _blocks(w, tp: int) -> List[torch.Tensor]:
    """The ``tp`` expert blocks of a weight: a list of them as it is, or a
    whole ``[E, ...]`` tensor split on its leading dimension (views; the
    shard_map's ``P(ep_axis, None, None)``)."""
    if isinstance(w, (list, tuple)):
        return list(w)
    return list(torch.chunk(w, tp, dim=0))


def apply_moe_shardmap(p: Params, cfg: ModelConfig, x: torch.Tensor, ep_axis: str):
    """shard_map-EP MoE over ``EP_CONTEXT``'s mesh.

    Inside a sharded step (``EP_CONTEXT["group"]`` set), ``x`` is one data
    shard's tokens and the expert weights are that group's blocks (lists,
    one a model shard); otherwise ``x`` is the global batch, split over the
    data axes as the reference's ``P(dp, None, None)``, and the weights are
    whole tensors (or lists of blocks) split over ``ep_axis``."""
    mesh = EP_CONTEXT["mesh"]
    m = cfg.moe
    B, S, d = x.shape
    tp = mesh.shape[ep_axis]
    rbias = p.get("router_bias") if m.router_aux_free else None
    wg, wu, wd = (_blocks(p[n], tp) for n in ("wg", "wu", "wd"))
    group = EP_CONTEXT["group"]
    stats = SHARD_CONTEXT["stats"]
    shared = None
    if "shared" in p:  # before the routed experts: the combine below is the layer's last work
        s = p["shared"]
        xt = x.reshape(B * S, d)
        sg = F.silu(torch.einsum("td,df->tf", xt, s["wg"].to(x.dtype)))
        su = torch.einsum("td,df->tf", xt, s["wu"].to(x.dtype))
        shared = torch.einsum("tf,fd->td", sg * su, s["wd"].to(x.dtype)).reshape(B, S, d)
    if group is not None:
        out, loads, dropped = apply_moe_ep_local(
            x.reshape(B * S, d), p["router"], rbias, wg, wu, wd, cfg, ep_axis, mesh, group
        )
        out = out.reshape(B, S, d)
        load = torch.cat([ld.to(x.device) for ld in loads])
        if stats is not None:  # summed over the data shards after the microbatch
            stats.record(loads)
    else:
        groups = mesh.groups(ep_axis)  # one a data shard, in data order
        Bl = B // len(groups)
        outs, drops = [], []
        loads: List[Any] = [None] * mesh.size  # each device's model shard's load
        for c, grp in enumerate(groups):
            xc = x[c * Bl:(c + 1) * Bl].reshape(Bl * S, d)
            oc, lc, dc = apply_moe_ep_local(xc, p["router"], rbias, wg, wu, wd, cfg, ep_axis, mesh, grp)
            outs.append(oc.reshape(Bl, S, d))
            drops.append(dc)
            for j, i in enumerate(grp):
                loads[i] = lc[j]
        # aggregate load over data shards for telemetry (one psum a data axis)
        for a in axis_tuple(EP_CONTEXT["dp"]):
            if mesh.shape[a] > 1:
                loads = mesh.psum(loads, a)
        out = torch.cat(outs)
        load = torch.cat([loads[i].to(x.device) for i in groups[0]])
        # out_specs P() with replication checks off: the first device's
        # value, data shard 0's count (ROADMAP C28)
        dropped = drops[0]

    if shared is not None:
        out = out + shared
    if stats is not None:  # its value comes from EPLoads.reduce
        aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        aux_loss = _ep_aux(m.n_experts, load)  # proxy on EP path
    aux = {
        "expert_load": load,
        "moe_aux_loss": aux_loss,
        "moe_dropped": dropped.to(torch.int32),
    }
    return out, aux


class ShardStats:
    """What a data shard's MoE layers on the local path read of the other
    data shards of one microbatch, for a step that runs the shards one at
    a time.

    Pass 1 (``recording``), gradient-free, runs the shards in data order and
    records each layer's (``SHARD_CONTEXT["layer"]``) load and
    importance; a shard's dispatch already ranks its assignments after
    those of the shards before it (:meth:`offsets`), with the capacity of
    the whole microbatch, as the reference's one program dispatches.
    Pass 2 replays the shards with gradients: the same dispatch, and the
    aux loss from the whole microbatch's load and importance, the other
    shards' importance held constant, so that the shards' gradients sum to
    the reference's and each shard's loss carries ``1 / n_shards`` of the
    aux term's value."""

    def __init__(self, n_shards: int, tokens: int):
        self.n_shards = n_shards
        self.tokens = tokens  # the whole microbatch's
        self.shard = 0
        self.recording = True
        self.load: Dict[int, List[torch.Tensor]] = {}
        self.imp: Dict[int, List[torch.Tensor]] = {}

    @staticmethod
    def _key():
        return SHARD_CONTEXT["layer"]

    def _record(self, table, value) -> None:
        rows = table.setdefault(self._key(), [None] * self.n_shards)
        if self.recording:
            rows[self.shard] = value.detach()

    def offsets(self, n: int, device) -> torch.Tensor:
        """The assignments to each expert made by the data shards before
        this one (int64 ``[n]``)."""
        rows = self.load.get(self._key(), [None] * self.n_shards)
        off = torch.zeros((n,), dtype=torch.int64, device=device)
        for r in rows[: self.shard]:
            off = off + r.to(device).long()
        return off

    def local_aux(self, cfg: ModelConfig, load, importance, T: int) -> torch.Tensor:
        """The local path's Switch aux term over the whole microbatch
        (this shard's share of its value; its gradient through this
        shard's importance)."""
        m = cfg.moe
        self._record(self.load, load)
        self._record(self.imp, importance)
        loads = self.load[self._key()]
        imps = self.imp[self._key()]
        if self.recording:
            return torch.zeros((), dtype=torch.float32, device=load.device)
        load_g = loads[0].to(load.device)
        for r in loads[1:]:
            load_g = load_g + r.to(load.device)
        imp_g = None
        for s, r in enumerate(imps):
            term = importance if s == self.shard else r.to(load.device)
            imp_g = term if imp_g is None else imp_g + term
        Tg = self.tokens
        aux = m.n_experts * torch.mean((load_g / (Tg * m.top_k)) * (imp_g / torch.clamp(imp_g.sum(), min=1e-9)))
        return aux.detach() / self.n_shards + (aux - aux.detach())


class EPLoads:
    """The expert-parallel path's loads over the data shards of one
    microbatch, for a step that runs the shards one at a time.  Each data
    shard (``shard``) records its model shards' loads a MoE layer
    (``SHARD_CONTEXT["layer"]``); after the microbatch :meth:`reduce` sums
    them over the data axes as the reference does (one ``psum`` a data
    axis a layer) and gives the aux proxy's value over the layers.  The
    proxy has no gradient, so the shards' one pass with gradients leaves
    it out of their losses and the step adds its value to the loss."""

    def __init__(self):
        self.shard = 0
        self.loads: Dict[Any, Dict[int, List[torch.Tensor]]] = {}

    def record(self, loads: Sequence[torch.Tensor]) -> None:
        self.loads.setdefault(SHARD_CONTEXT["layer"], {})[self.shard] = [ld.detach() for ld in loads]

    def reduce(self, mesh, groups: Sequence[Sequence[int]], dp, n_experts: int, device) -> torch.Tensor:
        """The aux proxy summed over the recorded layers, on ``device``:
        ``groups[c]`` is data shard ``c``'s model group (flat device
        indices), ``dp`` the data axes; a data shard that recorded nothing
        (GSPMD's padding alone) adds zeros."""
        total = torch.zeros((), dtype=torch.float32, device=device)
        e_local = n_experts // len(groups[0])
        for by_shard in self.loads.values():
            xs: List[Any] = [None] * mesh.size
            for c, grp in enumerate(groups):
                for j, i in enumerate(grp):
                    xs[i] = by_shard[c][j] if c in by_shard else torch.zeros(
                        (e_local,), dtype=torch.float32, device=mesh.device_list[i])
            for a in axis_tuple(dp):
                if mesh.shape[a] > 1:
                    xs = mesh.psum(xs, a)
            total = total + _ep_aux(n_experts, torch.cat([xs[i].to(device) for i in groups[0]]))
        return total
