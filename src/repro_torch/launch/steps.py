"""Train / prefill / serve step factories (port of
``repro.launch.steps``).

``make_train_step`` runs microbatched gradient accumulation (a loop over
microbatches, float32 accumulators) around the model's rematerialised
forward and backward, then the AdamW update.  Gradient compression (top-k
with error feedback) optionally wraps the accumulated gradients.

The steps are functions of the reference's state tree (``{"params",
"opt"[, "residual"]}``, the param tree's shape and leaf names), never of
``nn.Parameter``s: gradients come from ``torch.autograd.grad`` over the
param tree's leaves, so the tree, AdamW, checkpoints and
``models.convert`` carry it leaf for leaf.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.mesh import Mesh, P, Sharded, axis_tuple, device_put
from repro_torch.models import moe as MOE
from repro_torch.models import tp_train as TT
from repro_torch.models import serving as SV
from repro_torch.models import sharding as SD
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


def init_train_state(gen: torch.Generator, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """Params from ``gen`` (see ``transformer.init_params``) and AdamW's
    zero moments, on ``device`` (``cuda`` unless given)."""
    params = TF.init_params(gen, cfg, device)
    return {"params": params, "opt": adamw.init(params)}


def value_and_grad(cfg: ModelConfig, ep_axis: Optional[str] = "model"):
    """``fn(params, tokens, labels, frontend) -> (loss, metrics, grads)``:
    ``train_loss`` and its gradient with respect to every leaf of the
    param tree (a leaf the loss does not reach, such as an aux-free
    router's bias, gets zeros, as ``jax.grad`` gives), in the tree's
    shape.  The loss and metrics come back detached."""

    def fn(params, tokens, labels, fe):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, metrics = TF.train_loss(
            tree_unflatten(params, leaves), cfg, tokens, labels, frontend_embeds=fe, ep_axis=ep_axis
        )
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_unflatten(params, grads)

    return fn


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
    n_micro: int = 1,
    ep_axis: Optional[str] = "model",
    comp_cfg: compression.CompressionConfig = compression.CompressionConfig(),
    dp_spec=None,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: tokens [GB, S], labels [GB, S], optional frontend [GB, P, d];
    ``GB`` a multiple of ``n_micro``.

    With ``dp_spec`` (the data-parallel mesh axes the batch shards over,
    ``sharding.batch_axes``) the step runs over a mesh: ``state`` is placed
    there (:func:`place_train_state`) and the step is
    :func:`sharded_train_step`'s (with compression, ``state["residual"]``
    placed by the param specs).  The reference pins the microbatch
    reshape's sharding with it; the port runs each data shard's slice of
    every microbatch on that shard's devices."""
    if dp_spec is not None:
        return lambda state, batch: sharded_train_step(cfg, opt_cfg, n_micro, ep_axis, dp_spec, state, batch,
                                                       comp_cfg)
    grad_fn = value_and_grad(cfg, ep_axis)

    def train_step(state, batch):
        params = state["params"]
        tokens, labels = batch["tokens"], batch["labels"]
        fe = batch.get("frontend")
        if n_micro == 1:
            loss, metrics, grads = grad_fn(params, tokens, labels, fe)
            grads = tree_map(lambda g: g.to(torch.float32), grads)
        else:
            mb = tokens.shape[0] // n_micro
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            losses, nlls = [], []
            for i in range(n_micro):
                sl = slice(i * mb, (i + 1) * mb)
                loss_m, metrics_m, g = grad_fn(params, tokens[sl], labels[sl], None if fe is None else fe[sl])
                grads = tree_unflatten(
                    grads, [a + gg.to(torch.float32) for a, gg in zip(tree_leaves(grads), tree_leaves(g))]
                )
                losses.append(loss_m)
                nlls.append(metrics_m["nll"])
                del g
            grads = tree_map(lambda g: g / n_micro, grads)
            loss = torch.stack(losses).mean()
            metrics = {"nll": torch.stack(nlls).mean()}
        if comp_cfg.enabled:
            grads, residual = compression.compress(grads, state["residual"], comp_cfg)
        new_params, new_opt, opt_metrics = adamw.update(grads, state["opt"], params, opt_cfg)
        new_state = {"params": new_params, "opt": new_opt}
        if comp_cfg.enabled:
            new_state["residual"] = residual
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

STRATEGIES = ("tp", "fsdp_flat", "ep", "ep_fsdp")


@contextlib.contextmanager
def strategy_context(mesh: Mesh, strategy: str):
    """The launch context of a sharding strategy over ``mesh`` (the
    reference's ``dryrun.lower_cell`` prologue), restored on exit: "ep" and
    "ep_fsdp" set ``moe.EP_CONTEXT`` (expert parallelism over "model");
    "fsdp_flat" and "ep_fsdp" cast stage weights before their gathers
    (``transformer.ACT_CTX``).  Yields ``(plan, ep_axis)``: the strategy
    the param and opt specs take ("ep" plans as "tp") and the step's
    ``ep_axis``."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    ax = SD.mesh_axes(mesh)
    saved = dict(MOE.EP_CONTEXT), dict(TF.ACT_CTX)
    ep = strategy in ("ep", "ep_fsdp")
    MOE.EP_CONTEXT.update(mesh=mesh if ep else None, dp=ax.dp_spec if ep else None, group=None)
    TF.ACT_CTX.update(cast_params=strategy in ("fsdp_flat", "ep_fsdp"))
    try:
        yield ("tp" if strategy == "ep" else strategy), (None if strategy == "fsdp_flat" else "model")
    finally:
        MOE.EP_CONTEXT.update(saved[0])
        TF.ACT_CTX.update(saved[1])


def place_train_state(state, cfg: ModelConfig, mesh: Mesh, strategy: str = "tp"):
    """``state`` (``{"params", "opt"[, "residual"]}``) placed over ``mesh`` by
    ``sharding.param_specs``/``opt_specs`` of ``strategy``: buffers of its
    own for each block on each distinct device (replicas on a repeated
    device share one, as the step's new state does), uneven splits padded
    as GSPMD pads them."""
    specs = {
        "params": SD.param_specs(cfg, mesh, state["params"], strategy),
        "opt": SD.opt_specs(cfg, mesh, state["opt"], strategy),
    }
    if "residual" in state:  # compression's error feedback lies as the params do
        specs["residual"] = SD.param_specs(cfg, mesh, state["residual"], strategy)
    return TF.tree_map(_owned_blocks, device_put(state, SD.shardings_of(mesh, specs), pad=True))


def _owned_blocks(sh: Sharded) -> Sharded:
    """A placed leaf with one buffer of its own a (device, block)."""
    chunks, _ = sh.sharding.mesh.chunk_of(sh.sharding.spec)
    made: Dict[Tuple[str, int], torch.Tensor] = {}
    for b, c in zip(sh.shards, chunks):
        if (str(b.device), c) not in made:
            made[(str(b.device), c)] = b.clone()
    return Sharded(sh.sharding, tuple(made[(str(b.device), c)] for b, c in zip(sh.shards, chunks)), sh.shape)


def gather_train_state(state, device=None):
    """The whole state on one device (the mesh's first by default)."""
    return TF.tree_map(lambda x: x.gather(device) if isinstance(x, Sharded) else x, state)


def _named_leaves(tree, names=()):
    """``(names, leaf)`` in :func:`tree_leaves` order (dict keys sorted),
    names the dict keys along the path; a PartitionSpec is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_leaves(tree[k], names + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [x for t in tree for x in _named_leaves(t, names)]
    return [(names, tree)]


def _is_expert(names) -> bool:
    return len(names) >= 2 and names[-2] == "moe" and names[-1] in ("wg", "wu", "wd")


class _Plan:
    """Where a sharded step's work lies on its mesh: the data shards (one
    a block of the batch axes), each with its first device (the leader)
    and its model group (the devices that share its data coordinates: a
    head-split step's and the expert-parallel path's)."""

    def __init__(self, mesh: Mesh, dp_spec, ep_axis):
        self.mesh = mesh
        self.batch_axes = axis_tuple(dp_spec)
        self.shard_of, self.n_data = mesh.chunk_of(P(self.batch_axes))
        self.leaders = [self.shard_of.index(c) for c in range(self.n_data)]
        self.ep = ep_axis is not None and MOE.EP_CONTEXT["mesh"] is not None
        self.ep_axis = ep_axis
        # each data shard's model group (its leader alone without a "model" axis)
        by_dev = mesh.groups("model") if "model" in mesh.shape else [[i] for i in range(mesh.size)]
        self.groups = [next(g for g in by_dev if lead in g) for lead in self.leaders]

    def device(self, c: int) -> torch.device:
        return self.mesh.device_list[self.leaders[c]]


def _gather_params(plan: _Plan, cfg: ModelConfig, named, cast: bool):
    """Each leaf at use: the whole leaf a device (``all_gather`` over each
    split dimension, padding stripped), float32 stage weights cast to the
    compute dtype first under ``ACT_CTX["cast_params"]``; the expert
    weights of the expert-parallel path stay blocks."""
    mesh = plan.mesh
    dtype = TF.compute_dtype(cfg)
    out = []
    for names, sh in named:
        blocks = list(sh.shards)
        if plan.ep and _is_expert(names):
            out.append(blocks)
            continue
        if cast and names[0] == "stages" and blocks[0].dtype == torch.float32 and dtype != torch.float32:
            made = {}
            blocks = [made.setdefault(id(b), b.to(dtype)) for b in blocks]
        spec = sh.sharding.spec
        for d in range(len(spec)):
            if spec.dim_axes(d) and mesh.axis_size(spec.dim_axes(d)) > 1:
                blocks = mesh.all_gather(blocks, spec.dim_axes(d), dim=d)
        if sh.shape is not None:
            crop = tuple(slice(0, k) for k in sh.shape)
            made = {}
            blocks = [made.setdefault(id(b), b[crop]) for b in blocks]
        out.append(blocks)
    return out


def _shard_params(plan: _Plan, params_sh, named, gathered, c: int):
    """Data shard ``c``'s param tree: its leader's whole leaves, and its
    model group's expert blocks (a list, one a model shard)."""
    lead = plan.leaders[c]
    vals = []
    for (names, _), blocks in zip(named, gathered):
        if plan.ep and _is_expert(names):
            vals.append([blocks[j] for j in plan.groups[c]])
        else:
            vals.append(blocks[lead])
    return tree_unflatten(params_sh, vals)


def _padded_shape(mesh: Mesh, sh: Sharded) -> Tuple[int, ...]:
    """The extent a placed leaf's blocks tile: its shape, padded where a
    split is uneven."""
    spec = sh.sharding.spec
    return tuple(b * (mesh.axis_size(spec.dim_axes(d)) if spec.dim_axes(d) else 1)
                 for d, b in enumerate(sh.shards[0].shape))


def _select_local(x: torch.Tensor, mesh: Mesh, spec, d: int, keep: Tuple[str, ...], i: int) -> torch.Tensor:
    """Device ``i``'s part of dimension ``d`` (split over ``spec``'s axes)
    along the axes not in ``keep``: the dimension viewed as one index an
    axis (row-major) and a block, those axes fixed at device ``i``'s
    coordinates; the ``keep`` axes' blocks remain, in their order."""
    axes = spec.dim_axes(d)
    ks = [mesh.shape[a] for a in axes]
    block = x.shape[d] // math.prod(ks)
    v = x.reshape(x.shape[:d] + tuple(ks) + (block,) + x.shape[d + 1:])
    coord = {a: mesh.axis_index(a)[i] for a in axes}
    idx = [slice(None)] * v.ndim
    for j, a in enumerate(axes):
        if a not in keep:
            idx[d + j] = coord[a]
    v = v[tuple(idx)]
    return v.reshape(x.shape[:d] + (-1,) + x.shape[d + 1:])


def _reduce_grads(plan: _Plan, named, accs):
    """Each leaf's summed gradient, in its own spec's blocks: a device's
    data shard's gradient, its part along the axes that are not batch
    axes taken locally; a ``psum_scatter`` over the batch axes a dimension
    is split over; a ``psum`` over the batch axes left (replicated leaves:
    an ``all-reduce`` alone).  Collectives over groups of one are not
    run."""
    mesh = plan.mesh
    out = []
    for li, (names, sh) in enumerate(named):
        spec = sh.sharding.spec
        expert = plan.ep and _is_expert(names)
        padded = _padded_shape(mesh, sh)
        xs, made = [], {}
        for i in range(mesh.size):
            c = plan.shard_of[i]
            if expert:  # the model shard's own block: its expert dimension is local already
                key = (c, i)
            else:  # devices whose blocks differ only along batch axes share an input
                key = (c,) + tuple(mesh.axis_index(a)[i] for a in spec.axes if a not in plan.batch_axes)
            if key not in made:
                if accs[c] is None:  # a data shard of padding alone
                    shape = sh.shards[i].shape if expert else padded
                    g = torch.zeros(shape, dtype=torch.float32, device=sh.shards[i].device)
                elif expert:
                    g = accs[c][li][plan.groups[c].index(i)]
                else:
                    g = accs[c][li]
                    if tuple(g.shape) != padded:  # an uneven split: pad as the blocks are padded
                        g = torch.nn.functional.pad(g, [p for d in reversed(range(g.ndim))
                                                        for p in (0, padded[d] - g.shape[d])])
                if not expert:
                    for d in range(len(spec)):
                        if any(a not in plan.batch_axes for a in spec.dim_axes(d)):
                            g = _select_local(g, mesh, spec, d, plan.batch_axes, i)
                made[key] = g
            xs.append(made[key])
        used = ()
        for d in range(len(spec)):
            inb = tuple(a for a in spec.dim_axes(d) if a in plan.batch_axes)
            if expert and any(a not in plan.batch_axes for a in spec.dim_axes(d)):
                inb = ()  # the expert blocks: this dimension is the model shard's own
            if inb:
                used += inb
                if mesh.axis_size(inb) > 1:
                    xs = mesh.psum_scatter(xs, inb, dim=d)
                else:
                    xs = [_select_local(x, mesh, P(*([None] * d + [inb])), d, (), i) for i, x in enumerate(xs)]
        rest = tuple(a for a in plan.batch_axes if a not in used)
        if rest and mesh.axis_size(rest) > 1:
            xs = mesh.psum(xs, rest)
        out.append(xs)
    return out


def head_split(mesh: Mesh, batch_axes) -> bool:
    """Whether a sharded step over ``mesh`` computes head-split: a "model"
    axis that is not a batch axis, under a plan that does not cast stage
    weights for ZeRO-3 gathers ("tp" and "ep"; "fsdp_flat" and "ep_fsdp"
    gather at use)."""
    return "model" in mesh.shape and "model" not in axis_tuple(batch_axes) and not TF.ACT_CTX["cast_params"]


def sharded_train_step(cfg: ModelConfig, opt_cfg, n_micro: int, ep_axis, dp_spec, state, batch,
                       comp_cfg: compression.CompressionConfig = compression.CompressionConfig()):
    """One training step over the mesh ``state`` is placed on.

    "tp" and "ep" (:func:`head_split`): for each microbatch (the
    reference's ``[n_micro, mb, S]`` reshape) each data shard's ``mb / D``
    rows run over its model group, head-split (``models.tp_train``: each
    model shard its heads, FFN columns, experts and vocabulary block; an
    ``all-reduce`` over "model" after the embedding, ``wo``, ``wd`` and
    ``out_proj`` and, in the backward, before each split block; each loss
    chunk's logits gathered by ``all-gather``); the leaves whose blocks do
    not line up are gathered once a step.  Each device's gradients are
    summed into float32 accumulators of its own.  "fsdp_flat" and
    "ep_fsdp" gather every split leaf once a step (``all-gather`` a split
    dimension; ``ACT_CTX["cast_params"]`` casts float32 stage weights to
    the compute dtype first) and run each data shard's rows on its leader
    device (the expert-parallel path: each model shard's expert blocks on
    its own device, one ``psum`` over ``model`` a MoE layer, its backward
    an ``all-reduce`` of the tokens' and the router's gradients).

    The microbatch's valid-label counts come from one ``psum`` over the
    batch axes.  An MoE architecture over several data shards reads across
    them: on the local path a gradient-free first pass over the shards
    (``moe.ShardStats``) gives each shard the dispatch order and aux
    statistics of the whole microbatch (an artifact of running the shards
    in turn); on the expert-parallel path each shard's one pass records
    its loads (``moe.EPLoads``), summed after the microbatch by one
    ``psum`` a data axis a MoE layer.  After the microbatches each leaf's
    gradient is reduced to its spec (over "model" where a head-split shard
    read a part of a leaf it does not own, then over the batch axes), the
    losses are one ``psum`` over the batch axes, top-k compression
    (``comp_cfg``) finds each compressed leaf's threshold from an
    ``all-gather`` of its magnitudes, the global norm is one ``psum`` over
    the whole mesh, and AdamW steps each block once a device.  Collectives
    over groups of one are not run; every collective counts each time it
    runs, a checkpointed layer's recompute included.
    ``launch.dryrun.step_collectives`` is this schedule as a formula."""
    params_sh, opt_sh = state["params"], state["opt"]
    named = _named_leaves(params_sh)
    mesh = named[0][1].sharding.mesh
    plan = _Plan(mesh, dp_spec, ep_axis)
    split = head_split(mesh, plan.batch_axes)

    def whole(x):
        return None if x is None else (x.gather() if isinstance(x, Sharded) else x)

    tokens, labels, fe = whole(batch["tokens"]), whole(batch["labels"]), whole(batch.get("frontend"))
    mb = tokens.shape[0] // n_micro
    if split:
        accs, parts = _head_split_micro(cfg, plan, named, params_sh, tokens, labels, fe, n_micro, mb)
        grads = _reduce_head_split(plan, named, accs)
    else:
        accs, parts = _leader_micro(cfg, plan, named, params_sh, tokens, labels, fe, n_micro, mb, ep_axis)
        grads = _reduce_grads(plan, named, accs)
    del accs

    # the losses: one psum over the batch axes of each data shard's part
    lm = [torch.stack(parts[plan.shard_of[i]]).to(mesh.device_list[i]) for i in range(mesh.size)]
    if mesh.axis_size(plan.batch_axes) > 1:
        lm = mesh.psum(lm, plan.batch_axes)
    loss, nll = lm[0].mean(0).unbind()

    for xs in grads:  # a leaf at a time; a block that replicas share stays shared
        scaled: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        for i, g in enumerate(xs):
            if id(g) not in scaled:
                scaled[id(g)] = (g, g / n_micro)
            xs[i] = scaled[id(g)][1]
    residual = None
    if comp_cfg.enabled:
        grads, residual = compress_blocks(mesh, named, grads, _named_leaves(state["residual"]), comp_cfg)
    # the global norm: each block counted once, one psum over the mesh
    sq = [torch.zeros((), dtype=torch.float32, device=dev) for dev in mesh.device_list]
    for (names, sh), xs in zip(named, grads):
        chunks, _ = mesh.chunk_of(sh.sharding.spec)
        first = {}
        for i, ch in enumerate(chunks):
            first.setdefault(ch, i)
        for ch, i in first.items():
            sq[i] = sq[i] + torch.sum(xs[i].to(torch.float32) ** 2)
    if mesh.size > 1:
        sq = mesh.psum(sq, mesh.axis_names)
    new_state = _adamw_blocks(plan, params_sh, named, grads, opt_sh, sq, opt_cfg)
    if residual is not None:
        new_state["residual"] = tree_unflatten(state["residual"], residual)
    step = opt_sh["step"].shards[0] + 1
    return new_state, {"loss": loss, "nll": nll, "grad_norm": torch.sqrt(sq[0]),
                       "lr": adamw.lr_schedule(opt_cfg, step)}


def _micro_counts(plan: _Plan, labels, rows, i: int):
    """Microbatch ``i``'s valid-label counts on every device (one ``psum``
    over the batch axes)."""
    mesh = plan.mesh
    counts = []
    for dev_i in range(mesh.size):
        lab = rows(labels, i, plan.shard_of[dev_i]).to(mesh.device_list[dev_i])
        counts.append(torch.stack([(lab != -100).sum(), (lab[:, 2:] != -100).sum()]).to(torch.int32))
    if mesh.axis_size(plan.batch_axes) > 1:
        counts = mesh.psum(counts, plan.batch_axes)
    return counts


def _microbatches(cfg, plan: _Plan, tokens, labels, fe, n_micro: int, mb: int, run, add):
    """The loop both executors share: for each microbatch its counts, the
    MoE statistics, the local path's gradient-free first pass, then each
    live data shard ``c``'s ``run(c, i, counts, grad=True) -> (total, nll,
    grads)``, handed to ``add(c, grads)``.  Returns each data shard's
    ``[total, nll]`` a microbatch."""
    D = plan.n_data
    mesh = plan.mesh
    lo, hi = shard_rows(mb, D)
    live = [c for c in range(D) if hi[c] > lo[c]]  # the others hold GSPMD's padding: no rows
    hidden = tokens.shape[1] + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    two_pass = cfg.moe is not None and len(live) > 1 and not plan.ep
    ep_loads = cfg.moe is not None and plan.ep and D > 1
    parts = [[] for _ in range(D)]  # each data shard's (loss, nll) a microbatch

    def rows(x, i, c):
        return None if x is None else x[i * mb + lo[c]:i * mb + hi[c]].to(plan.device(c), non_blocking=True)

    try:
        for i in range(n_micro):
            counts = _micro_counts(plan, labels, rows, i)
            stats = MOE.ShardStats(len(live), mb * hidden) if two_pass else MOE.EPLoads() if ep_loads else None
            MOE.SHARD_CONTEXT["stats"] = stats
            if two_pass:  # uncounted: no collective of the reference's program
                with mesh.uncounted():
                    for k, c in enumerate(live):
                        stats.shard = k
                        run(c, i, counts, rows, grad=False)
                stats.recording = False
            for c in range(D):
                if c not in live:
                    parts[c].append(torch.zeros((2,), dtype=torch.float32, device=plan.device(c)))
                    continue
                if stats is not None:
                    stats.shard = live.index(c) if two_pass else c
                total, nll, g = run(c, i, counts, rows, grad=True)
                add(c, g)
                parts[c].append(torch.stack([total, nll]))
                del g
            if ep_loads:  # the aux proxy's value, from the loads summed over the data axes
                aux = stats.reduce(mesh, plan.groups, plan.batch_axes, cfg.moe.n_experts, plan.device(live[0]))
                first = parts[live[0]]
                first[-1] = first[-1] + torch.stack([TF.MOE_AUX_WEIGHT * aux, torch.zeros_like(aux)])
    finally:
        MOE.SHARD_CONTEXT["stats"] = None
        MOE.EP_CONTEXT["group"] = None
    return parts


def _leader_micro(cfg, plan: _Plan, named, params_sh, tokens, labels, fe, n_micro, mb, ep_axis):
    """Gather-at-use ("fsdp_flat", "ep_fsdp"): every split leaf gathered
    once, each data shard's rows on its leader; each data shard's
    accumulators (a tensor a leaf, or the expert path's list of blocks)."""
    gathered = _gather_params(plan, cfg, named, TF.ACT_CTX["cast_params"])
    trees = [_shard_params(plan, params_sh, named, gathered, c) for c in range(plan.n_data)]
    accs: List[Any] = [None] * plan.n_data

    def run(c, i, counts, rows, grad: bool):
        if plan.ep:
            MOE.EP_CONTEXT["group"] = plan.groups[c]
        norm = tuple(counts[plan.leaders[c]].clamp(min=1).unbind())
        args = (cfg, rows(tokens, i, c), rows(labels, i, c), rows(fe, i, c), ep_axis)
        if not grad:
            with torch.no_grad():
                return TF.train_loss(trees[c], *args, norm=norm)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(trees[c])]
        total, metrics = TF.train_loss(tree_unflatten(trees[c], leaves), *args, norm=norm)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        return (total.detach(), metrics["nll"].detach(),
                [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])

    def add(c, g):
        g = [[x.to(torch.float32) for x in b] if isinstance(b, list) else b.to(torch.float32)
             for b in _regroup(plan, named, g)]
        accs[c] = g if accs[c] is None else [
            [a + x for a, x in zip(aa, gg)] if isinstance(aa, list) else aa + gg for aa, gg in zip(accs[c], g)
        ]

    parts = _microbatches(cfg, plan, tokens, labels, fe, n_micro, mb, run, add)
    return accs, parts


def _head_split_micro(cfg, plan: _Plan, named, params_sh, tokens, labels, fe, n_micro, mb):
    """Head-split ("tp", "ep"): each data shard's rows over its model group
    (``models.tp_train``); each device's accumulators (one a leaf, in the
    shape of its value before the shard narrows it)."""
    mesh = plan.mesh
    lay = TT.train_layout(cfg, mesh)
    lplans = TT.leaf_plans(lay, mesh, [(names, sh.shape if sh.shape is not None else _padded_shape(mesh, sh),
                                        sh.sharding.spec) for names, sh in named], plan.ep)
    bases = TT.gather_bases(mesh, named, lplans)
    accs: List[Any] = [None] * mesh.size

    def run(c, i, counts, rows, grad: bool):
        idx = plan.groups[c]
        leaves = {}
        for dev_i in idx:
            leaves[dev_i] = [None if b is None else
                             (b[dev_i].detach().requires_grad_() if grad else b[dev_i]) for b in bases]
        trees = [tree_unflatten(params_sh, [TT.device_value(lp, leaves[dev_i][li], j)
                                            for li, lp in enumerate(lplans)])
                 for j, dev_i in enumerate(idx)]
        grun = TT.GroupRun(mesh, idx, cfg, lay, trees, plan.ep)
        norm = tuple(counts[idx[0]].clamp(min=1).unbind())
        args = (rows(tokens, i, c), rows(labels, i, c), rows(fe, i, c), norm, TF.MOE_AUX_WEIGHT)
        if not grad:
            with torch.no_grad():
                return TT.group_train_loss(grun, *args)
        totals, nlls = TT.group_train_loss(grun, *args)
        flat = [(dev_i, li, x) for dev_i in idx for li, x in enumerate(leaves[dev_i]) if x is not None]
        grads = torch.autograd.grad(totals, [x for _, _, x in flat], allow_unused=True)
        out = {dev_i: [None] * len(named) for dev_i in idx}
        for (dev_i, li, x), g in zip(flat, grads):
            out[dev_i][li] = torch.zeros_like(x) if g is None else g
        return totals[0].detach(), nlls[0].detach(), out

    def add(c, g):
        for dev_i, gs in g.items():
            gs = [None if x is None else x.to(torch.float32) for x in gs]
            if accs[dev_i] is None:
                accs[dev_i] = gs
                continue
            acc = accs[dev_i]
            for li, x in enumerate(gs):  # a leaf at a time: each old sum goes as its new one comes
                if acc[li] is not None:
                    acc[li] = acc[li] + x

    parts = _microbatches(cfg, plan, tokens, labels, fe, n_micro, mb, run, add)
    return (accs, lplans), parts


def _pad_dim(x: torch.Tensor, d: int, n: int) -> torch.Tensor:
    if x.shape[d] == n:
        return x
    pad = [0] * (2 * x.ndim)
    pad[2 * (x.ndim - 1 - d) + 1] = n - x.shape[d]
    return torch.nn.functional.pad(x, pad)


def _reduce_head_split(plan: _Plan, named, accs_plans):
    """Each leaf's summed gradient in its spec's blocks, from each device's
    accumulator: over "model" as :class:`tp_train.LeafPlan`'s ``reduce``
    says (a ``psum`` of the shards' parts, a gathered leaf's then cut to
    the device's own block; the own block alone of a gathered leaf that
    replicated values read whole), then over the batch axes
    as the gather-at-use step reduces (a ``psum_scatter`` along a dimension
    gathered over them, a ``psum`` over the rest)."""
    accs, lplans = accs_plans
    mesh = plan.mesh
    out = []
    for li, ((names, sh), lp) in enumerate(zip(named, lplans)):
        spec = sh.sharding.spec
        padded = _padded_shape(mesh, sh)
        xs = []
        for i in range(mesh.size):
            g = None if accs[i] is None else accs[i][li]
            if accs[i] is not None:
                accs[i][li] = None  # read once: the leaf's accumulators go with its reduction
            if g is None:  # a data shard of padding alone, or a leaf the step does not read
                shape = list(sh.shards[i].shape)
                for d, _ in lp.gathers:
                    shape[d] = sh.shape[d] if sh.shape is not None else padded[d]
                g = torch.zeros(shape, dtype=torch.float32, device=sh.shards[i].device)
            xs.append(g)
        if lp.reduce == "psum":
            xs = mesh.psum(xs, "model")
        if lp.reduce != "none" and lp.mdim is not None:  # the device's own block of a gathered leaf
            d = lp.mdim
            xs = [_select_local(_pad_dim(x, d, padded[d]), mesh, spec, d, (), i) for i, x in enumerate(xs)]
        gathered = dict(lp.gathers)
        used = ()
        for d in range(len(spec)):
            inb = tuple(a for a in spec.dim_axes(d) if a in plan.batch_axes)
            if not inb:
                continue
            used += inb
            if d not in gathered:  # the leaf's block along it already
                continue
            xs = [_pad_dim(x, d, padded[d]) for x in xs]
            if mesh.axis_size(inb) > 1:
                xs = mesh.psum_scatter(xs, inb, dim=d)
            else:
                xs = [_select_local(x, mesh, spec, d, (), i) for i, x in enumerate(xs)]
        rest = tuple(a for a in plan.batch_axes if a not in used)
        if rest and mesh.axis_size(rest) > 1:
            xs = mesh.psum(xs, rest)
        out.append(xs)
    return out


def compress_blocks(mesh: Mesh, named, grads, residual_named, cfg: compression.CompressionConfig):
    """``compression.compress`` over each leaf's blocks: ``g + r`` a block,
    and where the leaf's unpadded size reaches ``min_size``, ``k = max(1,
    int(size * top_k_frac))`` and the threshold the k-th largest ``|g + r|``
    over the whole leaf, each block counted once and GSPMD's padding left
    out: one ``all-gather`` of the blocks' magnitudes over the axes the
    leaf is split over (the padding as -1, below every magnitude), then
    each device its own top-k; ``mask = |g + r| >= thresh``.  Returns
    ``(sparse blocks, new residual as Sharded leaves)``; ``sparse +
    residual == g + r`` block for block (each entry is kept whole or left
    whole)."""
    sparse_all, res_all = [], []
    for (names, sh), xs, (_, rsh) in zip(named, grads, residual_named):
        ys = [x.to(torch.float32) + r for x, r in zip(xs, rsh.shards)]
        shape = sh.shape if sh.shape is not None else _padded_shape(mesh, sh)
        size = math.prod(shape)
        if size < cfg.min_size:
            sparse_all.append(ys)
            res_all.append(Sharded(rsh.sharding, tuple(torch.zeros_like(y) for y in ys), rsh.shape))
            continue
        k = max(1, int(size * cfg.top_k_frac))
        spec = sh.sharding.spec
        axes = tuple(a for a in spec.axes if mesh.shape[a] > 1)
        mags = []
        for i, y in enumerate(ys):
            m = y.abs()
            if sh.shape is not None:  # GSPMD's padding: below every magnitude
                m = torch.where(_live_mask(mesh, sh, i, y.device), m, -1.0)
            mags.append(m.reshape(-1))
        if axes:
            mags = mesh.all_gather(mags, axes, dim=0)
        made = {}
        sparse, res = [], []
        for i, (y, m) in enumerate(zip(ys, mags)):
            key = (y.device, id(m))
            if key not in made:
                made[key] = torch.topk(m, k).values[-1]
            keep = y.abs() >= made[key]
            s = y * keep.to(y.dtype)
            sparse.append(s)
            res.append(y - s)
        sparse_all.append(sparse)
        res_all.append(Sharded(rsh.sharding, tuple(res), rsh.shape))
    return sparse_all, res_all


def _live_mask(mesh: Mesh, sh: Sharded, i: int, device) -> torch.Tensor:
    """Which entries of device ``i``'s block of ``sh`` lie inside the leaf
    (GSPMD's padding of an uneven split does not)."""
    spec = sh.sharding.spec
    block = sh.shards[i].shape
    chunks, _ = mesh.chunk_of(spec)
    split = [d for d in range(len(block)) if spec.dim_axes(d)]
    coords = np.unravel_index(chunks[i], [mesh.axis_size(spec.dim_axes(d)) for d in split]) if split else ()
    ok = torch.ones(block, dtype=torch.bool, device=device)
    for d, c in zip(split, coords):
        idx = torch.arange(block[d], device=device) + int(c) * block[d]
        view = [1] * len(block)
        view[d] = block[d]
        ok = ok & (idx < sh.shape[d]).reshape(view)
    return ok


def shard_rows(rows: int, n: int) -> Tuple[List[int], List[int]]:
    """Each of ``n`` data shards' rows ``[lo, hi)`` of a microbatch of
    ``rows``: ``ceil(rows / n)`` a shard, as GSPMD splits (the last shards
    may hold padding alone)."""
    s = -(-rows // n)
    return [min(c * s, rows) for c in range(n)], [min((c + 1) * s, rows) for c in range(n)]


def _regroup(plan: _Plan, named, flat):
    """A data shard's gradients (flat, as :func:`tree_leaves` of its param
    tree gives them) one entry a param leaf: a tensor, or the
    expert-parallel path's list of blocks."""
    out, k = [], 0
    for names, _ in named:
        if plan.ep and _is_expert(names):
            n = len(plan.groups[0])
            out.append(flat[k:k + n])
            k += n
        else:
            out.append(flat[k])
            k += 1
    return out


def _adamw_blocks(plan: _Plan, params_sh, named, grads, opt_sh, sq, opt_cfg):
    """AdamW on each device's blocks (a block held twice on one device is
    stepped once and shared), clipped by the global norm; ``grads`` is
    emptied leaf by leaf as it goes."""
    mesh = plan.mesh
    m_named, v_named = _named_leaves(opt_sh["m"]), _named_leaves(opt_sh["v"])
    step_sh = opt_sh["step"]
    new_p, new_m, new_v = [], [], []
    consts = {}
    for i, dev in enumerate(mesh.device_list):
        if dev not in consts:
            norm = torch.sqrt(sq[i])
            scale = torch.clamp(opt_cfg.grad_clip / (norm + 1e-9), max=1.0)
            step = step_sh.shards[i] + 1
            b1c = 1 - opt_cfg.b1 ** step.to(torch.float32)
            b2c = 1 - opt_cfg.b2 ** step.to(torch.float32)
            consts[dev] = (scale, adamw.lr_schedule(opt_cfg, step), b1c, b2c, step)
    for li, ((names, sh), (_, msh), (_, vsh)) in enumerate(zip(named, m_named, v_named)):
        xs, grads[li] = grads[li], None  # a leaf's gradients go once its blocks are stepped
        chunks, _ = mesh.chunk_of(sh.sharding.spec)
        done = {}
        ps, ms, vs = [], [], []
        for i, dev in enumerate(mesh.device_list):
            key = (dev, chunks[i])
            if key not in done:
                scale, lr, b1c, b2c, _ = consts[dev]
                g = xs[i].to(torch.float32) * scale
                done[key] = adamw.leaf_update(sh.shards[i], g, msh.shards[i], vsh.shards[i], lr, b1c, b2c, opt_cfg)
            p2, m2, v2 = done[key]
            ps.append(p2)
            ms.append(m2)
            vs.append(v2)
        new_p.append(Sharded(sh.sharding, tuple(ps), sh.shape))
        new_m.append(Sharded(msh.sharding, tuple(ms), msh.shape))
        new_v.append(Sharded(vsh.sharding, tuple(vs), vsh.shape))
    steps = tuple(consts[dev][4] for dev in mesh.device_list)
    return {
        "params": tree_unflatten(params_sh, new_p),
        "opt": {"m": tree_unflatten(opt_sh["m"], new_m), "v": tree_unflatten(opt_sh["v"], new_v),
                "step": Sharded(step_sh.sharding, steps, step_sh.shape)},
    }


def cache_batch(cache) -> int:
    """The batch a decode cache was made for (from ``kpos``, the SSM
    state or whisper's ``enc_kv``)."""
    for names, leaf in _named_leaves(cache):
        name = names[-1] if names else ""
        if name == "kpos":
            return leaf.shape[-2]
        if name == "ssm":
            return leaf.shape[-4]
        if name == "enc_kv":
            return leaf.shape[2]
    raise ValueError("a decode cache holds kpos, ssm or enc_kv leaves")


def place_serve_state(params, cache, cfg: ModelConfig, mesh: Mesh, strategy: str = "tp"):
    """``(params, cache)`` placed for sharded serving over ``mesh`` (a
    ``None`` cache, for a prefill, stays ``None``): params by
    ``sharding.param_specs`` of ``strategy``'s plan ("ep" plans as "tp"),
    the cache by ``sharding.cache_specs`` for its batch (its slot axis over
    "data" where the batch is below the data axes).  Blocks that need no
    padding are views of the given tensors where they already lie on their
    device (``copy=False``: nothing is allocated for them, and the cache's
    blocks are written in place); uneven splits are padded as GSPMD pads
    them (the step never reads a padded slot).  Place a copy of a cache
    whose buffers must stay as they are."""
    plan = "tp" if strategy == "ep" else strategy
    if plan not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    placed = device_put(params, SD.shardings_of(mesh, SD.param_specs(cfg, mesh, params, plan)), pad=True)
    if cache is None:
        return placed, None
    cspecs = SD.cache_specs(cfg, mesh, cache, cache_batch(cache))
    return placed, device_put(cache, SD.shardings_of(mesh, cspecs), pad=True)


def placed_bytes(tree) -> Dict[str, int]:
    """One device's bytes of a placed tree (its blocks) and the bytes its
    placement allocated on the mesh's devices (storages that are not views
    of the tensors it was placed from: buffers, padded blocks and copies
    to other devices)."""
    per_device = 0
    seen: Dict[Tuple[str, int], int] = {}
    for _, sh in _named_leaves(tree):
        per_device += sh.shards[0].numel() * sh.shards[0].element_size()
        for b in sh.shards:
            st = b.untyped_storage()
            seen[(str(b.device), st.data_ptr())] = st.nbytes()
    return {"per_device": per_device, "storages": sum(seen.values())}


def make_prefill_step(cfg: ModelConfig, ep_axis: Optional[str] = "model"):
    """Full-sequence forward emitting last-position logits only (serving
    samples from the last position).  Given params placed over a mesh
    (:func:`place_serve_state`) it runs sharded (``serving.sharded_prefill``:
    the batch over the data axes, heads over "model") and returns the
    logits vocabulary-sharded over "model"."""

    def prefill_step(params, batch):
        with torch.no_grad():
            if SV.is_sharded(params):
                return SV.sharded_prefill(params, cfg, batch["tokens"], batch.get("frontend"), ep_axis)
            logits, _, _ = TF.forward(
                params, cfg, batch["tokens"], batch.get("frontend"), ep_axis=ep_axis, remat=False, last_only=True
            )
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig, ep_axis: Optional[str] = "model"):
    """One-token decode against the static cache (updated in place).
    Given params and a cache placed over a mesh (:func:`place_serve_state`)
    it runs sharded (``serving.sharded_decode_step``) and returns the
    logits vocabulary-sharded over "model"."""

    def serve_step(params, cache, token):
        with torch.no_grad():
            if SV.is_sharded(params):
                return SV.sharded_decode_step(params, cfg, cache, token, ep_axis=ep_axis)
            return SV.decode_step(params, cfg, cache, token, ep_axis=ep_axis)

    return serve_step
