"""Pod-scale dry run of the port's sharded cells (the counterpart of
``repro.launch.dryrun``).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2_0_5b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh single --out experiments/dryrun_torch
    python -m repro_torch.launch.dryrun --all --mesh multi --strategy fsdp_flat   # 2x16x16

The reference lowers and compiles each cell at 256 or 512 forced devices
and reads memory and collectives from the compiled program.  The port
lowers nothing.  For each cell it writes, from the sharding plan and the
``meta``-device shapes of the params, optimizer state, batch and cache:

* the plan (each parameter path's PartitionSpec);
* per-device bytes of params, optimizer state, batch and cache (the
  counterpart of ``memory_analysis``' argument bytes; uneven splits padded
  as GSPMD pads them);
* ``n_micro`` (``shapes.grad_accum_steps``);
* FLOPs and HBM bytes (``analysis.flops``) and the roofline terms on an
  H100 (``analysis.roofline``);
* the collectives the port's sharded step issues, by kind: calls and one
  device's result bytes; for a train cell from :func:`step_collectives`
  (``launch.steps.sharded_train_step``'s schedule as a formula over the
  plan), for a prefill or decode cell from :func:`serve_collectives`
  (``serving.sharded_prefill``/``sharded_decode_step``'s: heads split
  over "model", a decode cache placed by ``cache_specs``, ``long_500k``'s
  slot axis over "data"); tests hold both to the mesh counters of real
  steps at 2 x 2;
* for a train cell, ``executor_only``: what the port's step adds because
  it runs the data shards one at a time (:func:`executor_terms`), which
  the roofline leaves out.

The meshes are one device repeated (``launch.mesh``): nothing is
allocated per shard.  ``--device`` defaults to ``cuda`` (the port's entry
points do); ``--device cpu`` plans on a machine without a card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from repro_torch.analysis import roofline as RL
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.mesh import COLLECTIVES, Mesh, axis_tuple, block_shape
from repro_torch.launch import shapes as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import serving as SV
from repro_torch.models import sharding as SD
from repro_torch.models import tp_train as TT
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, compression


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def tree_bytes_per_device(mesh: Mesh, tree, specs) -> int:
    """One device's bytes of ``tree`` laid out by ``specs`` (its blocks,
    padded)."""
    return sum(math.prod(block_shape(mesh, spec, tuple(leaf.shape))) * leaf.element_size()
               for (_, leaf), (_, spec) in zip(ST._named_leaves(tree), ST._named_leaves(specs)))


def _n_moe_layers(cfg: ModelConfig) -> int:
    return sum(1 for i in range(cfg.n_layers) if cfg.layer_has_moe(i)) if cfg.moe is not None else 0


def step_collectives(
    cfg: ModelConfig, mesh: Mesh, strategy: str, n_micro: int, batch: int, seq: int,
    comp_cfg: Optional[compression.CompressionConfig] = None, first_pass: Optional[Dict[str, Dict[str, int]]] = None,
) -> Tuple[Dict[str, int], Dict[str, int]]:
    """The collectives one ``sharded_train_step`` of a ``[batch, seq]``
    batch in ``n_micro`` microbatches issues over ``mesh`` under
    ``strategy`` (with ``comp_cfg``'s compression): (calls by kind, one
    device's result bytes by kind), in the order the step issues them (see
    its docstring).  The local MoE path's gradient-free first pass (an
    artifact of running the data shards in turn, :func:`executor_terms`)
    is not counted; ``first_pass``, a dict, receives its collectives as
    ``{"calls": ..., "bytes": ...}``."""
    calls = dict.fromkeys(COLLECTIVES, 0)
    nbytes = dict.fromkeys(COLLECTIVES, 0)

    def add(kind, shape, dtype, times=1):
        calls[kind] += times
        nbytes[kind] += times * math.prod(shape) * _itemsize(dtype)

    with ST.strategy_context(mesh, strategy) as (plan, ep_axis):
        cast = TF.ACT_CTX["cast_params"]
        params = SH.params_struct(cfg)
        specs = SD.param_specs(cfg, mesh, params, plan)
        bx = SD.batch_axes(cfg, mesh, plan)
        ep = ep_axis is not None and strategy in ("ep", "ep_fsdp")
        split = ST.head_split(mesh, bx)
    baxes = axis_tuple(bx)
    D = mesh.axis_size(baxes)
    named = [(names, leaf, spec) for (names, leaf), (_, spec) in
             zip(ST._named_leaves(params), ST._named_leaves(specs))]
    lo, hi = ST.shard_rows(batch // n_micro, D)
    live = [h - l for l, h in zip(lo, hi) if h > l]
    n_moe = _n_moe_layers(cfg)
    if split:
        extra = {"calls": dict.fromkeys(COLLECTIVES, 0), "bytes": dict.fromkeys(COLLECTIVES, 0)}

        def add_first(kind, shape, dtype, times=1):
            extra["calls"][kind] += times
            extra["bytes"][kind] += times * math.prod(shape) * _itemsize(dtype)

        lplans = _head_split_schedule(cfg, mesh, named, ep, live, n_micro, seq, D, add, add_first)
        if first_pass is not None:
            first_pass.update(extra)
    else:
        lplans = None
        _leader_schedule(cfg, mesh, named, cast, ep, live, n_micro, seq, D, add)
    if ep and n_moe and D > 1:  # the loads over each data axis, a MoE layer a microbatch (moe.EPLoads)
        for a in baxes:
            if mesh.shape[a] > 1:
                add("all-reduce", (cfg.moe.n_experts // mesh.shape["model"],), torch.float32, n_moe * n_micro)

    # after the microbatches
    if D > 1:
        add("all-reduce", (n_micro, 2), torch.float32)  # the losses
    for li, (names, leaf, spec) in enumerate(named):
        if split:
            _head_split_reduce(mesh, baxes, leaf, spec, lplans[li], add)
            continue
        block = block_shape(mesh, spec, tuple(leaf.shape))
        expert = ep and ST._is_expert(names)
        shape = []
        for d, b in enumerate(block):
            inb = [a for a in spec.dim_axes(d) if a in baxes]
            shape.append(b if expert else b * mesh.axis_size(tuple(inb)) if inb else b)
        used = ()
        for d in range(len(spec)):
            inb = tuple(a for a in spec.dim_axes(d) if a in baxes)
            if expert and any(a not in baxes for a in spec.dim_axes(d)):
                inb = ()
            if inb:
                used += inb
                shape[d] = block[d]
                if mesh.axis_size(inb) > 1:
                    add("reduce-scatter", shape, torch.float32)
        rest = tuple(a for a in baxes if a not in used)
        if rest and mesh.axis_size(rest) > 1:
            add("all-reduce", block, torch.float32)
    if comp_cfg is not None and comp_cfg.enabled:  # each threshold's magnitudes
        for names, leaf, spec in named:
            size = math.prod(leaf.shape)
            if size >= comp_cfg.min_size and any(mesh.shape[a] > 1 for a in spec.axes):
                add("all-gather", (math.prod(block_shape(mesh, spec, tuple(leaf.shape)))
                                   * math.prod(mesh.shape[a] for a in spec.axes),), torch.float32)
    if mesh.size > 1:
        add("all-reduce", (), torch.float32)  # the global norm
    return calls, nbytes


def _leader_schedule(cfg, mesh, named, cast, ep, live, n_micro, seq, D, add):
    """Gather-at-use's terms before the reductions ("fsdp_flat",
    "ep_fsdp"): the gathers once a step, each microbatch's counts and EP
    combines."""
    dtype = TF.compute_dtype(cfg)
    for names, leaf, spec in named:
        if ep and ST._is_expert(names):
            continue
        dt = dtype if (cast and names[0] == "stages" and leaf.dtype == torch.float32) else leaf.dtype
        shape = list(block_shape(mesh, spec, tuple(leaf.shape)))
        for d in range(len(spec)):
            k = mesh.axis_size(spec.dim_axes(d)) if spec.dim_axes(d) else 1
            if k > 1:
                shape[d] *= k
                add("all-gather", shape, dt)
    n_moe = _n_moe_layers(cfg)
    tp = mesh.shape.get("model", 1)
    router_dt = dtype if cast else torch.float32
    for _ in range(n_micro):
        if D > 1:
            add("all-reduce", (2,), torch.int32)  # the valid-label counts
        if ep and n_moe and tp > 1:
            for rows in live:  # once a layer: the recompute stops before the combine (moe._group_psum)
                add("all-reduce", (rows * seq, cfg.d_model), dtype, n_moe)  # the experts' outputs
                add("all-reduce", (), torch.int64, n_moe)  # the dropped count
                # the combine's backward (f): the tokens' and the router's gradients
                add("all-reduce", (rows * seq, cfg.d_model), dtype, n_moe)
                add("all-reduce", (cfg.d_model, cfg.moe.n_experts), router_dt, n_moe)


def _largest_divisor(n: int, cap: int) -> int:
    c = min(cap, n)
    while n % c:
        c -= 1
    return c


def _head_split_schedule(cfg, mesh, named, ep, live, n_micro, seq, D, add, add_first):
    """A head-split step's terms before the reductions ("tp", "ep"): the
    gathers at use once a step; each microbatch's counts; each live data
    shard's group pass (``models.tp_train``: the forward's sums, gathers
    and psums, twice where a checkpointed layer's recompute reaches them,
    the backward's f and transposes once), after a gradient-free first
    pass of every live shard on the local MoE path over several of them.
    Returns the leaves' :class:`tp_train.LeafPlan` list."""
    dtype = TF.compute_dtype(cfg)
    lay = TT.train_layout(cfg, mesh)
    lplans = TT.leaf_plans(lay, mesh, [(names, tuple(leaf.shape), spec) for names, leaf, spec in named], ep)
    for (names, leaf, spec), lp in zip(named, lplans):
        cur = list(block_shape(mesh, spec, tuple(leaf.shape)))
        for d, axes in lp.gathers:
            cur[d] *= mesh.axis_size(axes)
            add("all-gather", cur, leaf.dtype)
    tp = lay.tp
    d = cfg.d_model
    two_pass = cfg.moe is not None and len(live) > 1 and not ep
    s_text = seq - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)

    def group(r: int, grad: bool):
        """One data shard of ``r`` rows over its model group."""
        if tp == 1:
            return
        put = add if grad else add_first
        twice = 2 if grad else 1  # a checkpointed layer's recompute

        def fwd(shape, dt, redone: bool):
            put("all-reduce", shape, dt, twice if redone else 1)

        def bwd(kind, shape, dt):
            if grad:
                put(kind, shape, dt)

        def attn(rows_s, redone, src=None):  # f (and f of a cross-attention's source), then g
            bwd("all-reduce", (r, rows_s, d), dtype)
            if src is not None:
                bwd("all-reduce", (r, src, d), dtype)
            fwd((r, rows_s, d), dtype, redone)

        def ffn(rows_s, redone):
            bwd("all-reduce", (r, rows_s, d), dtype)
            fwd((r, rows_s, d), dtype, redone)

        def layer(g, S, has_ffn, remat):
            if g.kind == "ssm":
                if lay.ssm_tp:
                    s = cfg.ssm
                    conv = s.expand * d + 2 * s.n_groups * s.d_state
                    bwd("all-reduce", (r, S, d), dtype)  # f
                    if lay.conv_tp:
                        put("all-gather", (r, S, conv), dtype, twice if remat else 1)
                        bwd("reduce-scatter", (r, S, conv // tp), dtype)
                    put("all-reduce", (r, S, 1), torch.float32, twice if remat else 1)  # the gated norm's sums
                    bwd("all-reduce", (r, S, 1), torch.float32)
                    fwd((r, S, d), dtype, remat and has_ffn)
            else:
                attn(S, remat and has_ffn)
            if not has_ffn:
                return
            ffn(S, False)
            if g.has_moe and not ep:
                bwd("all-reduce", (r * S, cfg.moe.top_k), torch.float32)  # f of the gates

        fwd((r, s_text, d), dtype, False)  # the vocabulary-parallel embedding
        plan_ = TF.build_plan(cfg)
        if cfg.encoder_layers:
            T = cfg.encoder_tokens
            for _ in range(cfg.encoder_layers):
                attn(T, False)
                ffn(T, False)
            (st,) = plan_
            for _ in range(st.reps):
                attn(seq, True)
                attn(seq, True, src=T)
                ffn(seq, False)
        else:
            for st in plan_:
                for _ in range(st.reps):
                    for g in st.specs:
                        layer(g, seq, g.has_moe or cfg.d_ff > 0, True)

        def loss(S):
            bwd("all-reduce", (r, S, d), dtype)  # f: the head's input
            c = _largest_divisor(S, 1024)
            vb = -(-cfg.vocab_padded // tp) * tp
            put("all-gather", (r, c, vb), dtype, (S // c) * twice)

        loss(s_text)
        if cfg.mtp_depth:
            fwd((r, s_text - 1, d), dtype, False)  # the MTP embedding
            layer(TF.GroupSpec("attn", True, False), seq - 1, cfg.d_ff > 0, False)
            loss(seq - 1)

    for _ in range(n_micro):
        if D > 1:
            add("all-reduce", (2,), torch.int32)  # the valid-label counts
        if two_pass:
            for r in live:
                group(r, grad=False)
        for r in live:
            group(r, grad=True)
    return lplans


def _head_split_reduce(mesh, baxes, leaf, spec, lp, add) -> None:
    """A head-split step's reduction of one leaf's gradient
    (``steps._reduce_head_split``)."""
    block = list(block_shape(mesh, spec, tuple(leaf.shape)))
    cur = list(block)
    for d, _ in lp.gathers:
        cur[d] = leaf.shape[d]
    if lp.reduce == "psum":
        add("all-reduce", cur, torch.float32)
    if lp.reduce != "none" and lp.mdim is not None:
        cur[lp.mdim] = block[lp.mdim]
    gathered = dict(lp.gathers)
    used = ()
    for d in range(len(spec)):
        inb = tuple(a for a in spec.dim_axes(d) if a in baxes)
        if not inb:
            continue
        used += inb
        if d not in gathered:
            continue
        cur[d] = block[d]
        if mesh.axis_size(inb) > 1:
            add("reduce-scatter", cur, torch.float32)
    rest = tuple(a for a in baxes if a not in used)
    if rest and mesh.axis_size(rest) > 1:
        add("all-reduce", cur, torch.float32)


def serve_param_gathers(lay, mesh, named_specs, cast: bool):
    """The gathers at use a sharded step runs, in order, once a step:
    ``(names, dim, axes, result_shape, dtype)`` each (an ``all-gather``
    over ``axes`` along ``dim``; result shapes with padding, as GSPMD
    pads).  ``named_specs``: ``(names, shape, dtype, spec)`` a leaf."""
    dtype = TF.compute_dtype(lay.cfg)
    out = []
    for names, shape, dt, spec in named_specs:
        need = SD.serve_leaf_need(lay, names, tuple(shape))
        if need is None:
            continue
        _, gathers = SD.serve_leaf_access(mesh, spec, tuple(shape), need)
        if gathers and cast and names[0] == "stages" and dt == torch.float32:
            dt = dtype
        cur = list(block_shape(mesh, spec, tuple(shape)))
        for d, axes in gathers:
            cur[d] *= mesh.axis_size(axes)
            out.append((names, d, axes, tuple(cur), dt))
    return out


def _grouped(cfg: ModelConfig, q_lo: int, q_hi: int) -> Tuple[int, int]:
    """(KV heads, group) query heads ``[q_lo, q_hi)`` attend as
    (``layers.group_kv``)."""
    nq = q_hi - q_lo
    g = cfg.n_heads // cfg.n_kv_heads
    if q_lo % g == 0 and nq % g == 0:
        return nq // g, g
    if nq and q_lo // g == (q_hi - 1) // g:
        return 1, nq
    return nq, 1


def serve_collectives(cfg: ModelConfig, mesh: Mesh, strategy: str, shape) -> Tuple[Dict[str, int], Dict[str, int]]:
    """The collectives one sharded prefill or decode step of ``shape`` (a
    ``shapes.ShapeSpec``: its kind, batch and sequence, the decode cache's
    capacity) issues over ``mesh`` under ``strategy``: (calls by kind,
    device 0's result bytes by kind), the schedule of
    ``serving.sharded_prefill``/``sharded_decode_step`` as a formula over
    the plan.  Collectives over groups of one are not run."""
    calls = dict.fromkeys(COLLECTIVES, 0)
    nbytes = dict.fromkeys(COLLECTIVES, 0)

    def add(kind, shp, dtype, times=1):
        calls[kind] += times
        nbytes[kind] += times * math.prod(shp) * _itemsize(dtype)

    with ST.strategy_context(mesh, strategy) as (plan, ep_axis):
        cast = TF.ACT_CTX["cast_params"]
        params = SH.params_struct(cfg)
        specs = SD.param_specs(cfg, mesh, params, plan)
    lay = SD.serve_layout(cfg, mesh, shape.batch, shape.kind)
    named = [(names, tuple(leaf.shape), leaf.dtype, spec) for (names, leaf), (_, spec) in
             zip(ST._named_leaves(params), ST._named_leaves(specs))]
    for *_, res, dt in serve_param_gathers(lay, mesh, named, cast):
        add("all-gather", res, dt)

    dtype = TF.compute_dtype(cfg)
    d, T = cfg.d_model, lay.tp
    tp = T > 1
    decode = shape.kind == "decode"
    b0 = lay.batch if lay.seq_shard else min(-(-lay.batch // lay.dp_size), lay.batch)
    n_seq = mesh.shape.get("data", 1) if lay.seq_shard else 1
    S = 1 if decode else shape.seq
    s_text = S - (cfg.frontend_tokens if cfg.frontend == "vision" and not decode else 0)
    if tp:
        add("all-reduce", (b0, s_text, d), dtype)  # the vocabulary-parallel embedding

    def softmax_over_slots(lead, ctx):  # the slot axis split over "data"
        if n_seq > 1:
            add("all-reduce", lead + (1,), torch.float32, 2)  # pmax, the sum of exponentials
            add("all-reduce", ctx, dtype)

    def attn_decode(slots):
        q_lo, q_hi = lay.q_heads(0)
        e0, e1 = lay.hd_block(0)
        kv, g = _grouped(cfg, q_lo, q_hi) if q_hi > q_lo else (0, 0)
        lb = -(-slots // n_seq)
        if lay.attn == "hd" and tp:
            add("all-reduce", (b0, kv, g, 1, lb), dtype)  # the scores over head_dim blocks
        softmax_over_slots((b0, kv, g, 1), (b0, 1, kv, g, e1 - e0))
        if tp:
            add("all-reduce", (b0, 1, d), dtype)

    def out_psum(rows_s):
        if tp:
            add("all-reduce", (b0, rows_s, d), dtype)

    def mixer(g):
        if g.kind == "ssm":
            s = cfg.ssm
            if lay.conv_tp and tp:
                add("all-gather", (b0, S, s.expand * d + 2 * s.n_groups * s.d_state), dtype)
            if lay.ssm_tp and tp:
                add("all-reduce", (b0, S, 1), torch.float32)
                add("all-reduce", (b0, S, d), dtype)
        elif decode and cfg.mla is not None:
            h0, h1 = lay.mla_heads(0)
            width = cfg.mla.kv_lora_rank if SV.MLA_ABSORBED["enabled"] else cfg.mla.v_head_dim
            softmax_over_slots((b0, h1 - h0, 1), (b0, 1, h1 - h0, width))  # latent or value context
            out_psum(1)
        elif decode:
            window = cfg.sliding_window if (not g.is_global and cfg.sliding_window) else None
            attn_decode(min(shape.seq, window) if window else shape.seq)
        else:
            out_psum(S)

    def ffn(g):
        if not (g.has_moe or cfg.d_ff > 0):
            return
        ep = ep_axis is not None and strategy in ("ep", "ep_fsdp")
        if g.has_moe and not ep and lay.batch_sharded and lay.dp_size > 1:
            add("all-gather", (lay.dp_size, cfg.moe.n_experts), torch.float32)  # the loads before this shard's
        out_psum(S)

    plan_ = TF.build_plan(cfg)
    if cfg.encoder_layers:
        if not decode:
            for _ in range(cfg.encoder_layers):
                out_psum(cfg.encoder_tokens)
                out_psum(cfg.encoder_tokens)
        (st,) = plan_
        for _ in range(st.reps):
            mixer(st.specs[0])
            if decode:  # the cross-attention against enc_kv's blocks
                attn_decode(cfg.encoder_tokens)
            else:
                out_psum(S)
            ffn(st.specs[0])
    else:
        for st in plan_:
            for _ in range(st.reps):
                for g in st.specs:
                    mixer(g)
                    ffn(g)
    return calls, nbytes


def executor_terms(cfg: ModelConfig, n_data: int, n_micro: int, batch: int, strategy: str) -> dict:
    """What the port's step does beyond the reference's program because it
    runs the data shards one at a time, kept out of the roofline: on the
    local MoE path over several data shards (an MoE arch under "tp" or
    "fsdp_flat"), a gradient-free first forward of every data shard a
    microbatch (``moe.ShardStats``), and each MoE layer's load and
    importance (``[2, E]`` float32 a shard) handed from one shard's run to
    the next.  (:func:`plan_cell` adds the first pass's collectives, which
    the step runs uncounted, as ``first_pass_collectives``.)"""
    lo, hi = ST.shard_rows(batch // n_micro, n_data)
    live = sum(1 for a, b in zip(lo, hi) if b > a)
    first_pass = cfg.moe is not None and live > 1 and strategy not in ("ep", "ep_fsdp")
    return {
        "gradient_free_first_pass": first_pass,
        "first_pass_shard_forwards": n_micro * live if first_pass else 0,
        "moe_stats_bytes": n_micro * _n_moe_layers(cfg) * live * 2 * cfg.moe.n_experts * 4 if first_pass else 0,
    }


def plan_cell(arch: str, shape_name: str, mesh: Mesh, strategy: str = "tp") -> dict:
    """One cell's plan, per-device bytes, collectives and roofline."""
    cfg = get_config(arch)
    shape = SH.SHAPES[shape_name]
    ok, reason = SH.cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "strategy": strategy, "status": "skipped", "reason": reason}
    t0 = time.time()
    ax = SD.mesh_axes(mesh)
    dp_size = math.prod(mesh.shape[a] for a in ax.dp)
    n_chips = dp_size * mesh.shape[ax.tp]
    with ST.strategy_context(mesh, strategy) as (plan, _):
        params = SH.params_struct(cfg)
        pspecs = SD.param_specs(cfg, mesh, params, plan)
        memory = {"params_bytes_per_device": tree_bytes_per_device(mesh, params, pspecs)}
        extra: dict = {}
        collectives = None
        if shape.kind == "train":
            bx = SD.batch_axes(cfg, mesh, plan)
            n_micro = SH.grad_accum_steps(cfg, shape, mesh.axis_size(bx))
            opt = adamw.init(params)
            memory["opt_bytes_per_device"] = tree_bytes_per_device(mesh, opt, SD.opt_specs(cfg, mesh, opt, plan))
            binputs = SH.train_inputs(cfg, shape)
            bspecs = SD.batch_specs(cfg, mesh, plan)
            memory["batch_bytes_per_device"] = tree_bytes_per_device(
                mesh, binputs, {k: bspecs[k] for k in binputs})
            first: dict = {}
            calls, nbytes = step_collectives(cfg, mesh, strategy, n_micro, shape.batch, shape.seq, first_pass=first)
            collectives = {"calls": calls, "bytes": nbytes,
                           "source": "launch.dryrun.step_collectives (sharded_train_step's schedule)"}
            ex = executor_terms(cfg, mesh.axis_size(bx), n_micro, shape.batch, strategy)
            ex["first_pass_collectives"] = first.get("calls", dict.fromkeys(COLLECTIVES, 0))
            extra = {"n_micro": n_micro, "executor_only": ex}
        elif shape.kind == "prefill":
            binputs = SH.prefill_inputs(cfg, shape)
            bspecs = SD.batch_specs(cfg, mesh)
            memory["batch_bytes_per_device"] = tree_bytes_per_device(
                mesh, binputs, {k: bspecs[k] for k in binputs})
        else:
            token, cache = SH.decode_inputs(cfg, shape)
            cspecs = SD.cache_specs(cfg, mesh, cache, shape.batch)
            memory["cache_bytes_per_device"] = tree_bytes_per_device(mesh, cache, cspecs)
            tspec = SD.P(ax.dp_spec, None) if shape.batch >= dp_size else SD.P(None, None)
            memory["batch_bytes_per_device"] = tree_bytes_per_device(mesh, token, tspec)
        if shape.kind != "train":
            calls, nbytes = serve_collectives(cfg, mesh, strategy, shape)
            lay = SD.serve_layout(cfg, mesh, shape.batch, shape.kind)
            collectives = {"calls": calls, "bytes": nbytes,
                           "source": "launch.dryrun.serve_collectives (the sharded serve step's schedule)",
                           "layout": {"attn": lay.attn, "seq_shard": lay.seq_shard,
                                      "ssm_tp": lay.ssm_tp, "conv_tp": lay.conv_tp}}
    memory["total_bytes_per_device"] = sum(memory.values())
    specs = {"/".join(names): list(spec) for names, spec in ST._named_leaves(pspecs)}
    rl = RL.analyze(cfg, shape, n_chips, n_micro=extra.get("n_micro", 1),
                    by_kind=collectives["bytes"] if collectives else None)
    return {
        "arch": arch,
        "shape": shape_name,
        "strategy": strategy,
        "mesh": dict(mesh.shape),
        "n_chips": n_chips,
        "status": "planned",
        "plan_s": round(time.time() - t0, 2),
        **extra,
        "plan": specs,
        "memory": memory,
        "collectives": collectives,
        "roofline": rl.to_dict(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SH.SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--strategy", default="tp", choices=list(ST.STRATEGIES))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--device", default=None, help="the meshes' device (default cuda)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")

    mesh = make_production_mesh(multi_pod=args.mesh == "multi", device=args.device)
    cells = [(a, s) for a in ARCH_IDS for s in SH.SHAPES] if args.all else [(args.arch, args.shape)]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        tag = f"{arch}x{shape}x{args.mesh}" + (f"x{args.tag}" if args.tag else "")
        try:
            res = plan_cell(arch, shape, mesh, strategy=args.strategy)
        except Exception as e:  # a failure here is a bug in the system
            failures += 1
            res = {"arch": arch, "shape": shape, "strategy": args.strategy, "status": "FAILED",
                   "error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-2000:]}
        with open(os.path.join(args.out, f"{tag}.json"), "w") as f:
            json.dump(res, f, indent=2)
        line = {k: v for k, v in res.items() if k not in ("trace", "roofline", "memory", "plan", "collectives")}
        if "roofline" in res:
            r = res["roofline"]
            line["bottleneck"] = r["bottleneck"]
            line["t(c/m/x) ms"] = (f"{1e3 * r['t_compute_s']:.2f}/{1e3 * r['t_memory_s']:.2f}/"
                                   f"{1e3 * r['t_collective_s']:.2f}")
            line["gb/dev"] = round(res["memory"]["total_bytes_per_device"] / 2**30, 2)
        if res.get("collectives"):
            line["collectives"] = {k: v for k, v in res["collectives"]["calls"].items() if v}
        print(json.dumps(line), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
