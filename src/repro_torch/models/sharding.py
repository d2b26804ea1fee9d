"""Sharding plans: parameter/optimizer/activation PartitionSpecs per config
(port of ``repro.models.sharding``).

Axes convention (``launch/mesh.py``):
* single-pod:  (data=16, model=16)
* multi-pod:   (pod=2, data=16, model=16) — "pod" extends the data axis.

Parallelism:
* **TP** over ``model``: attention heads, FFN hidden, MoE experts (EP),
  vocab dim of embedding/head, mamba inner channels.
* **DP** over ``dp = (pod, data)``: batch.
* **FSDP** over ``dp`` for configs whose replicated parameters would not fit
  (jamba-398B, deepseek-671B): each TP-sharded tensor is additionally sharded
  over ``dp`` on a second dimension; optimizer state follows parameters,
  giving ZeRO-3 semantics.
* **SP** (long-context decode): KV caches shard their sequence axis over
  ``data`` when the batch is too small to fill the DP axis (long_500k: B=1).

The plan is path-pattern based: rules match the last components of each
parameter path, with leading stacked dims (stacked layers) auto-padded.
The specs are :class:`repro_torch.core.mesh.PartitionSpec`\\ s over a
:class:`repro_torch.core.mesh.Mesh`; the trees are the port's param, opt
and cache trees (nested dicts, lists and tuples of tensors, or of
``device="meta"`` tensors for shapes alone), whose paths name the same
leaves as the reference's once sequence indices are dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

from repro_torch.core.mesh import Mesh, NamedSharding
from repro_torch.core.mesh import PartitionSpec as P

from .config import ModelConfig

DP_THRESHOLD_PARAMS = 60e9  # FSDP for anything whose f32 opt state won't replicate

#: leaves every strategy replicates (norms, scalars, the router's bias)
_REPLICATED = ("scale", "bias", "A_log", "D", "dt_bias", "router_bias")


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: Tuple[str, ...]  # data-parallel axes (("pod","data") or ("data",))
    tp: str = "model"

    @property
    def dp_spec(self):
        return self.dp if len(self.dp) > 1 else self.dp[0]


def mesh_axes(mesh: Mesh) -> MeshAxes:
    names = mesh.axis_names
    dp = tuple(a for a in names if a != "model")
    return MeshAxes(dp=dp)


def use_fsdp(cfg: ModelConfig) -> bool:
    return cfg.param_count() > DP_THRESHOLD_PARAMS


# Sharding strategies (--strategy in the launchers):
#   "tp"        — baseline: TP over "model", DP over the rest, +FSDP for the
#                 398B/671B configs (paper-faithful Megatron-style layout).
#   "fsdp_flat" — NO tensor parallelism; every weight is sharded over ALL
#                 mesh axes flattened (ZeRO-3) and the batch shards over all
#                 axes too.
#   "ep" / "ep_fsdp" — expert parallelism (moe.apply_moe_shardmap) over
#                 "tp"'s or "fsdp_flat"'s plan, the experts split over "model".
def _fsdp_flat_spec(shape: Tuple[int, ...], mesh: Mesh, ax: MeshAxes) -> P:
    """ZeRO-3: shard the largest evenly-divisible dim over as many mesh axes
    as divide it (prefer the full flattened mesh)."""
    candidates = [
        tuple(ax.dp) + (ax.tp,),  # whole mesh
        tuple(ax.dp),  # data axes only
        (ax.tp,),  # model axis only
    ]
    sizes = []
    for axes in candidates:
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        sizes.append(n)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for axes, n in zip(candidates, sizes):
        for i in order:
            if shape[i] % n == 0 and shape[i] >= n:
                spec = [None] * len(shape)
                spec[i] = axes if len(axes) > 1 else axes[0]
                return P(*spec)
    return P()


def _rule(cfg: ModelConfig, ax: MeshAxes, path: Tuple[str, ...], ndim: int, strategy: str = "tp") -> P:
    """Base PartitionSpec for a parameter, by path suffix."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    tp = ax.tp
    fsdp = ax.dp_spec if use_fsdp(cfg) else None

    # ---- embeddings ------------------------------------------------------
    if name == "table":
        return P(tp, fsdp)  # [V, d]
    if name == "head":
        return P(fsdp, tp)  # [d, V]

    # ---- norms / scalars -------------------------------------------------
    if name in _REPLICATED:
        return P()

    # ---- attention -------------------------------------------------------
    if name in ("wq", "wk", "wv"):
        return P(fsdp, tp)  # [d, H*hd]
    if name == "wo":
        return P(tp, fsdp)  # [H*hd, d]
    if name in ("bq", "bk", "bv"):
        return P(tp)

    # ---- MLA -------------------------------------------------------------
    if name == "wdq":
        return P(fsdp, tp)  # [d, q_lora] - shard the latent dim
    if name == "wuq":
        return P(None, tp)  # [q_lora, H*qk] - heads sharded
    if name == "wdkv":
        return P(fsdp, None)  # [d, r] latent replicated over tp (shared by heads)
    if name == "wk_rope":
        return P(fsdp, None)
    if name == "wukv":
        return P(None, tp)  # [r, H*(nope+v)]

    # ---- MoE ------------------------------------------------------------
    if name == "router":
        return P(fsdp, None)  # [d, E] logits computed everywhere
    if parent == "moe" and name in ("wg", "wu"):
        return P(tp, fsdp, None)  # [E, d, f]: EP over tp, FSDP over d
    if parent == "moe" and name == "wd":
        return P(tp, fsdp, None)  # [E, f, d]
    # shared experts / dense FFN
    if name in ("wg", "wu"):
        return P(fsdp, tp)  # [d, f]
    if name == "wd":
        return P(tp, fsdp)  # [f, d]

    # ---- mamba ----------------------------------------------------------
    if name == "in_proj":
        return P(fsdp, tp)  # [d, 2*di+2*g*N+H]
    if name == "conv_w":
        return P(None, tp)  # [K, conv_dim]
    if name == "conv_b":
        return P(tp)
    if name == "out_proj":
        return P(tp, fsdp)  # [d_inner, d]

    # ---- misc (mtp proj etc.) -------------------------------------------
    if name == "proj":
        return P(fsdp, tp)
    return P()  # replicate by default


def _pad_spec(spec: P, ndim: int) -> P:
    """Prepend None for stacked leading dims (stacked layers / enc stacks)."""
    pad = ndim - len(spec)
    if pad <= 0:
        return spec
    return P(*([None] * pad + list(spec)))


def _path_names(path) -> Tuple[str, ...]:
    """The dict keys along a path (sequence indices dropped, as the
    reference drops its ``[i]`` entries)."""
    return tuple(str(e) for e in path if not isinstance(e, int))


def tree_map_with_path(fn: Callable, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of nested dicts, lists and tuples; a
    path holds dict keys and sequence indices (ints)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _is_expert(names: Tuple[str, ...]) -> bool:
    return len(names) >= 2 and names[-2] == "moe" and names[-1] in ("wg", "wu", "wd")


def _leaf_spec(cfg: ModelConfig, mesh: Mesh, ax: MeshAxes, names, leaf, strategy: str) -> P:
    if strategy in ("fsdp_flat", "ep_fsdp"):
        if names and names[-1] in _REPLICATED:
            return P()
        if strategy == "ep_fsdp" and _is_expert(names):
            # expert weights keep the EP layout the shard_map expects
            return _pad_spec(P(ax.tp, None, None), leaf.ndim)
        return _fsdp_flat_spec(tuple(leaf.shape), mesh, ax)
    spec = _pad_spec(_rule(cfg, ax, names if names else ("",), leaf.ndim), leaf.ndim)
    # sanity: divisibility is not required (GSPMD pads), but rank must fit
    assert len(spec) <= leaf.ndim, (names, spec, tuple(leaf.shape))
    return spec


def param_specs(cfg: ModelConfig, mesh: Mesh, params_shape, strategy: str = "tp") -> Any:
    """PartitionSpec tree matching ``params_shape`` (a param tree, of
    ``meta`` tensors for shapes alone)."""
    ax = mesh_axes(mesh)
    return tree_map_with_path(
        lambda path, leaf: _leaf_spec(cfg, mesh, ax, _path_names(path), leaf, strategy), params_shape
    )


def opt_specs(cfg: ModelConfig, mesh: Mesh, opt_shape, strategy: str = "tp") -> Any:
    """Optimizer state shards exactly like params (ZeRO under FSDP)."""
    ax = mesh_axes(mesh)

    def one(path, leaf):
        names = _path_names(path)
        if names and names[-1] == "step":
            return P()
        # strip the leading "m"/"v" component to reuse the param rules
        names = names[1:] if names and names[0] in ("m", "v") else names
        return _leaf_spec(cfg, mesh, ax, names, leaf, strategy)

    return tree_map_with_path(one, opt_shape)


# ---------------------------------------------------------------------------
# activations / inputs
# ---------------------------------------------------------------------------

def batch_axes(cfg: ModelConfig, mesh: Mesh, strategy: str = "tp"):
    """Mesh axes the global batch shards over."""
    ax = mesh_axes(mesh)
    if strategy == "fsdp_flat":
        return tuple(ax.dp) + (ax.tp,)  # batch over the whole mesh
    return ax.dp_spec


def batch_specs(cfg: ModelConfig, mesh: Mesh, strategy: str = "tp") -> Any:
    """Training batch: shard batch over the strategy's batch axes."""
    dp = batch_axes(cfg, mesh, strategy)
    return {
        "tokens": P(dp, None),
        "labels": P(dp, None),
        **({"frontend": P(dp, None, None)} if cfg.frontend or cfg.encoder_layers else {}),
    }


def cache_specs(cfg: ModelConfig, mesh: Mesh, cache_shape, batch: int) -> Any:
    """Decode cache sharding.

    batch >= dp size: shard batch over dp; tensors' dim 0 is batch.
    batch < dp size (long_500k): SP — shard the cache *sequence* axis over
    "data" and SSM state heads over "model".
    """
    ax = mesh_axes(mesh)
    dp = ax.dp_spec
    dp_size = 1
    for a in ax.dp:
        dp_size *= mesh.shape[a]
    seq_shard = batch < dp_size
    tp_size = mesh.shape[ax.tp]
    # KV cache TP: shard kv-heads when they divide the axis; otherwise shard
    # the head_dim (128/64 always divides 16)
    kv_tp = ax.tp if cfg.n_kv_heads % tp_size == 0 else None
    hd_tp = None if kv_tp is not None else (ax.tp if cfg.hd % tp_size == 0 else None)
    # MLA latents replicate over "model": they are head-shared by design
    mla_r_tp = None
    mla_dr_tp = None
    ssm_tp = None
    if cfg.ssm is not None:
        n_ssm_heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        ssm_tp = ax.tp if n_ssm_heads % tp_size == 0 else None
        conv_dim = cfg.ssm.expand * cfg.d_model + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
        conv_tp = ax.tp if conv_dim % tp_size == 0 else None
    else:
        conv_tp = None

    def one(path, leaf):
        names = _path_names(path)
        name = names[-1] if names else ""
        nd = leaf.ndim
        if name == "pos":
            return P()
        if name == "enc_kv":  # [L, 2, B, T, kvh, hd]
            if seq_shard:
                return P(None, None, None, "data", kv_tp, hd_tp)
            return P(None, None, dp, None, kv_tp, hd_tp)
        # stacked leading dim(s) from stacked stages: pad later
        if name in ("k", "v"):  # [B, S, kvh, hd]
            spec = P(None, "data", kv_tp, hd_tp) if seq_shard else P(dp, None, kv_tp, hd_tp)
        elif name == "ckv":  # [B, S, r]
            spec = P(None, "data", mla_r_tp) if seq_shard else P(dp, None, mla_r_tp)
        elif name == "krope":  # [B, S, dr]
            spec = P(None, "data", mla_dr_tp) if seq_shard else P(dp, None, mla_dr_tp)
        elif name == "kpos":  # [B, S]
            spec = P(None, "data") if seq_shard else P(dp, None)
        elif name == "ssm":  # [B, H, hd, N]
            spec = P(None, ssm_tp, None, None) if seq_shard else P(dp, ssm_tp, None, None)
        elif name == "conv":  # [B, K-1, C]
            spec = P(None, None, conv_tp) if seq_shard else P(dp, None, conv_tp)
        else:
            spec = P()
        pad = nd - len(spec)
        if pad > 0:
            spec = P(*([None] * pad + list(spec)))
        return spec

    return tree_map_with_path(one, cache_shape)


def shardings_of(mesh: Mesh, specs) -> Any:
    return tree_map_with_path(lambda _, s: NamedSharding(mesh, s), specs)


# ---------------------------------------------------------------------------
# sharded serving: the head-split layout and what each leaf must give it
# ---------------------------------------------------------------------------

def ceil_ranges(n: int, k: int) -> Tuple[Tuple[int, int], ...]:
    """``[lo, hi)`` of each of ``k`` GSPMD blocks of an extent ``n``
    (``ceil(n / k)`` a block; the last blocks may be short or empty)."""
    b = -(-n // k)
    return tuple((min(j * b, n), min((j + 1) * b, n)) for j in range(k))


@dataclasses.dataclass(frozen=True)
class ServeLayout:
    """How a sharded prefill or decode step splits its work over a
    ``(dp..., "model")`` mesh: the compute that :func:`param_specs`' "tp"
    plan and :func:`cache_specs` imply.

    * ``kind``: "decode", "prefill" or "encoder" (whisper's
      ``prefill_encoder``, which stages the decode cache's ``enc_kv``).
    * The batch lies over the data axes when ``batch >= dp size``; below
      it (``long_500k``) every data shard holds the whole batch and the
      cache's slot axis is split over "data" (``seq_shard``).
    * Attention heads over "model", by ``attn``: "kv" (each model shard
      its KV heads and their query groups; ``n_kv_heads % tp == 0``), "hd"
      (a cache split on ``head_dim``: each shard that block of every head,
      the partial scores summed over "model" before the softmax) or "q"
      (each shard a ceil block of query heads, over a replicated cache or,
      without one, over the KV heads those heads read).
    * MLA: a ceil block of heads; its latents replicated.
    * Mamba-2: state heads over "model" where ``ssm_tp`` (else every shard
      all of them), conv channels where ``conv_tp``.
    * FFN columns, expert blocks and vocabulary blocks: GSPMD's ceil
      blocks over "model"."""

    cfg: ModelConfig = dataclasses.field(repr=False)
    kind: str
    tp: int
    dp: Tuple[str, ...]
    dp_size: int
    batch: int
    seq_shard: bool
    attn: str
    ssm_tp: bool
    conv_tp: bool

    @property
    def batch_sharded(self) -> bool:
        return not self.seq_shard

    def prefill(self) -> "ServeLayout":
        """The layout a cache-free pass takes (whisper's encoder, the cross
        K/V of a prefill): no slot axis, no "hd" split."""
        attn = "kv" if self.attn == "kv" else "q"
        return dataclasses.replace(self, kind="prefill", seq_shard=False, attn=attn)

    def q_heads(self, j: int) -> Tuple[int, int]:
        """Model shard ``j``'s query heads (every head under "hd")."""
        cfg = self.cfg
        if self.attn == "hd":
            return 0, cfg.n_heads
        if self.attn == "kv":
            n = cfg.n_heads // self.tp
            return j * n, (j + 1) * n
        return ceil_ranges(cfg.n_heads, self.tp)[j]

    def kv_heads(self, j: int) -> Tuple[int, int]:
        """The KV heads model shard ``j`` computes: its own under "kv";
        every one under "hd" and against a replicated cache (it writes them
        all); in a prefill's "q" those its query heads read."""
        cfg = self.cfg
        if self.attn == "kv":
            n = cfg.n_kv_heads // self.tp
            return j * n, (j + 1) * n
        if self.attn == "hd" or self.kind != "prefill":
            return 0, cfg.n_kv_heads
        lo, hi = self.q_heads(j)
        if hi <= lo:
            return 0, 0
        g = cfg.n_heads // cfg.n_kv_heads
        return lo // g, (hi - 1) // g + 1

    def hd_block(self, j: int) -> Tuple[int, int]:
        return ceil_ranges(self.cfg.hd, self.tp)[j] if self.attn == "hd" else (0, self.cfg.hd)

    def mla_heads(self, j: int) -> Tuple[int, int]:
        return ceil_ranges(self.cfg.n_heads, self.tp)[j]

    def ssm_heads(self, j: int) -> Tuple[int, int]:
        s = self.cfg.ssm
        n = s.expand * self.cfg.d_model // s.head_dim
        return ceil_ranges(n, self.tp)[j] if self.ssm_tp else (0, n)

    def conv_channels(self, j: int) -> Tuple[int, int]:
        s = self.cfg.ssm
        c = s.expand * self.cfg.d_model + 2 * s.n_groups * s.d_state
        return ceil_ranges(c, self.tp)[j] if self.conv_tp else (0, c)

    def vocab(self, j: int) -> Tuple[int, int]:
        return ceil_ranges(self.cfg.vocab_padded, self.tp)[j]


def serve_layout(cfg: ModelConfig, mesh: Mesh, batch: int, kind: str = "decode") -> ServeLayout:
    """The layout of a sharded ``kind`` step of ``batch`` rows over
    ``mesh`` (the conditions :func:`cache_specs` splits the cache by)."""
    ax = mesh_axes(mesh)
    tp = mesh.shape[ax.tp]
    dp_size = 1
    for a in ax.dp:
        dp_size *= mesh.shape[a]
    if cfg.n_kv_heads % tp == 0:
        attn = "kv"
    elif kind != "prefill" and cfg.hd % tp == 0:
        attn = "hd"
    else:
        attn = "q"
    ssm_tp = conv_tp = False
    if cfg.ssm is not None:
        ssm_tp = (cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim) % tp == 0
        conv_tp = (cfg.ssm.expand * cfg.d_model + 2 * cfg.ssm.n_groups * cfg.ssm.d_state) % tp == 0
    return ServeLayout(cfg, kind, tp, ax.dp, dp_size, batch, kind != "prefill" and batch < dp_size,
                       attn, ssm_tp, conv_tp)


def _scaled(ranges, k: int):
    return tuple((lo * k, hi * k) for lo, hi in ranges)


def serve_leaf_need(lay: ServeLayout, names: Tuple[str, ...], shape: Tuple[int, ...]):
    """What a sharded ``lay.kind`` step reads of the param leaf at path
    ``names`` (of ``shape``) on each model shard: ``None`` (nothing: the
    step does not use it), ``"whole"`` (the whole leaf), or ``(dim,
    ranges)``: model shard ``j`` reads ``[lo, hi) = ranges[j]`` of
    dimension ``dim`` (counted from the end, past stacked leading
    dimensions)."""
    cfg = lay.cfg
    js = range(lay.tp)
    name = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    top = names[0] if names else ""
    if top == "mtp" or (top == "encoder" and lay.kind == "decode"):
        return None
    if lay.kind == "encoder" and top not in ("encoder", "cross"):
        return None
    if top == "embed":
        return (-2 if name == "table" else -1, tuple(lay.vocab(j) for j in js))
    if name in _REPLICATED:
        return "whole"
    if parent == "attn":
        if top == "cross" and lay.kind == "decode" and name in ("wk", "wv", "bk", "bv"):
            return None  # a decode reads the staged enc_kv
        if top == "cross" and lay.kind == "encoder" and name in ("wq", "bq", "wo"):
            return None
        # whisper's encoder, and a prefill's cross K/V, split as a cache-free pass
        la = lay.prefill() if top == "encoder" or (top == "cross" and lay.kind == "prefill") else lay
        if la.attn == "hd":
            return "whole"
        if name in ("wq", "bq", "wo"):
            return (-2 if name == "wo" else -1, _scaled([la.q_heads(j) for j in js], cfg.hd))
        return (-1, _scaled([la.kv_heads(j) for j in js], cfg.hd))
    if parent == "mla":
        m = cfg.mla
        heads = [lay.mla_heads(j) for j in js]
        if name == "wuq":
            return (-1, _scaled(heads, m.qk_nope_dim + m.qk_rope_dim))
        if name == "wukv":
            return (-1, _scaled(heads, m.qk_nope_dim + m.v_head_dim))
        if name == "wo":
            return (-2, _scaled(heads, m.v_head_dim))
        return "whole"  # wdq (q_norm reads the whole latent), wdkv, wk_rope
    if parent == "ssm":
        if name in ("conv_w", "conv_b"):
            return (-1, tuple(lay.conv_channels(j) for j in js)) if lay.conv_tp else "whole"
        if name == "out_proj":
            return (-2, _scaled([lay.ssm_heads(j) for j in js], cfg.ssm.head_dim)) if lay.ssm_tp else "whole"
        return "whole"  # in_proj: its column blocks cut across z | x | B | C | dt
    if parent == "moe" and name in ("wg", "wu", "wd"):
        return (-3, ceil_ranges(shape[-3], lay.tp))
    if name in ("wg", "wu"):  # dense FFN and shared experts: column blocks
        return (-1, ceil_ranges(shape[-1], lay.tp))
    if name == "wd":
        return (-2, ceil_ranges(shape[-2], lay.tp))
    return "whole"  # the router


def serve_leaf_access(mesh: Mesh, spec: P, shape: Tuple[int, ...], need):
    """How a leaf placed by ``spec`` meets ``need``
    (:func:`serve_leaf_need`): ``("local", ())`` (every device holds what
    it reads: a replicated leaf, or model blocks that are the ranges),
    ``("local", gathers)`` (the model blocks, after an ``all-gather`` of
    each other split dimension over its data axes), or ``("whole",
    gathers)`` (an ``all-gather`` of every split dimension, then each shard
    slices its ranges).  ``gathers`` lists ``(dim, axes)`` in the order the
    gathers run."""
    nd = len(shape)
    split = [(d, spec.dim_axes(d)) for d in range(nd) if spec.dim_axes(d) and mesh.axis_size(spec.dim_axes(d)) > 1]
    if not split:
        return "local", ()
    if isinstance(need, tuple):
        dim = need[0] % nd
        ranges = need[1]
        own = [(d, ax) for d, ax in split if d == dim]
        rest = [(d, ax) for d, ax in split if d != dim]
        if (own and own[0][1] == ("model",) and all("model" not in ax for _, ax in rest)
                and tuple(ranges) == ceil_ranges(shape[dim], mesh.shape["model"])):
            return "local", tuple(rest)
    return "whole", tuple(split)
