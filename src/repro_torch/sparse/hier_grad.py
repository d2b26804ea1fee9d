"""Hierarchical sparse embedding gradients (port of
``repro.sparse.hier_grad``).

The input-embedding table is a streamed-update parameter: each microbatch
contributes hypersparse ``(token_id, grad_row)`` pairs, ingested into a
:class:`~repro_torch.sparse.row_accum.HierRowAccum` cascade; once per
optimizer step the cascade is flushed and a row-sparse ("lazy") AdamW
update touches only the flushed rows of ``(table, m, v)``.  Lazy AdamW is
not dense AdamW: rows not touched in a step skip their moment decay; the
two agree when every row is touched.

:func:`sparse_adamw_row_update` updates ``table``, ``m`` and ``v`` in
place (the reference returns new arrays and its callers donate the old
ones): at full width the three are 2 GB, so the port does not copy them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..optim.adamw import AdamWConfig, lr_schedule
from . import row_accum as RA


@dataclasses.dataclass(frozen=True)
class HierGradConfig:
    cuts: Tuple[int, ...] = (8192, 65536)
    top_capacity: int = 1 << 20


def init_accumulator(cfg: HierGradConfig, tokens_per_micro: int, d: int, device=None) -> RA.HierRowAccum:
    """Empty cascade for ``tokens_per_micro`` pairs a microbatch, on the
    card unless ``device="cpu"``."""
    return RA.hier_init(cfg.cuts, cfg.top_capacity, tokens_per_micro, d, device=device)


def accumulate_microbatch(
    acc: RA.HierRowAccum,
    token_ids: torch.Tensor,  # [B, S]
    grad_rows: torch.Tensor,  # [B, S, d] cotangent of the gathered embeddings
    cfg: HierGradConfig,
) -> RA.HierRowAccum:
    ids = token_ids.reshape(-1)
    rows = grad_rows.reshape(ids.shape[0], -1)
    return RA.hier_update(acc, ids, rows, cfg.cuts)


def sparse_adamw_row_update(
    flushed: RA.RowAccum,
    table: torch.Tensor,  # [V, d]
    m: torch.Tensor,  # [V, d] float32
    v: torch.Tensor,  # [V, d] float32
    step: torch.Tensor,
    opt: AdamWConfig,
    scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lazy AdamW on exactly the flushed rows (gather, update, write back),
    in place; returns ``(table, m, v)``.

    Every slot is gathered (row 0 for PAD slots) and updated; only live
    rows are written, so a PAD slot never touches the table.  Ids follow
    the reference's index rules: a negative id wraps to ``V + id``, one
    still outside ``[0, V)`` writes nothing.  One host sync (the count of
    live rows)."""
    nrows = table.shape[0]
    ids = flushed.ids.to(torch.int64)
    idx = torch.where(ids < 0, ids + nrows, ids)
    live = (ids != RA.PAD) & (idx >= 0) & (idx < nrows)
    gather_idx = torch.where(live, idx, 0)
    g = flushed.rows * scale
    m_rows = m[gather_idx]
    v_rows = v[gather_idx]
    p_rows = table[gather_idx]
    step_f = (step + 1).to(torch.float32)
    lr = lr_schedule(opt, step + 1)
    m2 = opt.b1 * m_rows + (1 - opt.b1) * g
    v2 = opt.b2 * v_rows + (1 - opt.b2) * g * g
    mhat = m2 / (1 - opt.b1**step_f)
    vhat = v2 / (1 - opt.b2**step_f)
    p32 = p_rows.to(torch.float32)
    delta = mhat / (torch.sqrt(vhat) + opt.eps) + opt.weight_decay * p32
    p_new = (p32 - lr * delta).to(table.dtype)
    sel = live.nonzero().squeeze(1)  # host sync
    dst = idx[sel]
    table.index_copy_(0, dst, p_new[sel])
    m.index_copy_(0, dst, m2[sel])
    v.index_copy_(0, dst, v2[sel])
    return table, m, v


def dense_grad_of(acc_flushed: RA.RowAccum, vocab: int) -> torch.Tensor:
    """The accumulated sparse gradient as a dense ``[vocab, d]`` table
    (the ``scatter_add`` kernel on the card)."""
    return RA.to_dense(acc_flushed, vocab)
