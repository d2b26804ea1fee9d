"""Operator-overloaded Assoc algebra: the paper's Fig. 1 one-liners
(port of ``repro.d4m.algebra``).

The operators live on :class:`repro_torch.core.assoc.Assoc` and delegate to
the module functions (``add``, ``elem_mul``, ``matmul``, ``transpose``,
``extract_row``, ``get``); :func:`cap_policy` supplies the output
capacities, the semiring and the spGEMM fanout bound::

    from repro_torch.d4m import cap_policy, MAX_MIN

    C = A + B                 # element-wise semiring add   (table union)
    I = A & B                 # element-wise semiring mul   (intersection)
    with cap_policy(matmul_cap=1 << 14, max_fanout=24):
        sq = A @ A.T          # semiring spGEMM
    row = A[src_ip, :]        # Fig. 1: nearest neighbours of a vertex
    ids, counts = (A + A.T).topk(10)   # heavy hitters

On the card, ``+`` runs the ``merge_add`` kernel and ``&``, ``@`` and the
slices run the ``sort_dedup`` kernel.
"""
from __future__ import annotations

from repro_torch.core.assoc import Assoc, OpPolicy, cap_policy, current_policy

__all__ = ["Assoc", "OpPolicy", "cap_policy", "current_policy"]
