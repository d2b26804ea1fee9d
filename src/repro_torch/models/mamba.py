"""Mamba-2 (SSD, state-space duality) mixer, chunked-scan formulation (port
of ``repro.models.mamba``).

Forward (prefill): the SSD block decomposition, an intra-chunk quadratic
term plus an inter-chunk state recurrence.  The reference carries the
recurrence with an exclusive ``lax.associative_scan`` over chunks; here it
is a sequential loop over the ``S / chunk`` chunks, equal to float
tolerance.

Decode: O(1) a token, ``state = a * state + dt * B x``; the cache is the
``[B, H, hd, d_state]`` state plus the depthwise-conv tail.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _dense_init, apply_norm, init_norm

Params = Dict[str, Any]


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return s, d_inner, n_heads


def init_mamba(gen, cfg: ModelConfig, device) -> Params:
    s, d_inner, n_heads = _dims(cfg)
    d = cfg.d_model
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return {
        # fused in_proj: z (gate), x, B, C, dt
        "in_proj": _dense_init(gen, (d, 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads), device),
        "conv_w": _dense_init(gen, (s.d_conv, conv_dim), device, scale=1.0 / math.sqrt(s.d_conv)),
        "conv_b": torch.zeros((conv_dim,), device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, device=device)),
        "D": torch.ones((n_heads,), device=device),
        "dt_bias": torch.zeros((n_heads,), device=device),
        "out_norm": init_norm(cfg, d_inner, device),
        "out_proj": _dense_init(gen, (d_inner, d), device),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    s, d_inner, n_heads = _dims(cfg)
    g = s.n_groups * s.d_state
    z, xbc, dt = torch.split(proj, [d_inner, d_inner + 2 * g, n_heads], dim=-1)
    return z, xbc, dt  # xbc feeds the conv; dt is per-head


def _conv_causal(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tail: torch.Tensor | None):
    """Depthwise causal conv along S, as the reference's K-term shifted sum
    (``F.conv1d`` would run under cuDNN, TF32 allowed, on the card).
    xbc: [B, S, C]; w: [K, C].  ``tail`` is the previous K-1 inputs for
    decode continuity."""
    K = w.shape[0]
    if tail is None:
        pad = torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = tail.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # [B, S+K-1, C]
    out = sum(xp[:, k : k + xbc.shape[1], :] * w[k].to(xbc.dtype) for k in range(K))
    new_tail = xp[:, -(K - 1) :, :]
    return F.silu(out + b.to(xbc.dtype)), new_tail


def ssd_chunked(
    cfg: ModelConfig,
    xh: torch.Tensor,  # [B, S, H, hd]
    dt: torch.Tensor,  # [B, S, H] (softplus'd, >0)
    A: torch.Tensor,  # [H] (positive decay rates)
    Bm: torch.Tensor,  # [B, S, G, N]
    Cm: torch.Tensor,  # [B, S, G, N]
    init_state: torch.Tensor | None = None,  # [B, H, hd, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y [B,S,H,hd], final_state [B,H,hd,N])."""
    s = cfg.ssm
    B_, S, H, hd = xh.shape
    N = Bm.shape[3]
    Q = min(s.chunk, S)
    S_orig = S
    if S % Q:  # pad ragged tails: dt=0 -> unit decay, zero contribution
        pad = Q - S % Q

        def z(x):
            return F.pad(x, [0, 0] * (x.ndim - 2) + [0, pad])

        xh, dt, Bm, Cm = z(xh), z(dt), z(Bm), z(Cm)
        S = S + pad
    nC = S // Q
    rep = H // Bm.shape[2]
    Bh = torch.repeat_interleave(Bm, rep, dim=2)  # [B, S, H, N]
    Ch = torch.repeat_interleave(Cm, rep, dim=2)

    # per-step log decay l_t = -dt_t * A (A > 0), in float32
    ldec = (-dt * A[None, None, :]).float()  # [B, S, H]
    ldec_c = ldec.reshape(B_, nC, Q, H)
    # dt-weighted input in the compute dtype (dt stays f32 for the decays)
    xc = (xh * dt.to(xh.dtype)[..., None]).reshape(B_, nC, Q, H, hd)
    Bc = Bh.reshape(B_, nC, Q, H, N)
    Cc = Ch.reshape(B_, nC, Q, H, N)

    cum = torch.cumsum(ldec_c, dim=2)  # [B, nC, Q, H] inclusive
    total = cum[:, :, -1, :]  # [B, nC, H] chunk total decay

    # ---- intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j.  The exp
    # argument is clamped BEFORE exp on masked entries (exp of the positive
    # upper triangle would overflow)
    li = cum[:, :, :, None, :]  # [B,nC,Q,1,H]
    lj = cum[:, :, None, :, :]  # [B,nC,1,Q,H]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))[None, None, :, :, None]
    larg = torch.where(mask, li - lj, -1e30)
    Lmat = torch.where(mask, torch.exp(larg), 0.0)
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Cc, Bc) * Lmat.to(xh.dtype)
    y_intra = torch.einsum("bcqkh,bckhd->bcqhd", scores, xc)

    # ---- chunk states: sum_j exp(total - cum_j) * B_j x_j^T
    w_end = torch.exp(total[:, :, None, :] - cum)  # [B,nC,Q,H] decay to chunk end
    chunk_state = torch.einsum("bcqh,bcqhn,bcqhd->bchdn", w_end.to(xh.dtype), Bc, xc)

    # ---- inter-chunk recurrence: state_c = exp(total_c) * state_{c-1} + chunk_state_c
    decay = torch.exp(total).float()  # [B, nC, H]
    st0 = chunk_state.float()
    if init_state is not None:
        st0 = torch.cat(
            [(st0[:, 0] + decay[:, 0][..., None, None] * init_state.float())[:, None], st0[:, 1:]], dim=1
        )
    states = [st0[:, 0]]  # inclusive: states[c] = state after chunk c
    for c in range(1, nC):
        states.append(st0[:, c] + states[-1] * decay[:, c][..., None, None])
    final_state = states[-1]
    first = init_state.float() if init_state is not None else torch.zeros_like(final_state)
    st_in = torch.stack([first] + states[:-1], dim=1)  # [B, nC, H, hd, N] state entering chunk c

    # ---- inter-chunk output: C_i . (decay to i) . state_in
    w_in = torch.exp(cum)  # decay from chunk start to position i (inclusive of i)
    y_inter = torch.einsum("bcqhn,bchdn,bcqh->bcqhd", Cc, st_in.to(xh.dtype), w_in.to(xh.dtype))
    y = (y_intra + y_inter).reshape(B_, S, H, hd)
    return y[:, :S_orig], final_state.to(xh.dtype)


def project(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """The fused ``in_proj``: ``(z, xbc, dt)`` (``xbc`` feeds the conv)."""
    return _split_proj(cfg, torch.einsum("bsd,dp->bsp", x, p["in_proj"].to(x.dtype)))


def ssm_heads(
    p: Params,
    cfg: ModelConfig,
    xbc: torch.Tensor,  # [B, S, conv_dim] after the conv
    z: torch.Tensor,  # [B, S, d_inner] gate
    dt: torch.Tensor,  # [B, S, H] before softplus
    heads: Tuple[int, int],
    state: torch.Tensor | None = None,  # [B, h, hd, N] of these heads
    step: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSM of state heads ``[h0, h1)``: the chunked scan (from
    ``state`` if given) or, with ``step``, one recurrent decode step
    (``state = a * state + dt * B x``).  Returns (the gated output [B, S,
    (h1 - h0) * hd], before the norm; the new state)."""
    s, d_inner, n_heads = _dims(cfg)
    h0, h1 = heads
    B, S = xbc.shape[0], xbc.shape[1]
    g = s.n_groups * s.d_state
    xi, Bm, Cm = torch.split(xbc, [d_inner, g, g], dim=-1)
    xh = xi.reshape(B, S, n_heads, s.head_dim)[:, :, h0:h1]
    rep = n_heads // s.n_groups  # each head's group, repeated onto the head axis
    Bh = torch.repeat_interleave(Bm.reshape(B, S, s.n_groups, s.d_state), rep, dim=2)[:, :, h0:h1]
    Ch = torch.repeat_interleave(Cm.reshape(B, S, s.n_groups, s.d_state), rep, dim=2)[:, :, h0:h1]
    dt_act = F.softplus(dt.float()[..., h0:h1] + p["dt_bias"][h0:h1])  # [B, S, h]
    A = torch.exp(p["A_log"][h0:h1])  # > 0
    D = p["D"][h0:h1].to(xbc.dtype)
    if step:
        x1, dt1 = xh[:, 0], dt_act[:, 0]
        a = torch.exp(-dt1 * A[None, :])  # [B, h]
        upd = torch.einsum("bhd,bhn->bhdn", x1 * dt1[..., None].to(xbc.dtype), Bh[:, 0])
        new_state = a[..., None, None].to(xbc.dtype) * state + upd
        y = (torch.einsum("bhdn,bhn->bhd", new_state, Ch[:, 0]) + x1 * D[None, :, None])[:, None]
    else:
        y, new_state = ssd_chunked(cfg, xh, dt_act, A, Bh, Ch, state)
        y = y.to(xbc.dtype) + xh * D[None, None, :, None]  # skip
    y = y.reshape(B, S, (h1 - h0) * s.head_dim) * F.silu(z[..., h0 * s.head_dim:h1 * s.head_dim])
    return y, new_state


def gated_out(p: Params, y: torch.Tensor) -> torch.Tensor:
    """The gated norm over ``d_inner`` and ``out_proj``."""
    return torch.einsum("bsi,id->bsd", apply_norm(p["out_norm"], y), p["out_proj"].to(y.dtype))


def apply_mamba(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, S, d]
    state: Tuple[torch.Tensor, torch.Tensor] | None = None,  # (ssm_state, conv_tail)
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence forward (prefill).  Returns (y, new_state)."""
    z, xbc, dt = project(p, cfg, x)
    xbc, new_tail = _conv_causal(xbc, p["conv_w"], p["conv_b"], None if state is None else state[1])
    y, new_ssm = ssm_heads(p, cfg, xbc, z, dt, (0, _dims(cfg)[2]), None if state is None else state[0])
    return gated_out(p, y).to(x.dtype), (new_ssm, new_tail)


def decode_step_mamba(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, 1, d]
    state: Tuple[torch.Tensor, torch.Tensor],  # (ssm_state [B,H,hd,N], conv_tail [B,K-1,C])
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """O(1) recurrent decode step."""
    z, xbc, dt = project(p, cfg, x)
    xbc, new_tail = _conv_causal(xbc, p["conv_w"], p["conv_b"], state[1])
    y, new_ssm = ssm_heads(p, cfg, xbc, z, dt, (0, _dims(cfg)[2]), state[0], step=True)
    return gated_out(p, y).to(x.dtype), (new_ssm, new_tail)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    s, d_inner, n_heads = _dims(cfg)
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    ssm = torch.zeros((batch, n_heads, s.head_dim, s.d_state), dtype=dtype, device=device)
    tail = torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device)
    return ssm, tail
