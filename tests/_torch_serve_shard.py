"""Shared pieces of the sharded-serving tests (``test_torch_shard_serve*``):
a decode cache filled from a seed as a ring after ``pos0`` tokens (random
K/V, latents and SSM state; ``kpos`` the positions each slot would hold),
the port's sharded steps over a ``(data, model)`` mesh of the CPU, and the
relative error the tests hold them to."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import serving as SV
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import tree_leaves, tree_unflatten

REL = 1e-4  # of max |logit|, float32
CAP, POS0, STEPS = 12, 9, 3  # cache capacity, position of the first decoded token, decode steps
PREFILL_SEQ = 8


def config(arch):
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


def ring_positions(slots: int, pos0: int) -> np.ndarray:
    """``kpos`` of a ring of ``slots`` after the tokens at positions
    ``0 .. pos0 - 1`` were written at ``pos % slots`` (-1: never written)."""
    t = np.arange(slots)
    last = pos0 - 1 - (pos0 - 1 - t) % slots
    return np.where(last >= 0, last, -1).astype(np.int32)


def seed_cache_leaves(cfg, batch, seed=0, pos0=POS0, cap=CAP):
    """numpy values of every leaf of ``serving.init_cache(cfg, batch,
    cap)`` in ``tree_leaves`` order (the reference's leaf order too)."""
    rng = np.random.default_rng(seed)
    shape_tree = SV.init_cache(cfg, batch, cap, torch.float32, "meta")
    names = [n for n, _ in ST._named_leaves(shape_tree)]
    out = []
    for nm, leaf in zip(names, tree_leaves(shape_tree)):
        shape = tuple(leaf.shape)
        if nm[-1] == "pos":
            out.append(np.asarray(pos0, np.int32))
        elif nm[-1] == "kpos":
            out.append(np.broadcast_to(ring_positions(shape[-1], pos0), shape).copy())
        else:
            out.append((rng.normal(size=shape) * 0.5).astype(np.float32))
    return out


def port_cache(cfg, batch, leaves, cap=CAP):
    tree = SV.init_cache(cfg, batch, cap, torch.float32, "cpu")
    return tree_unflatten(tree, [torch.from_numpy(np.array(x, copy=True)) for x in leaves])


def tokens(cfg, batch, n, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, n)).astype(np.int32)


def frontend(cfg, batch, seed=2):
    if cfg.frontend == "vision":
        n = cfg.frontend_tokens
    elif cfg.encoder_layers:
        n = cfg.encoder_tokens
    else:
        return None
    return (np.random.default_rng(seed).normal(size=(batch, n, cfg.d_model)) * 0.02).astype(np.float32)


def mesh(data=2, model=2):
    return make_local_mesh(data=data, model=model, device="cpu")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def sharded_decode(params, cfg, m, strategy, cache_leaves, toks, fe=None, batch=None):
    """Teacher-forced logits [B, STEPS, V] of the port's sharded
    ``make_serve_step`` from the seed-made cache, the cache gathered back
    after the steps, and the mesh's collectives of the first step."""
    batch = toks.shape[0] if batch is None else batch
    with ST.strategy_context(m, strategy) as (plan, ep_axis):
        pp, pc = ST.place_serve_state(params, port_cache(cfg, batch, cache_leaves), cfg, m, strategy)
        if fe is not None and cfg.encoder_layers:
            pc = SV.sharded_prefill_encoder(pp, cfg, torch.from_numpy(fe), pc)
        step = ST.make_serve_step(cfg, ep_axis)
        outs, first = [], None
        for t in range(toks.shape[1]):
            m.reset_collectives()
            lg, pc = step(pp, pc, torch.from_numpy(toks[:, t:t + 1]))
            if first is None:
                first = (dict(m.collectives), dict(m.collective_bytes))
            outs.append(lg.gather().numpy())
    gathered = TF.tree_map(lambda x: x.gather(), pc)
    return np.concatenate(outs, axis=1), gathered, first


def unsharded_decode(params, cfg, cache_leaves, toks, fe=None):
    cache = port_cache(cfg, toks.shape[0], cache_leaves)
    if fe is not None and cfg.encoder_layers:
        cache = SV.prefill_encoder(params, cfg, torch.from_numpy(fe), cache)
    step = ST.make_serve_step(cfg, None)
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = step(params, cache, torch.from_numpy(toks[:, t:t + 1]))
        outs.append(lg.numpy())
    return np.concatenate(outs, axis=1), cache


def sharded_prefill(params, cfg, m, strategy, batch):
    with ST.strategy_context(m, strategy) as (plan, ep_axis):
        pp, _ = ST.place_serve_state(params, None, cfg, m, strategy)
        m.reset_collectives()
        lg = ST.make_prefill_step(cfg, ep_axis)(pp, {k: torch.from_numpy(v) for k, v in batch.items()})
        counted = dict(m.collectives), dict(m.collective_bytes)
    return lg.gather().numpy(), counted


def prefill_batch(cfg, batch, n=PREFILL_SEQ):
    out = {"tokens": tokens(cfg, batch, n, seed=3)}
    fe = frontend(cfg, batch)
    if fe is not None:
        out["frontend"] = fe
    return out
