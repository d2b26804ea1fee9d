"""The port's sharded train step (``launch.steps.make_train_step(...,
dp_spec=)``) under "tp" and "fsdp_flat" on a 2 x 2 ``(data, model)`` mesh
of the CPU, and "tp" at 2 x 3 (uneven splits, padded), against the reference's unsharded step (GSPMD keeps the
values): dense (qwen2), MoE (phi3.5-moe, also with capacity dropping
tokens: the data shards' dispatch must rank as the one global dispatch
does) and MTP (deepseek-v3) reduced archs in float32, two microbatches,
labels masked unevenly across the data shards.  The loss, the gradient
norm and the first moments (the gradients) within 1e-4; the params as
``test_torch_train_step.py`` holds them.  Each step's collectives, counted
by the mesh, equal ``launch.dryrun.step_collectives``."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import _torch_train as T
from repro.launch import steps as JST
from repro.optim import adamw as JA
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as TST
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import sharding as TSD
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw as TA
from repro_torch.optim.adamw import tree_leaves

B, MICRO = 8, 2  # fsdp_flat: 4 data shards of one row a microbatch
CASES = {"qwen2_0_5b": {}, "phi3_5_moe": {}, "phi3_5_moe-drops": {"capacity_factor": 0.5}, "deepseek_v3": {}}


def _batch(cfg):
    tokens, labels, _ = T.batch(cfg, b=B)
    labels[0, :9] = -100  # the data shards' counts of valid labels differ
    labels[5, 3:6] = -100
    return tokens, labels


@functools.lru_cache(maxsize=None)
def reference(case):
    """The reference's unsharded step: (params, cfgs, batch, new state, metrics)."""
    arch = case.split("-")[0]
    cfg, tc = T.configs(arch)
    if CASES[case]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **CASES[case]))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **CASES[case]))
    jstate = JST.init_train_state(jax.random.PRNGKey(0), cfg)
    tokens, labels = _batch(cfg)
    step = jax.jit(JST.make_train_step(cfg, JA.AdamWConfig(warmup_steps=0), n_micro=MICRO, ep_axis=None))
    new, m = step(jstate, {"tokens": tokens, "labels": labels})
    return (jax.tree.map(np.asarray, jstate["params"]), tc, tokens, labels,
            jax.tree.map(np.asarray, new), {k: float(v) for k, v in m.items()})


def assert_step_matches(new, m, want_state, want_m, what):
    """Metrics, moments and params of a gathered state against a
    reference step's (``test_train_step_two_microbatches_matches_reference``'s
    criterion: an entry whose moment is under the tolerance may move by 2 lr)."""
    for k in ("loss", "nll", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), want_m[k], rtol=1e-5, err_msg=f"{what} {k}")
    for got, want in zip(tree_leaves(new["opt"]["m"]), jax.tree.leaves(want_state["opt"]["m"])):
        assert T.rel_err(got.numpy(), np.asarray(want)) <= T.REL, what
    lr = want_m["lr"]
    for got, want, mom in zip(tree_leaves(new["params"]), jax.tree.leaves(want_state["params"]),
                              jax.tree.leaves(want_state["opt"]["m"])):
        want, mom = np.asarray(want), np.asarray(mom)
        unsure = np.abs(mom) < T.REL * np.abs(mom).max()
        assert (np.abs(got.numpy() - want) <= T.REL * np.abs(want).max() + 2 * lr * unsure).all(), what


def run_sharded(params, tc, tokens, labels, strategy, mesh):
    """One sharded step from ``params``: the gathered new state, the
    metrics, and the mesh's (calls, bytes)."""
    state = {"params": params, "opt": TA.init(params)}
    with TST.strategy_context(mesh, strategy) as (plan, ep_axis):
        placed = TST.place_train_state(state, tc, mesh, plan)
        step = TST.make_train_step(tc, TA.AdamWConfig(warmup_steps=0), n_micro=MICRO, ep_axis=ep_axis,
                                   dp_spec=TSD.batch_axes(tc, mesh, plan))
        mesh.reset_collectives()
        new, m = step(placed, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
        counted = dict(mesh.collectives), dict(mesh.collective_bytes)
    return TST.gather_train_state(new, "cpu"), m, counted


@pytest.mark.parametrize("strategy,grid", [("tp", (2, 2)), ("fsdp_flat", (2, 2)), ("tp", (2, 3))])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_the_reference(case, strategy, grid):
    """At 2 x 3 "tp" splits widths that 3 does not divide: the blocks are
    padded as GSPMD pads them."""
    jparams, tc, tokens, labels, want_state, want_m = reference(case)
    mesh = make_local_mesh(data=grid[0], model=grid[1], device="cpu")
    new, m, counted = run_sharded(params_from_numpy(jparams, device="cpu"), tc, tokens, labels, strategy, mesh)
    assert_step_matches(new, m, want_state, want_m, (case, strategy))
    assert counted == DR.step_collectives(tc, mesh, strategy, MICRO, B, tokens.shape[1]), (case, strategy)
    assert counted[0]["all-gather"] > 0 and counted[0]["all-reduce"] > 0
    assert (counted[0]["reduce-scatter"] > 0) == (strategy == "fsdp_flat")
    if grid[1] == 3:  # some leaves' splits are uneven
        params = params_from_numpy(jparams, device="cpu")
        specs = TST._named_leaves(TSD.param_specs(tc, mesh, params, "tp"))
        assert any(spec.dim_axes(d) and x.shape[d] % 3 for (_, x), (_, spec) in zip(TST._named_leaves(params), specs)
                   for d in range(x.ndim))
