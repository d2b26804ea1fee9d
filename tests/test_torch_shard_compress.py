"""Top-k compression of a sharded step's gradients
(``make_train_step(comp_cfg=..., dp_spec=...)``, ``steps.compress_blocks``)
on ``(data, model)`` meshes of the CPU.  Over placed blocks the function is
``compression.compress`` over the whole leaf bit for bit (the threshold from
an all-gather of the magnitudes, each block once, GSPMD's padding left out,
an uneven 2 x 3 split included), so ``sparse + residual == g + r`` holds
exactly.  A sharded compressed step against the unsharded compressed step
(``test_torch_compression.py`` holds that one to the reference): the loss
and the moments within 1e-4, the residual's kept entries the same except
within 1e-6 (of the leaf's max ``|g + r|``) of its threshold, the counters equal to
``step_collectives`` with the threshold's all-gathers."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.mesh import device_put
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import sharding as SD
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TC
from repro_torch.optim.adamw import tree_leaves, tree_map

CFG = TC.CompressionConfig(enabled=True, top_k_frac=0.05, min_size=2048)


def _tree(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    params = ST.init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")["params"]
    # quarter steps: many ties at the threshold
    return tree_map(lambda p: torch.round(torch.randn(p.shape, generator=gen) * 4) / 4, params)


@pytest.mark.parametrize("grid,strategy", [((2, 2), "tp"), ((2, 3), "tp"), ((2, 2), "fsdp_flat")])
def test_compress_blocks_is_compress_over_the_whole_leaf(grid, strategy):
    cfg = reduced(get_config("qwen2_0_5b"))
    g, r = _tree(cfg, 1), _tree(cfg, 2)
    want_s, want_r = TC.compress(g, r, CFG)
    mesh = make_local_mesh(data=grid[0], model=grid[1], device="cpu")
    specs = SD.shardings_of(mesh, SD.param_specs(cfg, mesh, g, strategy))
    gs, rs = device_put(g, specs, copy=True, pad=True), device_put(r, specs, copy=True, pad=True)
    named = ST._named_leaves(gs)
    mesh.reset_collectives()
    sparse, res = ST.compress_blocks(mesh, named, [list(sh.shards) for _, sh in named], ST._named_leaves(rs), CFG)
    big = [sh for _, sh in named if np.prod(sh.shape or tuple(sh.gather().shape)) >= CFG.min_size
           and any(mesh.shape[a] > 1 for a in sh.sharding.spec.axes)]
    assert mesh.collectives["all-gather"] == len(big) > 0
    for (names, sh), s_blocks, r_sh, ws, wr, gg, rr in zip(named, sparse, res, tree_leaves(want_s),
                                                           tree_leaves(want_r), tree_leaves(g), tree_leaves(r)):
        got_s = ST.Sharded(sh.sharding, tuple(s_blocks), sh.shape).gather("cpu")
        got_r = r_sh.gather("cpu")
        assert torch.equal(got_s, ws) and torch.equal(got_r, wr), names
        assert torch.equal(got_s + got_r, gg + rr), names
        for s, x in zip(s_blocks, r_sh.shards):  # block for block, padding included
            assert s.shape == x.shape


@pytest.mark.parametrize("strategy", ["tp", "fsdp_flat"])
def test_sharded_compressed_step_matches_the_unsharded_one(strategy):
    cfg = reduced(get_config("qwen2_0_5b"))
    params = ST.init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")["params"]
    state = {"params": params, "opt": TA.init(params), "residual": _tree(cfg, 3)}
    gen = torch.Generator().manual_seed(4)
    tok = torch.randint(0, cfg.vocab, (8, 16), generator=gen).to(torch.int32)
    batch = {"tokens": tok, "labels": tok}
    opt = TA.AdamWConfig(warmup_steps=0)
    want, wm = ST.make_train_step(cfg, opt, n_micro=2, ep_axis=None, comp_cfg=CFG)(state, batch)
    # the unsharded step's g + r, for the thresholds
    _, _, grads = ST.value_and_grad(cfg, None)(params, tok[:4], tok[:4], None)
    _, _, g2 = ST.value_and_grad(cfg, None)(params, tok[4:], tok[4:], None)
    mesh = make_local_mesh(data=2, model=2, device="cpu")
    with ST.strategy_context(mesh, strategy) as (plan, ep_axis):
        placed = ST.place_train_state(state, cfg, mesh, plan)
        mesh.reset_collectives()
        new, m = ST.make_train_step(cfg, opt, n_micro=2, ep_axis=ep_axis, comp_cfg=CFG,
                                    dp_spec=SD.batch_axes(cfg, mesh, plan))(placed, batch)
        counted = dict(mesh.collectives), dict(mesh.collective_bytes)
    assert counted == DR.step_collectives(cfg, mesh, strategy, 2, 8, 16, comp_cfg=CFG)
    assert abs(float(m["loss"]) - float(wm["loss"])) <= 1e-5 * float(wm["loss"])
    got = ST.gather_train_state(new, "cpu")
    for a, c in zip(tree_leaves(got["opt"]["m"]), tree_leaves(want["opt"]["m"])):
        assert float((a - c).abs().max()) <= 1e-4 * max(float(c.abs().max()), 1e-12)
    for gr, ga, gb, r, wr in zip(tree_leaves(got["residual"]), tree_leaves(grads), tree_leaves(g2),
                                 tree_leaves(state["residual"]), tree_leaves(want["residual"])):
        y = (ga + gb) / 2 + r
        if y.numel() < CFG.min_size:
            assert not gr.any() and not wr.any()
            continue
        k = max(1, int(y.numel() * CFG.top_k_frac))
        thresh = torch.topk(y.abs().reshape(-1), k).values[-1]
        # kept: the new residual is 0, which tells only where |g + r| is not ~0
        sure = ((y.abs() - thresh).abs() > 1e-6 * float(y.abs().max())) & (y.abs() > 1e-6 * float(y.abs().max()))
        assert torch.equal((gr != 0)[sure], (wr != 0)[sure])
        assert float((gr - wr)[sure].abs().max()) <= 1e-4 * float(y.abs().max())
