"""Head-split tensor-parallel training (``launch.steps.sharded_train_step``
under "tp" and "ep": ``models.tp_train``) for the ten ``reduced()`` archs
on a 2 x 2 ``(data, model)`` mesh of the CPU, in float32, two
microbatches: "tp" against the port's unsharded step, "ep" against the
gather-at-use executor of the same plan (``moe.apply_moe_shardmap`` on each
data shard's leader; ``test_torch_shard_step_ep.py`` holds both to the
reference's ``shard_map`` run); the loss and every first moment within
1e-4.  Every replicated leaf (norms, the router, Mamba-2's scalars) comes
out equal on all four devices, which holds only if its gradient was whole
and equal on both model shards; the counters equal
``launch.dryrun.step_collectives``, the backward's all-reduces included;
and on every model shard of every data shard the embedding's backward runs
``scatter_add`` once a microbatch."""
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.kernels.scatter_add import ops as scatter_ops
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import sharding as SD
from repro_torch.models import tp_train as TT
from repro_torch.optim import adamw as TA
from repro_torch.optim.adamw import tree_leaves

B, S, MICRO = 8, 16, 2


def _case(arch):
    cfg = reduced(get_config(arch))
    state = ST.init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (B, S), generator=gen).to(torch.int32)
    lab = tok.clone()
    lab[0, :9] = -100  # the data shards' counts of valid labels differ
    batch = {"tokens": tok, "labels": lab}
    if cfg.frontend == "vision":
        batch["frontend"] = torch.randn((B, cfg.frontend_tokens, cfg.d_model), generator=gen)
    elif cfg.encoder_layers:
        batch["frontend"] = torch.randn((B, cfg.encoder_tokens, cfg.d_model), generator=gen)
    return cfg, state, batch


def _sharded(cfg, state, batch, strategy, monkeypatch=None, leader=False):
    mesh = make_local_mesh(data=2, model=2, device="cpu")
    calls = []
    with ST.strategy_context(mesh, strategy) as (plan, ep_axis):
        placed = ST.place_train_state(state, cfg, mesh, plan)
        step = ST.make_train_step(cfg, TA.AdamWConfig(warmup_steps=0), n_micro=MICRO, ep_axis=ep_axis,
                                  dp_spec=SD.batch_axes(cfg, mesh, plan))
        if leader:
            monkeypatch.setattr(ST, "head_split", lambda *a: False)
        else:
            real = scatter_ops.scatter_add_plain
            monkeypatch.setattr(scatter_ops, "scatter_add_plain",
                                lambda ids, rows, dense: calls.append(rows.shape) or real(ids, rows, dense))
        mesh.reset_collectives()
        new, m = step(placed, batch)
        counted = dict(mesh.collectives), dict(mesh.collective_bytes)
    return new, m, counted, mesh, calls


def _close(new, m, want, wm, what):
    assert abs(float(m["loss"]) - float(wm["loss"])) <= 1e-4 * abs(float(wm["loss"])), what
    got = ST.gather_train_state(new, "cpu")
    for a, c in zip(tree_leaves(got["opt"]["m"]), tree_leaves(want["opt"]["m"])):
        assert float((a - c).abs().max()) <= 1e-4 * max(float(c.abs().max()), 1e-12), what


def _replicated_equal(new):
    for names, sh in ST._named_leaves(new["params"]):
        if not sh.sharding.spec.axes:
            assert all(torch.equal(sh.shards[0], x) for x in sh.shards[1:]), names


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_head_split_tp_step_matches_the_unsharded_step(arch, monkeypatch):
    cfg, state, batch = _case(arch)
    want, wm = ST.make_train_step(cfg, TA.AdamWConfig(warmup_steps=0), n_micro=MICRO, ep_axis=None)(state, batch)
    new, m, counted, mesh, calls = _sharded(cfg, state, batch, "tp", monkeypatch)
    _close(new, m, want, wm, arch)
    _replicated_equal(new)
    seq = S + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    assert counted == DR.step_collectives(cfg, mesh, "tp", MICRO, B, seq), arch
    # the embedding's backward: every device's vocabulary block, each microbatch (MTP's embedding too)
    assert len(calls) == MICRO * mesh.size * (2 if cfg.mtp_depth else 1), arch
    # the norms read the replicated stream: whole gradients, no sum over "model"
    named = ST._named_leaves(state["params"])
    specs = ST._named_leaves(SD.param_specs(cfg, mesh, state["params"], "tp"))
    plans = TT.leaf_plans(TT.train_layout(cfg, mesh), mesh,
                          [(n, tuple(x.shape), sp) for (n, x), (_, sp) in zip(named, specs)], False)
    assert all(p.reduce == "none" for (n, _), p in zip(named, plans) if len(n) > 1 and n[-2] in TT.NORM_KEYS)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if reduced(get_config(a)).moe is not None])
def test_head_split_ep_step_matches_the_gather_at_use_executor(arch, monkeypatch):
    cfg, state, batch = _case(arch)
    new, m, counted, mesh, _ = _sharded(cfg, state, batch, "ep", monkeypatch)
    _replicated_equal(new)
    assert counted == DR.step_collectives(cfg, mesh, "ep", MICRO, B, S), arch
    with monkeypatch.context() as mp:
        old, om, _, _, _ = _sharded(cfg, state, batch, "ep", mp, leader=True)
    _close(new, m, ST.gather_train_state(old, "cpu"), om, arch)
