"""The dry run's serve cells on the CPU: ``launch.dryrun.serve_collectives``
(the sharded prefill and decode steps' schedule as a formula over the
plan) against the mesh's counters of real steps of the ten reduced archs
at 2 x 2, one prefill and one decode (the batch over "data", and below
it: the sequence-parallel branch) each, under "tp", and under the other
strategies for the MoE archs; ``plan_cell`` filling ``"collectives"`` for
the production mesh's decode cells, ``long_500k``'s with the
sequence-parallel softmax's all-reduces."""
import pytest
import torch

import _torch_serve_shard as H
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import dryrun as DR
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as TF

_PARAMS = {}


def params(cfg):
    if cfg not in _PARAMS:
        _PARAMS[cfg] = TF.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return _PARAMS[cfg]


def check(arch, strategy):
    cfg = H.config(arch)
    p, m = params(cfg), H.mesh()
    for batch in (4, 1):
        leaves = H.seed_cache_leaves(cfg, batch)
        toks = H.tokens(cfg, batch, 1)
        _, _, counted = H.sharded_decode(p, cfg, m, strategy, leaves, toks)
        assert counted == DR.serve_collectives(cfg, m, strategy, SH.ShapeSpec("d", "decode", H.CAP, batch)), \
            (arch, strategy, batch)
    pb = H.prefill_batch(cfg, 4)
    _, counted = H.sharded_prefill(p, cfg, m, strategy, pb)
    seq = H.PREFILL_SEQ + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    assert counted == DR.serve_collectives(cfg, m, strategy, SH.ShapeSpec("p", "prefill", seq, 4)), (arch, strategy)
    assert counted[0]["all-reduce"] > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_collectives_formula_equals_the_counters(arch):
    check(arch, "tp")


@pytest.mark.parametrize("strategy", ["fsdp_flat", "ep", "ep_fsdp"])
def test_serve_collectives_under_the_other_strategies(strategy):
    for arch in ("phi3_5_moe", "jamba_1_5_large"):
        check(arch, strategy)


def test_plan_cell_reports_serve_collectives():
    mesh = make_production_mesh(device="cpu")
    dec = DR.plan_cell("h2o_danube3_4b", "decode_32k", mesh, "tp")
    long = DR.plan_cell("h2o_danube3_4b", "long_500k", mesh, "tp")
    pre = DR.plan_cell("h2o_danube3_4b", "prefill_32k", mesh, "tp")
    for cell in (dec, long, pre):
        assert cell["collectives"] is not None and cell["collectives"]["calls"]["all-reduce"] > 0
        assert cell["roofline"]["t_collective_s"] > 0
    assert not dec["collectives"]["layout"]["seq_shard"] and long["collectives"]["layout"]["seq_shard"]
    # long_500k (batch 1 below 16 data shards): the slot axis over "data", the
    # softmax combined by a pmax and two psums in each of the 24 layers
    assert long["collectives"]["calls"]["all-reduce"] - dec["collectives"]["calls"]["all-reduce"] == 3 * 24
