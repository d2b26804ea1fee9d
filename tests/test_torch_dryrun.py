"""The port's dry run on the CPU (``launch/dryrun.py``, ``dryrun_assoc.py``,
``analysis/roofline.py`` and ``report.py``): the collective schedule as a
formula (``step_collectives``) against the mesh's counters of real sharded
steps of the ten reduced archs at 2 x 2, under every strategy; one
production-mesh cell per strategy through the command line, with
per-device bytes, roofline terms and collectives; the report's table;
``dryrun_assoc`` at D=4 (no collective on the paper design's update,
``all-to-all`` routing for ``ShardedAssoc``); and the roofline checks of
``tests/test_roofline.py`` that read no HLO, with the reference's
analytic terms."""
import json

import pytest
import torch

from repro.analysis import roofline as JRL
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.launch import shapes as JSH
from repro_torch.analysis import flops as FM
from repro_torch.analysis import report as RP
from repro_torch.analysis import roofline as RL
from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun as DR
from repro_torch.launch import dryrun_assoc as DA
from repro_torch.launch import shapes as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import sharding as SD


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_collectives_formula_equals_the_counters(arch):
    cfg = reduced(get_config(arch))
    state = ST.init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    b, s = 8, 16
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (b, s), generator=gen).to(torch.int32)
    batch = {"tokens": tok, "labels": tok}
    if cfg.frontend == "vision":
        batch["frontend"] = torch.randn((b, cfg.frontend_tokens, cfg.d_model), generator=gen)
    elif cfg.encoder_layers:
        batch["frontend"] = torch.randn((b, cfg.encoder_tokens, cfg.d_model), generator=gen)
    seq = s + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    mesh = make_local_mesh(data=2, model=2, device="cpu")
    for strategy in ST.STRATEGIES:
        with ST.strategy_context(mesh, strategy) as (plan, ep_axis):
            placed = ST.place_train_state(state, cfg, mesh, plan)
            mesh.reset_collectives()
            _, m = ST.make_train_step(cfg, n_micro=2, ep_axis=ep_axis,
                                      dp_spec=SD.batch_axes(cfg, mesh, plan))(placed, batch)
        assert torch.isfinite(m["loss"]), (arch, strategy)
        calls, nbytes = DR.step_collectives(cfg, mesh, strategy, 2, b, seq)
        assert mesh.collectives == calls, (arch, strategy, mesh.collectives, calls)
        assert mesh.collective_bytes == nbytes, (arch, strategy)


@pytest.mark.parametrize("strategy", ST.STRATEGIES)
def test_dryrun_cell_per_strategy(tmp_path, capsys, strategy):
    assert DR.main(["--arch", "qwen2_0_5b", "--shape", "train_4k", "--mesh", "single", "--strategy", strategy,
                    "--device", "cpu", "--out", str(tmp_path)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["status"] == "planned" and line["n_chips"] == 256
    with open(tmp_path / "qwen2_0_5bxtrain_4kxsingle.json") as f:
        cell = json.load(f)
    cfg = get_config("qwen2_0_5b")
    mem = cell["memory"]
    n_params = sum(x.numel() for x in ST.tree_leaves(SH.params_struct(cfg)))
    # every leaf's blocks cover it, padded by at most one block a leaf
    assert 4 * n_params <= 256 * mem["params_bytes_per_device"] or strategy in ("tp", "ep")
    assert mem["opt_bytes_per_device"] >= 2 * mem["params_bytes_per_device"]
    assert mem["total_bytes_per_device"] == sum(v for k, v in mem.items() if k != "total_bytes_per_device")
    assert cell["n_micro"] == JSH.grad_accum_steps(jget("qwen2_0_5b"), JSH.SHAPES["train_4k"],
                                                   256 if strategy == "fsdp_flat" else 16)
    calls, nbytes = DR.step_collectives(cfg, DR.make_production_mesh(device="cpu"), strategy, cell["n_micro"],
                                        256, 4096)
    assert cell["collectives"]["calls"] == calls and cell["collectives"]["bytes"] == nbytes
    r = cell["roofline"]
    assert r["collectives_by_kind"] == {k: float(v) for k, v in nbytes.items()}
    assert r["t_collective_s"] == pytest.approx(RL.collective_wire_bytes(nbytes) / RL.LINK_BW)
    table = SD.param_specs(cfg, DR.make_production_mesh(device="cpu"), SH.params_struct(cfg),
                           "tp" if strategy == "ep" else strategy)["embed"]["table"]
    assert cell["plan"]["embed/table"] == json.loads(json.dumps(list(table)))


@pytest.mark.parametrize("strategy", ST.STRATEGIES)
def test_executor_terms_stay_out_of_the_roofline(strategy):
    """An MoE cell's first pass over the data shards (the local path's, an
    artifact of running the shards in turn) is listed apart and moves no
    collective into the roofline; the expert-parallel path runs one pass."""
    mesh = DR.make_production_mesh(device="cpu")
    cell = DR.plan_cell("phi3_5_moe", "train_4k", mesh, strategy)
    ex = cell["executor_only"]
    local = strategy in ("tp", "fsdp_flat")
    assert ex["gradient_free_first_pass"] == local
    assert (ex["first_pass_shard_forwards"] > 0) == local and (ex["moe_stats_bytes"] > 0) == local
    calls, nbytes = DR.step_collectives(get_config("phi3_5_moe"), mesh, strategy, cell["n_micro"], 256, 4096)
    assert cell["roofline"]["collectives_by_kind"] == {k: float(v) for k, v in nbytes.items()}
    assert cell["roofline"]["wire_bytes_per_chip"] == RL.collective_wire_bytes(nbytes)
    assert cell["collectives"]["calls"] == calls


def test_dryrun_other_shapes_and_the_report(tmp_path):
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        assert DR.main(["--arch", "granite_3_8b", "--shape", shape, "--device", "cpu", "--out", str(tmp_path)]) == 0
    with open(tmp_path / "granite_3_8bxdecode_32kxsingle.json") as f:
        cell = json.load(f)
    assert cell["memory"]["cache_bytes_per_device"] > 0
    # the sharded decode step's schedule (dryrun.serve_collectives), in place of null
    assert cell["collectives"]["source"].startswith("launch.dryrun.serve_collectives")
    assert cell["collectives"]["calls"]["all-reduce"] > 0 and cell["roofline"]["t_collective_s"] > 0
    with open(tmp_path / "granite_3_8bxlong_500kxsingle.json") as f:
        assert json.load(f)["status"] == "skipped"
    table = RP.table(str(tmp_path), "single").splitlines()
    assert len(table) == 2 + 3 and "SKIP" in table[-1] and "| granite_3_8b | decode_32k | tp | ok |" in table[3]


def test_dryrun_assoc_at_four_shards(capsys):
    res = DA.run(devices=4, group=256, device="cpu")
    assert json.loads(capsys.readouterr().out.splitlines()[0])["bytes"]["devices"] == 4  # the bytes come first
    par, sh = res["parallel_hier_4"], res["sharded_assoc_4"]
    assert par["update_path_collective_free"] and sum(par["collectives"].values()) == 0
    assert sh["routes_via_all_to_all"]
    assert sh["collectives"] == {"all-gather": 0, "all-reduce": 1, "reduce-scatter": 0, "all-to-all": 3,
                                 "collective-permute": 0}
    assert res["shape"]["cuts"] == (256, 2560) and res["shape"]["top_capacity"] == 5120


# ---------------------------------------------------------------------------
# tests/test_roofline.py's checks that read no HLO
# ---------------------------------------------------------------------------

def test_collective_wire_factors():
    wire = RL.collective_wire_bytes({"all-reduce": 100.0, "all-gather": 50.0})
    assert wire == 250.0  # 2x AR + 1x AG
    assert wire == JRL.collective_wire_bytes({"all-reduce": 100.0, "all-gather": 50.0})


@pytest.mark.parametrize("arch", ["granite_3_8b", "phi3_5_moe", "mamba2_1_3b"])
def test_fwd_flops_vs_6nd(arch):
    cfg = get_config(arch)
    sh = SH.SHAPES["train_4k"]
    fwd = FM.fwd_flops(cfg, sh.batch, sh.seq)
    nd = 2.0 * cfg.active_param_count() * sh.batch * sh.seq
    assert 0.8 * nd < fwd < 3.0 * nd, (arch, fwd / nd)


def test_decode_bytes_dominated_by_params_or_cache():
    cfg = get_config("granite_3_8b")
    b = FM.decode_bytes(cfg, 128, 32768)
    p = cfg.param_count() * 2.0
    kv = FM.kv_cache_bytes(cfg, 128, 32768)
    assert abs(b - (p + kv)) / b < 0.01


def test_kv_cache_bytes_window_vs_global():
    danube, granite = get_config("h2o_danube3_4b"), get_config("granite_3_8b")
    assert FM.kv_cache_bytes(danube, 1, 524288) < FM.kv_cache_bytes(granite, 1, 524288) / 50
    m = get_config("mamba2_1_3b")
    assert FM.kv_cache_bytes(m, 1, 524288) == FM.kv_cache_bytes(m, 1, 1024)


@pytest.mark.parametrize("shape", list(SH.SHAPES))
def test_analyze_terms_equal_the_reference(shape):
    """The analytic terms equal the reference's (its HLO read empty); the
    times are the H100 constants'."""
    for arch in ("qwen2_0_5b", "phi3_5_moe"):
        by_kind = {"all-gather": 3e9, "all-reduce": 1e9}
        got = RL.analyze(get_config(arch), SH.SHAPES[shape], 256, n_micro=4, by_kind=by_kind)
        want = JRL.analyze(None, jget(arch), JSH.SHAPES[shape], 256, n_micro=4, hlo_text="")
        for k in ("flops_per_chip", "bytes_per_chip", "model_flops", "exec_flops_global", "useful_flops_ratio"):
            assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-12), (arch, shape, k)
        assert got.t_compute == got.flops_per_chip / 989e12 and got.t_memory == got.bytes_per_chip / 3.35e12
        assert got.t_collective == 5e9 / 450e9
        assert got.step_time == max(got.t_compute, got.t_memory, got.t_collective)
        assert got.mfu == pytest.approx(got.model_flops / (got.step_time * 256 * 989e12))
        d = got.to_dict()
        assert d["bottleneck"] == got.bottleneck and d["roofline_mfu"] == got.mfu
