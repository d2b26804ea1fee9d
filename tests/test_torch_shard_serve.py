"""The port's sharded serving (``launch.steps.place_serve_state``,
``make_serve_step``/``make_prefill_step`` over a mesh: heads split over
"model", ``serving.sharded_decode_step``/``sharded_prefill``) against its
own unsharded steps on the CPU, float32 at the reduced configs, within
1e-4 of max |logit|: the ten architectures in both branches of
``cache_specs`` (the batch over "data"; the batch below the data axes,
``long_500k``'s sequence-parallel branch), each way a cache splits over
"model" (KV heads, ``head_dim``, replicated; SSM heads and conv channels),
the strategies, a padded batch, "tp" with FSDP rows, and the written
cache: every slot within the tolerance, ``kpos`` and ``pos`` exact."""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_serve_shard as H
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import steps as ST
from repro_torch.models import sharding as SD
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import tree_leaves

_PARAMS = {}


def params(cfg):
    if cfg not in _PARAMS:
        _PARAMS[cfg] = TF.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return _PARAMS[cfg]


def check_decode(arch, batch, grid=(2, 2), strategy="tp", cfg=None):
    cfg = cfg or H.config(arch)
    p = params(cfg)
    leaves = H.seed_cache_leaves(cfg, batch)
    toks = H.tokens(cfg, batch, H.STEPS)
    fe = H.frontend(cfg, batch)
    fe = fe if cfg.encoder_layers else None
    want, want_cache = H.unsharded_decode(p, cfg, leaves, toks, fe)
    got, got_cache, _ = H.sharded_decode(p, cfg, H.mesh(*grid), strategy, leaves, toks, fe)
    assert got.shape == want.shape
    assert H.rel(got, want) <= H.REL, (arch, batch, grid, strategy)
    for (names, a), b in zip(ST._named_leaves(got_cache), tree_leaves(want_cache)):
        if names[-1] in ("kpos", "pos"):
            assert torch.equal(a, b), (arch, names)
        else:
            assert H.rel(a.numpy(), b.numpy()) <= H.REL, (arch, names)
    return cfg


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_batch_over_data_matches_unsharded(arch):
    check_decode(arch, 4)


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "gemma3_27b", "jamba_1_5_large", "mamba2_1_3b",
                                  "deepseek_v3", "whisper_tiny"])
def test_decode_sequence_parallel_branch_matches_unsharded(arch):
    """Batch 1 below a data axis of 2 (``long_500k``): the cache's slot
    axis over "data", the token's slot written by the block that owns
    it, the softmax combined over "data" (a pmax and two psums)."""
    cfg = check_decode(arch, 1)
    assert SD.serve_layout(cfg, H.mesh(), 1).seq_shard


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_unsharded(arch):
    cfg = H.config(arch)
    p = params(cfg)
    batch = H.prefill_batch(cfg, 4)
    want = ST.make_prefill_step(cfg, None)(p, {k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    got, _ = H.sharded_prefill(p, cfg, H.mesh(), "tp", batch)
    assert got.shape == want.shape and H.rel(got, want) <= H.REL, arch


@pytest.mark.parametrize("grid,attn", [((2, 2), "kv"), ((2, 4), "hd"), ((2, 3), "q")])
def test_cache_split_over_model(grid, attn):
    """KV heads over "model" (2 KV heads over 2), ``head_dim`` over
    "model" (2 KV heads over 4: ``n_kv_heads % tp != 0``; the partial
    scores summed over "model"), and a replicated cache (over 3: neither
    divides; query heads in ceil blocks, one shard of padding heads),
    each with the batch over "data" and in the sequence-parallel branch."""
    cfg = H.config("h2o_danube3_4b")
    for batch, seq_shard in ((2, False), (1, True)):
        lay = SD.serve_layout(cfg, H.mesh(*grid), batch)
        assert (lay.attn, lay.seq_shard) == (attn, seq_shard)
        check_decode("h2o_danube3_4b", batch, grid)


def test_ssm_heads_and_conv_channels_over_model():
    cfg = H.config("mamba2_1_3b")
    lay = SD.serve_layout(cfg, H.mesh(), 4)
    assert lay.ssm_tp and lay.conv_tp
    specs = SD.cache_specs(cfg, H.mesh(), TF.tree_map(lambda x: x, H.port_cache(cfg, 4, H.seed_cache_leaves(cfg, 4))), 4)
    names = {n[-1]: s for n, s in ST._named_leaves(specs)}
    assert "model" in names["ssm"] and "model" in names["conv"]
    check_decode("mamba2_1_3b", 4)
    check_decode("mamba2_1_3b", 4, grid=(2, 3))  # neither split: every shard all heads and channels


@pytest.mark.parametrize("strategy", ["fsdp_flat", "ep", "ep_fsdp"])
def test_strategies(strategy):
    """ZeRO-3 inference (every leaf gathered at use), and the MoE layers
    through the expert-parallel path (batch small enough that no expert
    overflows: the per-shard capacity of ``apply_moe_shardmap`` then
    gives the unsharded output)."""
    check_decode("phi3_5_moe", 4, strategy=strategy)
    check_decode("h2o_danube3_4b", 1, strategy=strategy)


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "deepseek_v3", "whisper_tiny"])
def test_padded_slot_axis(arch):
    """Batch 1 over 5 data shards: 12 cache slots (and whisper's 16
    encoder tokens) in blocks of 3 (4), the last blocks GSPMD's padding,
    never read."""
    check_decode(arch, 1, grid=(5, 2))


def test_padded_batch():
    """3 rows over 2 data shards: GSPMD's padding row runs nothing."""
    check_decode("phi3_5_moe", 3)
    check_decode("deepseek_v3", 3)


def test_tp_with_fsdp_rows(monkeypatch):
    """"tp" for an architecture over the FSDP threshold: the model blocks
    also split over "data", gathered over it at use."""
    monkeypatch.setattr(SD, "DP_THRESHOLD_PARAMS", 0)
    cfg = H.config("deepseek_v3")
    assert SD.use_fsdp(cfg)
    check_decode("deepseek_v3", 4, cfg=cfg)


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "qwen2_0_5b"])
def test_padded_vocabulary(arch):
    """A vocabulary padded for TP (500 of 512 rows, untied and tied): each
    shard's block of the logits, the padded region as the unsharded step
    leaves it, and the embedding's ids in the last block."""
    cfg = dataclasses.replace(H.config(arch), vocab=500)
    assert cfg.vocab_padded == 512
    check_decode(arch, 4, cfg=cfg)
    check_decode(arch, 1, grid=(2, 3), cfg=cfg)  # vocabulary blocks of 171, 171, 170


def test_sharded_logits_are_vocabulary_blocks():
    """The logits come back vocabulary-sharded over "model" and their rows
    over the data axes, as the reference's out_shardings place them."""
    cfg = H.config("qwen2_0_5b")
    p = params(cfg)
    m = H.mesh()
    with ST.strategy_context(m, "tp") as (plan, ep_axis):
        pp, pc = ST.place_serve_state(p, H.port_cache(cfg, 4, H.seed_cache_leaves(cfg, 4)), cfg, m, plan)
        lg, pc = ST.make_serve_step(cfg, ep_axis)(pp, pc, torch.zeros((4, 1), dtype=torch.int32))
    assert tuple(lg.sharding.spec) == ("data", None, "model")
    assert lg.shards[0].shape == (2, 1, cfg.vocab_padded // 2)
    assert int(pc["pos"].shards[3]) == H.POS0 + 1
    # the placement took views: the param blocks share the given leaves' storage
    table = p["embed"]["table"]
    assert pp["embed"]["table"].shards[0].untyped_storage().data_ptr() == table.untyped_storage().data_ptr()
