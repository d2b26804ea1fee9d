"""A CPU rehearsal of ``chip_smoke.py``'s head-split legs: ``phase_shard_serve``'s
(d5)-(d7) (MLA absorbed and naive, the sequence-parallel branch, FSDP rows
under "tp", Mamba-2, the "hd" and "q" cache splits) and ``phase_shard``'s (e)
(head-split "tp" training of MLA, Mamba-2 and the local MoE path) with
``DEVICE = "cpu"`` on the ``reduced()`` configs, short rings and sequences,
the card's calls stubbed and ``scatter_add``'s plain version counted as its
launch.  Every check the script makes on the card runs here: the tolerances,
the collectives against the dry run's formulas, the launches."""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as C
from repro_torch import kernels
from repro_torch.kernels.scatter_add import ops as SA

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cs(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke_rehearsal", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "DEVICE", "cpu")
    monkeypatch.setattr(mod, "SERVE_RING", (16, 40))
    monkeypatch.setattr(mod, "SERVE_PREFILL", (2, 16))
    monkeypatch.setattr(mod, "SERVE_DECODE", (("decode_32k", 4, 64, 60), ("long_500k", 1, 64, 70)))
    monkeypatch.setattr(mod, "SERVE_SPLIT_STEPS", 2)
    monkeypatch.setattr(mod, "TRAIN_SEQ", 32)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda *a: types.SimpleNamespace(total_memory=85e9))
    full = C.get_config
    monkeypatch.setattr(C, "get_config", lambda arch: C.reduced(full(arch)))
    plain = SA.scatter_add

    def counted(ids, rows, table):  # the plain version stands in for the launch
        if not kernels.plain_active():
            SA.launch_count += 1
        return plain(ids, rows, table)

    monkeypatch.setattr(SA, "scatter_add", counted)
    return mod


def test_split_serve_legs(cs):
    out = cs.phase_shard_serve(torch, np, legs=("split",))
    legs = out["legs"]
    for name in ("mla_absorbed", "mla_naive", "mla_absorbed_seq", "mla_naive_seq", "mla_fsdp_rows",
                 "ssm_decode", "ssm_long_500k", "hd_decode", "q_decode"):
        assert legs[name]["max_rel_err"] <= cs.SERVE_BF16_REL, name
    assert legs["mla_naive_seq"]["seq_shard"] and not legs["mla_naive"]["seq_shard"]
    assert legs["hd_decode"]["attn"] == "hd" and legs["q_decode"]["attn"] == "q"
    assert legs["ssm_decode"]["ssm_tp"] and legs["ssm_decode"]["conv_tp"]
    assert legs["hd_decode"]["mesh"] == {"data": 2, "model": 4}
    for name in ("mla_prefill", "ssm_prefill", "hd_prefill", "q_prefill"):
        assert legs[name]["rel_err"] <= cs.SERVE_BF16_REL, name


def test_tp_train_legs(cs):
    out = cs.phase_shard(torch, np, legs=("e",))
    for arch in ("deepseek_v3", "mamba2_1_3b", "phi3_5_moe"):
        res = out["steps"][f"tp_{arch}"]
        gathers = 2 if arch == "deepseek_v3" else 1  # the MTP block's embedding gather (it fits here)
        assert res["head_split"] and res["launches"]["scatter_add"] == 8 * gathers, (arch, res["launches"])
        assert res["loss_rel_err"] <= cs.SHARD_LOSS_REL and res["worst_moment_leaf_rel_err"] <= cs.SHARD_LEAF_REL
