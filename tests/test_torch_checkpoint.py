"""``repro_torch.checkpoint`` against ``repro.checkpoint``, on the CPU.

* A checkpoint written by one package restores in the other, for the
  ``single`` and ``packed`` engines and between the port's ``cuda`` engine
  (true layer widths) and the reference's ``pallas`` engine (power-of-two
  widths): the restored state is bit-identical, and both sessions go on
  ingesting the same batches to bit-identical states.
* The damage matrix of ``tests/faults/test_checkpoint_chaos.py`` at smoke
  size: torn write, corrupt payload, every generation damaged, a pinned
  damaged step, and the fallback walk.
Everything compared is exact (bfloat16 NaN compared as NaN, ROADMAP C).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import d4m as jd4m
from repro.checkpoint import manager as jman
from repro_torch import d4m as td4m
from repro_torch.checkpoint import manager as tman
from repro_torch.faults import FaultPlan, Trigger

from _torch_parity import assert_hier_same, assert_same_but_nan_bits, stream

torch.set_num_threads(1)

CUTS, TOP, BATCH, SPACE = (8, 32), 256, 16, 48


def _cfg(engine, k, dtype="float32"):
    return jd4m.StreamConfig(
        cuts=CUTS, top_capacity=TOP, batch_size=BATCH, instances_per_device=k,
        engine=engine, dtype=dtype, snapshot_cap=1024,
    )


_REFS = {}


def _ref(engine, k, directory, dtype="float32"):
    """A reference session with an empty state checkpointing into
    ``directory``; one per configuration for the whole file, since each new
    reference session compiles its update step anew."""
    key = (engine, k, dtype)
    if key not in _REFS:
        _REFS[key] = jd4m.D4MStream(_cfg(engine, k, dtype))
    ref = _REFS[key].reset()
    ref._ckpt_dir, ref._mgr = str(directory), None
    return ref


def _feed(sessions, seed, steps):
    r, c, v = stream(seed, (steps, BATCH), SPACE)
    for t in range(steps):
        for s in sessions:
            if isinstance(s, jd4m.D4MStream):
                s.ingest(jnp.asarray(r[t]), jnp.asarray(c[t]), jnp.asarray(v[t], s.dtype))
            else:
                s.ingest(r[t], c[t], v[t])


@pytest.mark.parametrize(
    "ref_engine,k,port_engine",
    [("single", 1, "single"), ("packed", 4, "packed"), ("pallas", 2, "cuda")],
)
def test_reference_checkpoint_restores_in_the_port(tmp_path, ref_engine, k, port_engine):
    ref = _ref(ref_engine, k, tmp_path)
    _feed([ref], 1, 5)
    ref.checkpoint(5, extra={"cursor": 5 * BATCH})
    ref.wait_checkpoint()
    port = td4m.D4MStream.from_dict(ref.config.to_dict(), device="cpu", checkpoint_dir=str(tmp_path))
    assert port.kind == port_engine
    extra = port.restore()
    assert extra == {"cursor": 5 * BATCH, "step": 5}
    assert_hier_same(port.state, ref.state, "restored")
    assert [l.capacity for l in port.state.layers] == list(port.plan.layer_caps)
    _feed([ref, port], 2, 2)
    assert_hier_same(port.state, ref.state, "after replay")


@pytest.mark.parametrize(
    "port_engine,k,ref_engine",
    [("single", 1, "single"), ("packed", 4, "packed"), ("cuda", 2, "pallas")],
)
def test_port_checkpoint_restores_in_the_reference(tmp_path, port_engine, k, ref_engine):
    cfg = _cfg(ref_engine, k)
    port = td4m.D4MStream.from_dict(cfg.to_dict(), device="cpu", checkpoint_dir=str(tmp_path))
    assert port.kind == port_engine
    _feed([port], 3, 5)
    port.checkpoint(5, extra={"cursor": 80})
    port.wait_checkpoint()
    manifest = json.load(open(os.path.join(tmp_path, "ckpt-000000005", "manifest.json")))
    ref = _ref(ref_engine, k, tmp_path)
    assert sorted(dict(jman._flatten(ref.state))) == manifest["keys"]
    assert ref.restore() == {"cursor": 80, "step": 5}
    assert_hier_same(port.state, ref.state, "restored")
    _feed([ref, port], 4, 2)
    assert_hier_same(port.state, ref.state, "after replay")


def test_bfloat16_checkpoints_cross_from_the_reference(tmp_path):
    """bfloat16 leaves travel as the reference's raw 2-byte words (|V2):
    the port restores the reference's bfloat16 checkpoint and its own."""
    cfg = _cfg("packed", 2, "bfloat16")
    ref = _ref("packed", 2, tmp_path / "r", "bfloat16")
    _feed([ref], 6, 4)
    ref.checkpoint(1)
    ref.wait_checkpoint()
    port = td4m.D4MStream.from_dict(cfg.to_dict(), device="cpu", checkpoint_dir=str(tmp_path / "r"))
    port.restore()
    assert port.state.layers[0].vals.dtype == torch.bfloat16
    assert_hier_same(port.state, ref.state, "ref->port", same_vals=assert_same_but_nan_bits)
    port.checkpoint(2)
    port.wait_checkpoint()
    again = td4m.D4MStream(port.config, device="cpu", checkpoint_dir=str(tmp_path / "r"))
    again.restore()
    assert_hier_same(again.state, ref.state, "port->port", same_vals=assert_same_but_nan_bits)


def test_reference_cannot_restore_a_bfloat16_checkpoint(tmp_path):
    """A fact about the reference (ROADMAP C17): its restore casts the
    loaded |V2 words with ``astype(bfloat16)``, which numpy refuses, so no
    bfloat16 generation verifies, its own included."""
    ref = _ref("packed", 2, tmp_path, "bfloat16")
    ref.checkpoint(1)
    ref.wait_checkpoint()
    with pytest.raises(jman.CheckpointDamaged, match="No cast function"):
        ref.restore()


def test_save_async_takes_owned_copies_before_it_returns(tmp_path):
    """C5: the next update overwrites the state; the saved generation must
    still hold the state at the call."""
    port = td4m.D4MStream(td4m.StreamConfig.from_dict(_cfg("cuda", 2).to_dict()), device="cpu",
                          checkpoint_dir=str(tmp_path))
    _feed([port], 7, 3)
    want = [l.rows.clone() for l in port.state.layers]
    port.checkpoint(1)
    _feed([port], 8, 3)  # the cuda engine writes its layers in place
    port.wait_checkpoint()
    fresh = td4m.D4MStream(port.config, device="cpu", checkpoint_dir=str(tmp_path))
    fresh.restore()
    for w, l in zip(want, fresh.state.layers):
        assert torch.equal(w, l.rows)


def test_restore_refuses_live_entries_past_the_capacity(tmp_path):
    """A wider layer restores only where its tail is dead."""
    from repro_torch.core import hierarchical

    port = td4m.D4MStream.from_dict(_cfg("pallas", 2).to_dict(), device="cpu", checkpoint_dir=str(tmp_path))
    padded = hierarchical.pad_layers_pow2(port.state, port.sr)
    arrays = dict(tman.leaves(tman.rebuild(padded, lambda _, x: tman.host_copy(x))))
    assert arrays[".layers[0].rows"].shape[-1] > port.state.layers[0].capacity
    arrays[".layers[0].rows"][:, -1] = 3  # a live key in layer 1's dead tail
    tman.CheckpointManager(str(tmp_path)).save(1, tman.rebuild(padded, lambda k, _: arrays[k]))
    with pytest.raises(ValueError, match="live entries past"):
        port.restore()


# -- the damage matrix (tests/faults/test_checkpoint_chaos.py at smoke size) --

def _state(step):
    return {"w": np.full((4, 4), float(step), np.float32), "cursor": np.asarray([step * 10], np.int64)}


def _generations(mgr, steps):
    for s in steps:
        mgr.save(s, _state(s), extra={"cursor": s * 10})


def _npz(d, step):
    return os.path.join(d, f"ckpt-{step:09d}", "arrays.npz")


def test_torn_write_falls_back_one_generation(tmp_path):
    plan = FaultPlan().add("checkpoint.torn_write", Trigger.once_at(2))
    mgr = tman.CheckpointManager(str(tmp_path), faults=plan)
    _generations(mgr, [1, 2])
    assert plan.summary()["checkpoint.torn_write"]["fires"] == 1
    with pytest.raises(tman.CheckpointDamaged, match="torn write"):
        mgr.restore(_state(0), step=2, fallback=False)
    state, extra = mgr.restore(_state(0))
    assert extra == {"cursor": 10, "step": 1}
    np.testing.assert_array_equal(state["w"], _state(1)["w"])


def test_corrupt_payload_crc_detected_and_skipped(tmp_path):
    plan = FaultPlan().add("checkpoint.corrupt_payload", Trigger.once_at(3))
    mgr = tman.CheckpointManager(str(tmp_path), faults=plan)
    _generations(mgr, [1, 2, 3])
    with pytest.raises(tman.CheckpointDamaged, match="crc32"):
        mgr.restore(_state(0), step=3, fallback=False)
    state, extra = mgr.restore(_state(0))
    assert extra["step"] == 2
    np.testing.assert_array_equal(state["w"], _state(2)["w"])


def test_all_generations_damaged_raises(tmp_path):
    mgr = tman.CheckpointManager(str(tmp_path), faults=FaultPlan().add("checkpoint.torn_write", Trigger.always()))
    _generations(mgr, [1, 2])
    with pytest.raises(tman.CheckpointDamaged, match="all 2 checkpoint"):
        mgr.restore(_state(0))


@pytest.mark.parametrize("damage", ["truncate", "flip", "no_arrays", "garbled_manifest"])
def test_hand_damaged_generation_falls_back_in_both_packages(tmp_path, damage):
    """The same damaged directory: both packages' managers walk back to the
    same generation and load the same arrays."""
    tman.CheckpointManager(str(tmp_path)).save(1, _state(1), extra={"cursor": 10})
    tman.CheckpointManager(str(tmp_path)).save(2, _state(2), extra={"cursor": 20})
    npz = _npz(str(tmp_path), 2)
    if damage == "truncate":
        with open(npz, "r+b") as f:
            f.truncate(os.path.getsize(npz) // 3)
    elif damage == "flip":
        size = os.path.getsize(npz)
        with open(npz, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
    elif damage == "no_arrays":
        os.remove(npz)
    else:
        with open(os.path.join(str(tmp_path), "ckpt-000000002", "manifest.json"), "w") as f:
            f.write("{not json")
    for mod in (tman, jman):
        state, extra = mod.CheckpointManager(str(tmp_path)).restore(_state(0))
        assert extra == {"cursor": 10, "step": 1}
        np.testing.assert_array_equal(state["w"], _state(1)["w"])
    with pytest.raises(tman.CheckpointDamaged):
        tman.CheckpointManager(str(tmp_path)).restore(_state(0), step=2)


def test_retention_keeps_the_newest_generations(tmp_path):
    mgr = tman.CheckpointManager(str(tmp_path), keep=2)
    _generations(mgr, [1, 2, 3, 4])
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
