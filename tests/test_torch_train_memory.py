"""What a training step keeps alive (no JAX): ``tree_unflatten`` holds no
reference to its leaves once it returns (a recursive closure did, until
the cyclic collector ran, so a step held every tree it had rebuilt);
``place_train_state`` makes one buffer a block and device, shared by the
replicas a repeated device holds; AdamW's leaf update, its temporaries
updated in place, equals the formula written out bit for bit; at AdamW a
step holds its state and its gradients (each leaf is clipped as it is
stepped)."""
import gc
import weakref

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.optim import adamw


def test_tree_unflatten_keeps_no_leaf_alive():
    gc.disable()
    try:
        leaves = [torch.ones(4), torch.zeros(3)]
        refs = [weakref.ref(x) for x in leaves]
        tree = adamw.tree_unflatten({"a": None, "b": {"c": 0, "d": 0}}, leaves)
        del leaves, tree
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_place_train_state_shares_a_block_between_replicas():
    cfg = reduced(get_config("qwen2_0_5b"))
    state = ST.init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    mesh = make_local_mesh(data=2, model=2, device="cpu")
    with ST.strategy_context(mesh, "tp") as (plan, _):
        placed = ST.place_train_state(state, cfg, mesh, plan)
    table = placed["params"]["embed"]["table"]  # P("model", None): data replicas of each block
    chunks, _ = mesh.chunk_of(table.sharding.spec)
    by_chunk = {}
    for b, c in zip(table.shards, chunks):
        by_chunk.setdefault(c, []).append(b.untyped_storage().data_ptr())
    assert all(len(set(ptrs)) == 1 for ptrs in by_chunk.values()) and len(by_chunk) == 2
    src = state["params"]["embed"]["table"].untyped_storage().data_ptr()
    assert all(b.untyped_storage().data_ptr() != src for b in table.shards)  # buffers of its own


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_leaf_update_is_the_formula(dtype):
    g_ = torch.Generator().manual_seed(1)
    p = torch.randn(64, 33, generator=g_).to(dtype)
    g = torch.randn(64, 33, generator=g_) * 3
    m = torch.randn(64, 33, generator=g_)
    v = torch.rand(64, 33, generator=g_)
    cfg = adamw.AdamWConfig(warmup_steps=0)
    lr, b1c, b2c = torch.tensor(3e-4), torch.tensor(0.3), torch.tensor(0.02)
    m2 = cfg.b1 * m + (1 - cfg.b1) * g
    v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
    p32 = p.to(torch.float32)
    delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps) + cfg.weight_decay * p32
    want = ((p32 - lr * delta).to(dtype), m2, v2)
    got = adamw.leaf_update(p, g, m, v, lr, b1c, b2c, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_train_step_holds_its_state_gradients_and_new_state(monkeypatch):
    def live():
        ptrs = {}
        for o in gc.get_objects():
            if type(o) is torch.Tensor and o.device.type == "cpu" and o.numel() * o.element_size() >= 4096:
                ptrs[o.untyped_storage().data_ptr()] = o.untyped_storage().nbytes()
        return sum(ptrs.values())

    cfg = reduced(get_config("qwen2_0_5b"))
    gc.collect()
    base = live()  # what the process held before (other tests' caches)
    state = ST.init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
    size = sum(x.numel() * x.element_size() for x in adamw.tree_leaves(state["params"]))
    seen = []
    update = adamw.update

    def probe(*a, **k):
        seen.append(live())
        return update(*a, **k)

    monkeypatch.setattr(adamw, "update", probe)
    tokens = torch.randint(0, cfg.vocab, (4, 16), generator=torch.Generator().manual_seed(2))
    batch = {"tokens": tokens, "labels": tokens}
    step = ST.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=0), n_micro=2, ep_axis=None)
    step(state, batch)
    # params, m, v and the gradients (small leaves under 4 KiB left out)
    assert seen[0] - base <= 4.05 * size, (seen[0] - base) / size
