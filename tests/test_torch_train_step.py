"""The port's ``launch.steps`` against the reference's ``launch/steps.py``
on the CPU: one ``make_train_step`` step with two microbatches leaf for
leaf (qwen2 reduced, tied table), the restart check of
``tests/test_runtime.py`` (against the reference's numbers, and on a real
model through ``CheckpointManager``, bit for bit), the prefill and serve
steps, and the ``train_lm`` example end to end (the loss line, the
checkpoint's cursor, and C25: the accumulated table gradient is each
token's count times its row of the dense gradient)."""
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train as T
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.data.tokens import Prefetcher as JPrefetcher
from repro.data.tokens import TokenStream as JTokenStream
from repro.launch import steps as JST
from repro.optim import adamw as JA
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.tokens import TokenStream
from repro_torch.examples import train_lm
from repro_torch.launch import steps as TST
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import serving as TSV
from repro_torch.models import transformer as TTF
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw as TA
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sparse import hier_grad as HG


def _state_from(jparams):
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return {"params": params, "opt": TA.init(params)}


def test_train_step_two_microbatches_matches_reference():
    """AdamW's first step moves an entry by lr g / |g|: where |g| is under
    the gradients' 1e-4 comparison tolerance its sign is not fixed by the
    comparison, and the entry may differ by 2 lr; every other entry within
    1e-4 of the leaf's max.  The moments (the gradients) within 1e-4."""
    cfg, tc = T.configs("qwen2_0_5b")
    jstate = JST.init_train_state(jax.random.PRNGKey(0), cfg)
    tokens, labels, _ = T.batch(cfg, b=4)
    jnew, jm = JST.make_train_step(cfg, JA.AdamWConfig(warmup_steps=0), n_micro=2, ep_axis=None)(
        jstate, {"tokens": tokens, "labels": labels})
    step = TST.make_train_step(tc, TA.AdamWConfig(warmup_steps=0), n_micro=2, ep_axis=None)
    new, m = step(_state_from(jstate["params"]), {"tokens": T.tensor(tokens), "labels": T.tensor(labels)})
    assert set(m) == set(jm) == {"loss", "nll", "grad_norm", "lr"}
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    assert int(new["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    for name in ("m", "v"):
        for got, want in zip(tree_leaves(new["opt"][name]), jax.tree.leaves(jnew["opt"][name])):
            assert T.rel_err(got.numpy(), np.asarray(want)) <= T.REL
    lr = float(jm["lr"])
    for got, want, mom in zip(tree_leaves(new["params"]), jax.tree.leaves(jnew["params"]),
                              jax.tree.leaves(jnew["opt"]["m"])):
        want, mom = np.asarray(want), np.asarray(mom)
        unsure = np.abs(mom) < T.REL * np.abs(mom).max()
        assert (np.abs(got.numpy() - want) <= T.REL * np.abs(want).max() + 2 * lr * unsure).all()


def test_one_microbatch_is_the_mean_of_two():
    """``n_micro=2`` over a batch equals ``n_micro=1`` over it up to the
    float32 sums: the loss is each half's mean, the gradient their mean."""
    cfg, tc = T.configs("granite_3_8b")
    state = TST.init_train_state(torch.Generator().manual_seed(0), tc, "cpu")
    tokens, labels, _ = T.batch(cfg, b=4)
    b = {"tokens": T.tensor(tokens), "labels": T.tensor(labels)}
    one = TST.make_train_step(tc, n_micro=1, ep_axis=None)(state, b)
    two = TST.make_train_step(tc, n_micro=2, ep_axis=None)(state, b)
    assert set(one[1]) == {"loss", "nll", "tokens", "moe_aux", "grad_norm", "lr"}
    np.testing.assert_allclose(float(one[1]["loss"]), float(two[1]["loss"]), rtol=1e-5)
    for a, c in zip(tree_leaves(one[0]["opt"]["m"]), tree_leaves(two[0]["opt"]["m"])):
        assert T.rel_err(a.numpy(), c.numpy()) <= T.REL


def test_dp_spec_belongs_to_the_sharding_slice():
    """With ``dp_spec`` the step runs over the mesh its state is placed on:
    two data shards of the CPU give the unsharded step's loss and moments
    (``test_torch_shard_step.py`` holds every strategy to the reference);
    with compression on, the sharded step runs and gives the unsharded
    compressed step's loss (``test_torch_shard_compress.py`` holds the
    rest)."""

    cfg, tc = T.configs("qwen2_0_5b")
    state = TST.init_train_state(torch.Generator().manual_seed(0), tc, "cpu")
    tokens, labels, _ = T.batch(cfg, b=4)
    b = {"tokens": T.tensor(tokens), "labels": T.tensor(labels)}
    want, wm = TST.make_train_step(tc, n_micro=2, ep_axis=None)(state, b)
    mesh = make_local_mesh(data=2, device="cpu")
    placed = TST.place_train_state(state, tc, mesh, "fsdp_flat")
    new, m = TST.make_train_step(tc, n_micro=2, ep_axis=None, dp_spec=("data", "model"))(placed, b)
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]), rtol=1e-5)
    for a, c in zip(tree_leaves(TST.gather_train_state(new, "cpu")["opt"]["m"]), tree_leaves(want["opt"]["m"])):
        assert T.rel_err(a.numpy(), c.numpy()) <= T.REL
    comp = TST.compression.CompressionConfig(enabled=True)
    cstate = dict(state, residual=TST.compression.init_error_feedback(state["params"]))
    _, cw = TST.make_train_step(tc, n_micro=2, ep_axis=None, comp_cfg=comp)(cstate, b)
    placed = TST.place_train_state(cstate, tc, mesh, "fsdp_flat")
    _, cm = TST.make_train_step(tc, n_micro=2, ep_axis=None, dp_spec=("data", "model"), comp_cfg=comp)(placed, b)
    np.testing.assert_allclose(float(cm["loss"]), float(cw["loss"]), rtol=1e-5)


def test_restart_resumes_training_bitexact(tmp_path):
    """``tests/test_runtime.py``'s check, ported: step -> checkpoint ->
    'crash' -> restore -> step == uninterrupted (rtol 1e-6), and equal to
    the reference's run of the same steps."""
    opt_cfg = TA.AdamWConfig(warmup_steps=0)
    params = {"w": torch.ones((4, 4))}
    state = {"params": params, "opt": TA.init(params)}
    stream = TokenStream(vocab=16, batch=2, seq=4, seed=1)

    def fake_step(state, step):
        g = {"w": torch.full((4, 4), float(stream.batch_at(step)["tokens"].sum() % 7))}
        p, o, _ = TA.update(g, state["opt"], state["params"], opt_cfg)
        return {"params": p, "opt": o}

    s_ref = state
    for t in range(4):
        s_ref = fake_step(s_ref, t)
    mgr = CheckpointManager(str(tmp_path))
    s = state
    for t in range(2):
        s = fake_step(s, t)
    mgr.save(2, s, extra={"cursor": 2})
    zeros = TTF.tree_map(torch.zeros_like, s)
    restored, extra = mgr.restore(zeros)
    s2 = TTF.tree_map(lambda a, z: torch.from_numpy(np.array(a)).to(z.dtype), restored, zeros)
    for t in range(extra["cursor"], 4):
        s2 = fake_step(s2, t)
    np.testing.assert_allclose(s2["params"]["w"].numpy(), s_ref["params"]["w"].numpy(), rtol=1e-6)

    jcfg = JA.AdamWConfig(warmup_steps=0)
    jstream = JTokenStream(vocab=16, batch=2, seq=4, seed=1)
    js = {"params": {"w": jnp.ones((4, 4))}}
    js["opt"] = JA.init(js["params"])
    for t in range(4):
        g = {"w": jnp.full((4, 4), float(np.asarray(jstream.batch_at(t)["tokens"]).sum() % 7))}
        p, o, _ = JA.update(g, js["opt"], js["params"], jcfg)
        js = {"params": p, "opt": o}
    np.testing.assert_allclose(s_ref["params"]["w"].numpy(), np.asarray(js["params"]["w"]), rtol=1e-6)
    # the port's checkpoint loads in the reference's manager too
    back, jextra = JCheckpointManager(str(tmp_path)).restore(jax.tree.map(jnp.zeros_like, {"params": {"w": jnp.ones((4, 4))}, "opt": JA.init({"w": jnp.ones((4, 4))})}))
    assert jextra["cursor"] == 2
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]), s["params"]["w"].numpy())


def test_restart_of_a_model_is_bit_identical(tmp_path):
    """Four ``make_train_step`` steps (two microbatches, remat) against two,
    a checkpoint, a restore into fresh zeros and two more: every param and
    moment bit-identical."""
    cfg, tc = T.configs("mamba2_1_3b")
    stream = TokenStream(tc.vocab, 4, 16, seed=1)
    step = TST.make_train_step(tc, TA.AdamWConfig(warmup_steps=0), n_micro=2, ep_axis=None)

    def run(state, steps):
        for t in steps:
            b = {k: torch.from_numpy(v) for k, v in stream.batch_at(t).items()}
            state, _ = step(state, b)
        return state

    init = TST.init_train_state(torch.Generator().manual_seed(0), tc, "cpu")
    ref = run(init, range(4))
    mgr = CheckpointManager(str(tmp_path))
    mid = run(init, range(2))
    mgr.save(2, mid, extra={"cursor": 2})
    zeros = TTF.tree_map(torch.zeros_like, mid)
    restored, extra = mgr.restore(zeros)
    resumed = run(TTF.tree_map(lambda a, z: torch.from_numpy(np.array(a)).to(z.dtype), restored, zeros),
                  range(extra["cursor"], 4))
    for a, b in zip(tree_leaves(resumed), tree_leaves(ref)):
        assert torch.equal(a, b)


def test_prefill_and_serve_steps():
    cfg, tc = T.configs("h2o_danube3_4b")
    state = TST.init_train_state(torch.Generator().manual_seed(0), tc, "cpu")
    tokens = T.tensor(T.batch(cfg)[0])
    with torch.no_grad():
        full, _, _ = TTF.forward(state["params"], tc, tokens, ep_axis=None)
    last = TST.make_prefill_step(tc, ep_axis=None)(state["params"], {"tokens": tokens})
    assert last.shape == (2, 1, tc.vocab_padded) and not last.requires_grad
    assert T.rel_err(last.numpy(), full[:, -1:].numpy()) <= 1e-6
    cache = TSV.init_cache(tc, 2, 4, torch.float32, "cpu")
    serve = TST.make_serve_step(tc, ep_axis=None)
    logits, cache = serve(state["params"], cache, tokens[:, :1])
    assert logits.shape == (2, 1, tc.vocab_padded) and int(cache["pos"]) == 1
    assert T.rel_err(logits.numpy(), full[:, :1].numpy()) <= T.REL


def test_reference_checkpoint_cursor_runs_ahead_of_the_consumed_batches():
    """ROADMAP C26: the reference's example checkpoints ``stream.cursor()``,
    which its ``Prefetcher`` thread advances as it fills its queue; after
    one batch is consumed the cursor is already past it.  The port's
    example saves the count of consumed batches."""
    stream = JTokenStream(vocab=16, batch=2, seq=4, seed=1)
    pf = JPrefetcher(stream, device_put=lambda b: b)
    try:
        next(pf)
        deadline = time.monotonic() + 10
        while stream.cursor() < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert stream.cursor() >= 3  # depth 2 queued beyond the one consumed
    finally:
        pf.close()


def test_train_lm_resumes_from_its_checkpoint_cursor(tmp_path):
    """C26's departure pinned: the port's cursor is the count of consumed
    batches, so a run that dies after its step-2 checkpoint and resumes
    from it (``--resume``) takes batches 2 and 3 and ends bit-identical to
    the uninterrupted run, the sparse embedding path included."""
    argv = ["--arch", "mamba2_1_3b", "--steps", "4", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    whole = train_lm.main(argv)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [2, 4]
    shutil.rmtree(tmp_path / "ckpt-000000004")  # the run died before its step-4 checkpoint
    resumed = train_lm.main(argv + ["--resume"])
    assert resumed["losses"] == whole["losses"][2:]
    assert torch.equal(resumed["last"]["tokens"], whole["last"]["tokens"])
    _, extra = mgr.restore({"params": resumed["params"], "opt": resumed["opt"]})
    assert extra["cursor"] == 4
    for k in ("params", "opt"):
        for a, b in zip(tree_leaves(resumed[k]), tree_leaves(whole[k]), strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "mamba2_1_3b"])
def test_train_lm_example(arch, tmp_path, capsys):
    """``python -m repro_torch.examples.train_lm --steps 4 --device cpu``:
    the plan and the loss line, a checkpoint at step 4 whose cursor is 4.
    On mamba2's untied table the sparse path runs: the flushed rows, made
    dense by ``dense_grad_of``, are each token's count times its row of
    the dense gradient (C25) and nothing elsewhere."""
    out = train_lm.main(["--arch", arch, "--steps", "4", "--device", "cpu", "--ckpt-every", "2",
                         "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "embedding-grad id cascade:" in text and "D4M capacity plan" in text
    assert text.rstrip().splitlines()[-1].startswith("loss ")
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert out["cursor"] == 4
    _, extra = CheckpointManager(str(tmp_path)).restore({"params": out["params"], "opt": out["opt"]})
    assert extra["cursor"] == 4 and extra["step"] == 4
    last = out["last"]
    if arch == "qwen2_0_5b":  # tied: the dense path
        assert last is None
        return
    tokens = last["tokens"].reshape(-1).numpy()
    emb_g = last["emb_g"].numpy()
    dense = HG.dense_grad_of(last["flushed"], emb_g.shape[0]).numpy()
    counts = np.bincount(tokens, minlength=emb_g.shape[0])[:, None]
    want = counts * emb_g
    assert T.rel_err(dense, want) <= 1e-6
    assert not dense[counts[:, 0] == 0].any()
