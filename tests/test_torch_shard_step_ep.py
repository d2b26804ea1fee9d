"""The port's expert-parallel train steps ("ep": "tp"'s plan with the
experts over "model"; "ep_fsdp": ZeRO-3 with the experts' EP layout) on a
2 x 2 ``(data, model)`` mesh of the CPU, against the reference's step
jitted with ``dryrun.lower_cell``'s shardings on 4 forced host devices
(``_torch_shard_ref_main.py``; ``shard_map`` changes the values — the
capacity is a data shard's, the aux term a proxy — so each is held to its
own ``shard_map`` run).  Reduced phi3.5-moe and deepseek-v3 (MTP, MLA, the
aux-free router, a shared expert), float32, two microbatches; each step's
collectives equal ``launch.dryrun.step_collectives``."""
import jax
import numpy as np
import pytest
import torch

import _torch_shard_ref_main as R
import _torch_train as T
from repro.models import transformer as JTF
from repro_torch.launch import dryrun as DR
from repro_torch.launch import steps as TST
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import sharding as TSD
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw as TA
from repro_torch.optim.adamw import tree_leaves


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return R.reference(tmp_path_factory, "step")


@pytest.mark.parametrize("arch,strategy", R.STEP_CASES, ids=[f"{a}-{s}" for a, s in R.STEP_CASES])
def test_ep_step_matches_the_shard_map_run(ref, arch, strategy):
    cfg, tc, tokens, labels = R.step_case(arch)
    params = params_from_numpy(jax.tree.map(np.asarray, JTF.init_params(jax.random.PRNGKey(0), cfg)), device="cpu")
    mesh = make_local_mesh(data=2, model=2, device="cpu")
    with TST.strategy_context(mesh, strategy) as (plan, ep_axis):
        placed = TST.place_train_state({"params": params, "opt": TA.init(params)}, tc, mesh, plan)
        step = TST.make_train_step(tc, TA.AdamWConfig(warmup_steps=0), n_micro=R.STEP_MICRO, ep_axis=ep_axis,
                                   dp_spec=TSD.batch_axes(tc, mesh, plan))
        mesh.reset_collectives()
        new, m = step(placed, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
    tag = f"step.{arch}.{strategy}"
    for k in ("loss", "nll", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(ref[f"{tag}.metric.{k}"]), rtol=1e-5, err_msg=k)
    new = TST.gather_train_state(new, "cpu")
    moments = [ref[f"{tag}.m.{i}"] for i in range(len(tree_leaves(new["opt"]["m"])))]
    for got, want in zip(tree_leaves(new["opt"]["m"]), moments):
        assert T.rel_err(got.numpy(), want) <= T.REL
    lr = float(ref[f"{tag}.metric.lr"])
    for i, (got, mom) in enumerate(zip(tree_leaves(new["params"]), moments)):
        want = ref[f"{tag}.params.{i}"]
        unsure = np.abs(mom) < T.REL * np.abs(mom).max()
        assert (np.abs(got.numpy() - want) <= T.REL * np.abs(want).max() + 2 * lr * unsure).all(), i
    calls, nbytes = DR.step_collectives(tc, mesh, strategy, R.STEP_MICRO, R.STEP_BATCH, tokens.shape[1])
    assert mesh.collectives == calls and mesh.collective_bytes == nbytes
    assert calls["all-reduce"] > 0 and (calls["reduce-scatter"] > 0) == (strategy == "ep_fsdp")
