"""The port's expert-parallel MoE (``moe.apply_moe_ep_local``,
``apply_moe_shardmap``) against the reference's on the CPU.

``apply_moe_ep_local`` is held to the reference's run under
``jax.vmap(..., axis_name="model")`` (where ``psum``, ``axis_index`` and
``axis_size`` work in-process) at tp 2 and 4, with capacity dropping tokens
and with DeepSeek-V3's aux-free router bias: the output within 1e-5 of its
max, each shard's load and the dropped count exactly.  ``apply_moe_shardmap``
is held to the reference's ``shard_map`` on a 2 x 2 ``(data, model)`` mesh
of 4 forced host devices (``_torch_shard_ref_main.py``, one subprocess a
test process)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_shard_ref_main as R
from repro.configs import get_config, reduced
from repro.models import moe as JMOE
from repro_torch import configs as tcfg
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe as TMOE
from repro_torch.models.convert import params_from_numpy

REL = 1e-5  # the output, of its max |value|


def _cfgs(arch, **moe):
    jc, tc = reduced(get_config(arch)), tcfg.reduced(tcfg.get_config(arch))
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


def _params(jc):
    jp = JMOE.init_moe(jax.random.PRNGKey(8), jc)
    if jc.moe.router_aux_free:  # a bias that changes the selection
        jp["router_bias"] = jnp.asarray(np.random.default_rng(3).normal(size=jc.moe.n_experts) * 0.5, jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch,tp,moe", [
    ("phi3_5_moe", 2, {}), ("phi3_5_moe", 4, {}), ("phi3_5_moe", 2, {"capacity_factor": 0.5}),
    ("phi3_5_moe", 4, {"capacity_factor": 0.5}), ("deepseek_v3", 2, {}),
], ids=["phi-tp2", "phi-tp4", "phi-tp2-drops", "phi-tp4-drops", "deepseek-tp2"])
def test_ep_local_matches_the_reference_under_vmap(arch, tp, moe):
    jc, tc = _cfgs(arch, **moe)
    jp, tp_params = _params(jc)
    xt = np.random.default_rng(4).normal(size=(24, jc.d_model)).astype(np.float32)
    E = jc.moe.n_experts
    split = {k: jp[k].reshape((tp, E // tp) + jp[k].shape[1:]) for k in ("wg", "wu", "wd")}
    rb = jp.get("router_bias") if jc.moe.router_aux_free else None
    want_out, want_load, want_drop = jax.vmap(
        lambda wg, wu, wd: JMOE.apply_moe_ep_local(xt, jp["router"], rb, wg, wu, wd, jc, "model"),
        axis_name="model")(split["wg"], split["wu"], split["wd"])
    blocks = {k: list(torch.chunk(tp_params[k], tp)) for k in ("wg", "wu", "wd")}
    out, loads, dropped = TMOE.apply_moe_ep_local(
        torch.from_numpy(xt), tp_params["router"], tp_params.get("router_bias") if tc.moe.router_aux_free else None,
        blocks["wg"], blocks["wu"], blocks["wd"], tc, "model")
    for j in range(tp):  # every model shard holds the psum'd output
        assert _rel(out, want_out[j]) <= REL, (j, _rel(out, want_out[j]))
        np.testing.assert_array_equal(loads[j].numpy(), np.asarray(want_load[j]))
        assert int(dropped) == int(want_drop[j])
    if moe:
        assert int(dropped) > 0  # the case drops assignments


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return R.reference(tmp_path_factory, "moe")


@pytest.mark.parametrize("case", sorted(R.MOE_CASES))
def test_shardmap_matches_the_reference_at_2x2(ref, case):
    """The global batch split over "data", the experts over "model":
    output, ``expert_load`` (summed over the data shards), ``moe_dropped``
    and the aux proxy against the reference's ``shard_map``; the mesh counts
    one ``psum`` of the outputs and one of the dropped count a data shard,
    and one of the load over "data"."""
    _, jc, tc, x = R.moe_case(case)
    p = params_from_numpy(jax.tree.map(np.asarray, JMOE.init_moe(jax.random.PRNGKey(8), jc)), device="cpu")
    mesh = make_local_mesh(data=2, model=2, device="cpu")
    TMOE.EP_CONTEXT.update(mesh=mesh, dp="data")
    try:
        out, aux = TMOE.apply_moe(p, tc, torch.from_numpy(x), "model")
    finally:
        TMOE.EP_CONTEXT.update(mesh=None, dp=None)
    assert _rel(out, ref[f"moe.{case}.out"]) <= REL
    np.testing.assert_array_equal(aux["expert_load"].numpy(), ref[f"moe.{case}.expert_load"])
    assert int(aux["moe_dropped"]) == int(ref[f"moe.{case}.moe_dropped"])
    np.testing.assert_allclose(float(aux["moe_aux_loss"]), float(ref[f"moe.{case}.moe_aux_loss"]), rtol=1e-6)
    assert mesh.collectives["all-reduce"] == 2 * 2 + 1


def test_shardmap_dropped_is_the_first_data_shard_s(ref):
    """ROADMAP C28: the reference's ``moe_dropped`` under ``shard_map`` is
    data shard 0's count (``out_specs=P()`` with replication checks off),
    not the microbatch's: here the other data shard drops too."""
    _, jc, tc, x = R.moe_case("phi_drop")
    p = params_from_numpy(jax.tree.map(np.asarray, JMOE.init_moe(jax.random.PRNGKey(8), jc)), device="cpu")
    drops = []
    for c in range(2):
        xt = torch.from_numpy(x[2 * c:2 * c + 2].reshape(-1, jc.d_model))
        _, _, d = TMOE.apply_moe_ep_local(xt, p["router"], None, list(torch.chunk(p["wg"], 2)),
                                          list(torch.chunk(p["wu"], 2)), list(torch.chunk(p["wd"], 2)), tc, "model")
        drops.append(int(d))
    assert drops[0] == int(ref["moe.phi_drop.moe_dropped"]) and drops[1] > 0
