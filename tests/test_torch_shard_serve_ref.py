"""The port's sharded decode against the JAX reference's unsharded
``make_serve_step`` (``src/repro/launch/steps.py``) on the CPU, float32 at
the reduced configs: a dense GQA arch, MLA (deepseek-v3), Mamba-2 and
MoE (phi3.5-moe), the same weights (``models.convert``), the same
seed-made cache and tokens; the port on a 2 x 2 ``(data, model)`` mesh
(the batch over "data") and on 4 x 2 (the batch below the data axis: the
sequence-parallel branch), within 1e-4 of max |logit|.  One jitted
reference step an architecture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_serve_shard as H
from repro.configs import get_config, reduced
from repro.launch import steps as JST
from repro.models import serving as JSV
from repro.models import transformer as JTF
from repro_torch.models.convert import params_from_numpy

B = 2


def reference(arch, leaves, toks):
    cfg = reduced(get_config(arch))
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": "float32"})
    params = JTF.init_params(jax.random.PRNGKey(0), cfg)
    cache = JSV.init_cache(cfg, B, H.CAP, jnp.float32)
    cache = jax.tree.unflatten(jax.tree.structure(cache), [jnp.asarray(x) for x in leaves])
    step = jax.jit(JST.make_serve_step(cfg, ep_axis=None))  # unsharded: no mesh to pin the expert buffer to
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]))
        outs.append(np.asarray(lg))
    return params, np.concatenate(outs, axis=1)


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "deepseek_v3", "mamba2_1_3b", "phi3_5_moe"])
def test_sharded_decode_matches_the_reference(arch):
    cfg = H.config(arch)
    leaves = H.seed_cache_leaves(cfg, B)
    toks = H.tokens(cfg, B, H.STEPS)
    jparams, want = reference(arch, leaves, toks)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    for grid in ((2, 2), (4, 2)):
        got, _, _ = H.sharded_decode(params, cfg, H.mesh(*grid), "tp", leaves, toks)
        assert got.shape == want.shape
        assert H.rel(got, want) <= H.REL, (arch, grid, H.rel(got, want))
