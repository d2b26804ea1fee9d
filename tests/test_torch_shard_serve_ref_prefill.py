"""The port's sharded prefill against the JAX reference's unsharded
``make_prefill_step`` (``src/repro/launch/steps.py``) on the CPU, float32
at the reduced configs (a dense GQA arch, MLA, Mamba-2, MoE): the same
weights and tokens, the port on a 2 x 2 ``(data, model)`` mesh, the
last position's logits within 1e-4 of max |logit|.  One jitted reference
step an architecture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_serve_shard as H
from repro.configs import get_config, reduced
from repro.launch import steps as JST
from repro.models import transformer as JTF
from repro_torch.models.convert import params_from_numpy


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "deepseek_v3", "mamba2_1_3b", "phi3_5_moe"])
def test_sharded_prefill_matches_the_reference(arch):
    cfg = H.config(arch)
    jcfg = reduced(get_config(arch))
    jcfg = type(jcfg)(**{**jcfg.__dict__, "dtype": "float32"})
    jparams = JTF.init_params(jax.random.PRNGKey(0), jcfg)
    batch = H.prefill_batch(cfg, 4)
    want = np.asarray(jax.jit(JST.make_prefill_step(jcfg, ep_axis=None))(jparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    got, _ = H.sharded_prefill(params, cfg, H.mesh(), "tp", batch)
    assert got.shape == want.shape and H.rel(got, want) <= H.REL, (arch, H.rel(got, want))
