"""The JAX reference's expert-parallel programs on a 2 x 2 ``(data, model)``
mesh of 4 forced host devices, for the port's sharding tests
(``test_torch_moe_ep.py``, ``test_torch_shard_step.py``).

The reference's ``shard_map`` needs the host device count forced before
``jax`` is imported, so it runs in a subprocess of its own (the pattern of
``_torch_mesh_ref_main.py``): ``python _torch_shard_ref_main.py OUT_DIR moe|step``
writes ``OUT_DIR/ref.npz`` and prints ``REF_OK``.  ``moe`` holds
``apply_moe_shardmap``'s output, load, dropped count and aux term for each
of :data:`MOE_CASES`; ``step`` for each of :data:`STEP_CASES` one
``make_train_step`` step of two microbatches, jitted with the reference's
``dryrun.lower_cell`` shardings: the metrics and every leaf of the new
params and first moments.  The tests build the same inputs with
:func:`moe_case` and :func:`step_case` and call :func:`reference` (once a
test process, the result kept in pytest's base temp dir).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

MESH = (2, 2)  # (data, model)
# apply_moe_shardmap: reduced phi3.5-moe, one with capacity dropping tokens;
# reduced deepseek-v3 (aux-free router bias, a shared expert)
MOE_CASES = {
    "phi": ("phi3_5_moe", {}),
    "phi_drop": ("phi3_5_moe", {"capacity_factor": 0.5}),
    "deepseek": ("deepseek_v3", {}),
}
MOE_X = (4, 8)  # [B, S] of the MoE input (B over "data")
# one sharded train step: (arch, strategy), float32, two microbatches
STEP_CASES = [("phi3_5_moe", "ep"), ("phi3_5_moe", "ep_fsdp"), ("deepseek_v3", "ep")]
STEP_BATCH, STEP_MICRO = 4, 2


def moe_case(case: str):
    """(arch, reference config, port config, numpy x) of a MoE case."""
    from repro.configs import get_config, reduced
    from repro_torch import configs as tcfg

    arch, changes = MOE_CASES[case]
    jc, tc = reduced(get_config(arch)), tcfg.reduced(tcfg.get_config(arch))
    if changes:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **changes))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **changes))
    x = np.random.default_rng(31).normal(size=MOE_X + (jc.d_model,)).astype(np.float32)
    return arch, jc, tc, x


def step_case(arch: str):
    """(reference config, port config, tokens, labels) of a step case: the
    training tests' reduced float32 configs and numpy batch."""
    import _torch_train as T

    cfg, tc = T.configs(arch)
    tokens, labels, _ = T.batch(cfg, b=STEP_BATCH)
    return cfg, tc, tokens, labels


def reference(tmp_path_factory, what: str) -> dict:
    """Run this file for ``what`` (``moe`` or ``step``) once a test
    process; its arrays."""
    out = Path(tmp_path_factory.getbasetemp()) / f"torch_shard_ref_{what}"
    if not (out / "ref.npz").exists():
        out.mkdir(exist_ok=True)
        env = dict(os.environ)
        src = str(Path(__file__).resolve().parents[1] / "src")
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        run = subprocess.run([sys.executable, __file__, str(out), what], env=env,
                             capture_output=True, text=True, timeout=600)
        assert run.returncode == 0 and "REF_OK" in run.stdout, run.stdout + run.stderr
    return dict(np.load(out / "ref.npz"))


def main(out_dir: str, what: str) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={MESH[0] * MESH[1]} " + os.environ.get("XLA_FLAGS", "")
    )
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.launch import steps as ST
    from repro.models import moe as MOE
    from repro.models import sharding as SD
    from repro.models import transformer as TFM
    from repro.optim import adamw

    assert len(jax.devices()) == MESH[0] * MESH[1], jax.devices()
    # Auto axes (jax.make_mesh's Explicit ones refuse the reference's
    # with_sharding_constraint on the installed jax)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(MESH), ("data", "model"))
    out = {}
    MOE.EP_CONTEXT["mesh"], MOE.EP_CONTEXT["dp"] = mesh, "data"
    for case in MOE_CASES if what == "moe" else ():
        _, cfg, _, x = moe_case(case)
        p = MOE.init_moe(jax.random.PRNGKey(8), cfg)
        y, aux = jax.jit(lambda p, x, cfg=cfg: MOE.apply_moe(p, cfg, x, "model"))(p, x)
        out[f"moe.{case}.out"] = np.asarray(y)
        for k, v in aux.items():
            out[f"moe.{case}.{k}"] = np.asarray(v)

    for arch, strategy in STEP_CASES if what == "step" else ():
        cfg, _, tokens, labels = step_case(arch)
        # dryrun.lower_cell's prologue
        plan = "tp" if strategy == "ep" else strategy
        TFM.ACT_CTX["spec"] = P("data", None, None) if strategy == "ep_fsdp" else None
        TFM.ACT_CTX["cast_params"] = strategy == "ep_fsdp"
        params = TFM.init_params(jax.random.PRNGKey(0), cfg)
        state = {"params": params, "opt": adamw.init(params)}
        shard = lambda specs: jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                           is_leaf=lambda s: isinstance(s, P))
        state_shard = {"params": shard(SD.param_specs(cfg, mesh, params, plan)),
                       "opt": shard(SD.opt_specs(cfg, mesh, state["opt"], plan))}
        bshard = {k: NamedSharding(mesh, s) for k, s in SD.batch_specs(cfg, mesh, plan).items()
                  if k in ("tokens", "labels")}
        step = ST.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=0), n_micro=STEP_MICRO,
                                  dp_spec=SD.batch_axes(cfg, mesh, plan), ep_axis="model")
        jitted = jax.jit(step, in_shardings=(state_shard, bshard), out_shardings=(state_shard, None))
        with mesh:
            new, metrics = jitted(jax.device_put(state, state_shard),
                                  jax.device_put({"tokens": tokens, "labels": labels}, bshard))
        tag = f"step.{arch}.{strategy}"
        for k, v in metrics.items():
            out[f"{tag}.metric.{k}"] = np.asarray(v)
        for i, v in enumerate(jax.tree.leaves(new["params"])):
            out[f"{tag}.params.{i}"] = np.asarray(v)
        for i, v in enumerate(jax.tree.leaves(new["opt"]["m"])):
            out[f"{tag}.m.{i}"] = np.asarray(v)
    np.savez(os.path.join(out_dir, "ref.npz"), **out)
    print("REF_OK")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
