"""The JAX reference on a 4-device mesh, for the port's mesh tests
(``test_torch_distributed.py``, ``test_torch_mesh_session.py``).

The reference's multi-device programs need the host device count forced
before ``jax`` is imported, so they run in a subprocess of their own
(modelled on ``tests/d4m/_mesh_parity_main.py``): ``python
_torch_mesh_ref_main.py OUT_DIR`` writes ``OUT_DIR/ref.npz`` and a mesh
session's checkpoint under ``OUT_DIR/ckpt``, then prints ``REF_OK``.  The
tests call :func:`reference` (once a test process, the result kept in
pytest's base temporary directory), and build the same inputs with
:func:`sharded_inputs` and :func:`session_stream`.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

D = 4
PAD = 2**31 - 1

# ShardedAssoc: cuts, top capacity, batch a shard, key space, steps; the
# second case's slots are too small for its skewed batches (dropped > 0)
SHARDED_CASES = {
    "roomy": dict(cuts=(8,), top_capacity=256, batch_size=16, key_space=64, slot_cap=None),
    "tight": dict(cuts=(8,), top_capacity=256, batch_size=16, key_space=64, slot_cap=5),
}
SHARDED_STEPS = 4
# the D=4 mesh session: K=2 a shard
SESSION = dict(cuts=(16,), top_capacity=1024, batch_size=64, instances_per_device=2)
SESSION_STEPS = 6
SESSION_CAP = 2048


def sharded_inputs(case: str):
    """``[steps, D, B]`` rows, cols, vals (skewed rows, a PAD tail) and
    ``[Q]`` query keys."""
    cfg = SHARDED_CASES[case]
    rng = np.random.default_rng(7 if case == "roomy" else 8)
    shape = (SHARDED_STEPS, D, cfg["batch_size"])
    rows = np.where(rng.random(shape) < 0.5, rng.integers(0, 16, shape),
                    rng.integers(0, cfg["key_space"], shape)).astype(np.int32)
    cols = rng.integers(0, 8, shape).astype(np.int32)
    rows[:, :, -2:] = PAD
    cols[:, :, -2:] = PAD
    vals = rng.normal(size=shape).astype(np.float32)
    qr = np.concatenate([rows[0, :, 0], rows[-1, :, 1], [3, 63, 40]]).astype(np.int32)
    qc = np.concatenate([cols[0, :, 0], cols[-1, :, 1], [7, 0, 5]]).astype(np.int32)
    return rows, cols, vals, qr, qc


def session_stream():
    """``[steps, B]`` flat global batches for the mesh session."""
    rng = np.random.default_rng(11)
    shape = (SESSION_STEPS, SESSION["batch_size"])
    r = rng.integers(0, 96, shape).astype(np.int32)
    c = rng.integers(0, 96, shape).astype(np.int32)
    return r, c, np.ones(shape, np.float32)


def reference(tmp_path_factory) -> Path:
    """Run this file once a test process; the directory it wrote."""
    out = Path(tmp_path_factory.getbasetemp()) / "torch_mesh_ref"
    if not (out / "ref.npz").exists():
        out.mkdir(exist_ok=True)
        env = dict(os.environ)
        src = str(Path(__file__).resolve().parents[1] / "src")
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        run = subprocess.run([sys.executable, __file__, str(out)], env=env,
                             capture_output=True, text=True, timeout=600)
        assert run.returncode == 0 and "REF_OK" in run.stdout, run.stdout + run.stderr
    return out


def _leaves(h, prefix, out):
    for i, l in enumerate(h.layers):
        for f in ("rows", "cols", "vals", "nnz", "overflow"):
            out[f"{prefix}.layers{i}.{f}"] = np.asarray(getattr(l, f))
    out[f"{prefix}.cascades"] = np.asarray(h.cascades)


def main(out_dir: str) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={D} " + os.environ.get("XLA_FLAGS", "")
    )
    import jax
    import jax.numpy as jnp

    from repro import d4m
    from repro.core import distributed

    assert len(jax.devices()) == D, jax.devices()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(D), ("data",))
    out = {}
    for case, cfg in SHARDED_CASES.items():
        sa = distributed.ShardedAssoc(mesh, "data", **cfg)
        h = sa.init_state()
        rows, cols, vals, qr, qc = sharded_inputs(case)
        for t in range(SHARDED_STEPS):
            h, dropped = sa.update(h, jnp.asarray(rows[t]), jnp.asarray(cols[t]), jnp.asarray(vals[t]))
            out[f"{case}.dropped{t}"] = np.asarray(dropped)
            _leaves(h, f"{case}.step{t}", out)
        out[f"{case}.get"] = np.asarray(sa.get(h, jnp.asarray(qr), jnp.asarray(qc)))

    sess = d4m.D4MStream(d4m.StreamConfig(devices=D, **SESSION),
                         checkpoint_dir=os.path.join(out_dir, "ckpt"))
    assert sess.kind == "mesh" and sess.n_instances == D * SESSION["instances_per_device"]
    r, c, v = session_stream()
    for t in range(SESSION_STEPS):
        out[f"session.dropped{t}"] = np.asarray(sess.ingest(r[t], c[t], v[t]))
    _leaves(sess.state, "session.state", out)
    snap = sess.snapshot(cap=SESSION_CAP)
    for f in ("rows", "cols", "vals", "nnz", "overflow"):
        out[f"session.snapshot.{f}"] = np.asarray(getattr(snap, f))
    out["session.nnz"] = np.asarray(sess.nnz())
    sess.checkpoint(SESSION_STEPS, extra={"cursor": SESSION_STEPS * SESSION["batch_size"]})
    sess.wait_checkpoint()
    np.savez(os.path.join(out_dir, "ref.npz"), **out)
    print("REF_OK")


if __name__ == "__main__":
    main(sys.argv[1])
