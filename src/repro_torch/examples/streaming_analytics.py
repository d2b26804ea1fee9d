"""End to end, the paper's own application: streaming network
analytics over hypersparse traffic, multi-instance, with checkpoint/restart,
written on the port's ``repro_torch.d4m`` session API.

Mirrors the Section V experiment structure: the session takes the mesh
engine at D>1 (D shards, no collective on the update path; on the card each
shard steps its hierarchy with the ``hier_cascade`` kernel behind
``sort_dedup``) or the single cascade at D=1, ingests R-MAT power-law
streams in fixed groups, snapshots analysis products (degree heavy hitters
through the bound query namespace), and checkpoints the stream cursor for
fault tolerance.  The mesh holds the first D cards, or ``cuda:0`` repeated
where there are fewer (``--device cpu``: the CPU repeated).

The restore drill: the checkpoint of group 20 is restored, groups 21 to 40
are replayed from the same draws, and the snapshot must equal the one
before the restore bit for bit; then the newest checkpoint (group 40)
restores to that snapshot too.

Run::

    PYTHONPATH=src python -m repro_torch.examples.streaming_analytics
    PYTHONPATH=src python -m repro_torch.examples.streaming_analytics --device cpu --group 256

:func:`main` returns its results as numpy, so that two runs can be
compared bit for bit.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import d4m
from repro_torch.core.mesh import Mesh
from repro_torch.data import rmat
from repro_torch.device import resolve_device


def _snap(sess) -> tuple:
    a = sess.snapshot()
    n = int(a.nnz)
    return (a.rows[:n].cpu().numpy(), a.cols[:n].cpu().numpy(), a.vals[:n].float().cpu().numpy())


def _same(a: tuple, b: tuple) -> bool:
    return all(x.shape == y.shape and np.array_equal(x.view(np.uint8), y.view(np.uint8)) for x, y in zip(a, b))


def run(device=None, devices: int = 4, group: int = 4096, groups: int = 40, scale: int = 18,
        every: int = 20, seed: int = 0, checkpoint_dir: Optional[str] = None) -> dict:
    """The example on ``device`` (``cuda`` unless given) over ``devices``
    shards; checkpoints every ``every`` groups into ``checkpoint_dir`` (a
    temporary directory, removed at the end, unless given)."""
    dev = resolve_device(device)
    cfg = d4m.StreamConfig(
        cuts=(2 * group, 16 * group),
        top_capacity=2_000_000,
        batch_size=group,
        devices=devices,  # D>1 -> mesh engine, D=1 -> the single cascade
        snapshot_cap=3_000_000,  # ~650 K distinct keys in this stream
    )
    print(cfg.plan().describe())
    mesh = None
    if devices > 1:
        mesh = Mesh.over(dev.type, devices, cfg.axis_name, repeat=True)
    own_dir = checkpoint_dir is None
    ckpt = tempfile.mkdtemp(prefix="repro_stream_ckpt_") if own_dir else checkpoint_dir
    try:
        sess = d4m.D4MStream(cfg, device=None if mesh is not None else dev, mesh=mesh,
                             checkpoint_dir=ckpt, checkpoint_keep=2)
        print("session:", sess)
        gen = torch.Generator(device=dev).manual_seed(seed)
        draws = []
        t0 = time.perf_counter()
        done = 0
        for g in range(groups):
            s, d = rmat.rmat_edges_torch(gen, (sess.n_instances, group), scale)
            v = torch.ones((sess.n_instances, group), dtype=torch.float32, device=dev)
            draws.append((s, d, v))
            _ingest(sess, s, d, v)
            done += sess.n_instances * group
            if (g + 1) % every == 0:
                sess.checkpoint(g + 1, extra={"cursor": g + 1})
                rate = done / (time.perf_counter() - t0)
                print(f"group {g + 1}: {done:,} updates, aggregate {rate:,.0f} upd/s, global nnz {sess.nnz():,}")
        sess.wait_checkpoint()
        rate = done / (time.perf_counter() - t0)

        # analysis products through the bound query namespace
        ids, counts = sess.query.top_k(5)
        print("top-5 out-degree vertices:", ids.tolist(), [int(x) for x in counts.tolist()])
        final = _snap(sess)
        tel = sess.telemetry()
        cascades = np.asarray(tel["cascades"] if "cascades" in tel else tel["cascades_per_instance"]).tolist()

        # restart drill: the earlier checkpoint, the groups after it replayed
        back = groups - every
        extra = sess.restore(step=back)
        assert extra["cursor"] == back, extra
        for s, d, v in draws[back:]:
            _ingest(sess, s, d, v)
        replayed = _same(_snap(sess), final)
        extra = sess.restore()
        restored = extra["cursor"] == groups and _same(_snap(sess), final)
        if not (replayed and restored):
            raise AssertionError(f"restart drill failed: replay from group {back} equal={replayed}, "
                                 f"restore of group {groups} equal={restored}")
        print(f"restored checkpoint at group {extra['cursor']} — restart drill ok")
        print(f"final aggregate rate: {rate:,.0f} updates/s on {sess.n_instances} instances")
        return {
            "kind": sess.kind,
            "n_instances": sess.n_instances,
            "updates": done,
            "rate": rate,
            "top_k": (ids.cpu().numpy(), counts.cpu().numpy()),
            "cascades": cascades,
            "snapshot": final,
            "drill": {"replayed_from": back, "restored": extra["cursor"]},
        }
    finally:
        if own_dir:
            shutil.rmtree(ckpt, ignore_errors=True)


def _ingest(sess, s, d, v) -> None:
    if sess.kind == "single":
        sess.update(s[0], d[0], v[0])
    else:
        sess.update(*sess.shard_stream(s, d, v))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--devices", type=int, default=4, help="shards D (D>1: the mesh engine)")
    ap.add_argument("--group", type=int, default=4096)
    ap.add_argument("--groups", type=int, default=40)
    ap.add_argument("--scale", type=int, default=18)
    ap.add_argument("--every", type=int, default=20, help="groups between checkpoints")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None, help="default: a temporary directory, removed at the end")
    args = ap.parse_args(argv)
    return run(args.device, args.devices, args.group, args.groups, args.scale, args.every, args.seed,
               args.checkpoint_dir)


if __name__ == "__main__":
    main()
