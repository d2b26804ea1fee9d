"""Paper Fig. 6: aggregate update rate vs. number of instances (port of
the reference's ``benchmarks/bench_scaling.py``).

The paper's design is embarrassingly parallel: independent hierarchical
arrays, each ingesting its own stream, the aggregate rate the sum of theirs.
Two instance axes are measured here:

* **K, packed instances a device**: K instances updated in one step, the
  engine ``engine="auto"`` picks on the device (``cuda``: ``sort_dedup`` +
  one ``hier_cascade`` launch at K>1, ``single``: ``sort_dedup`` +
  ``merge_add`` at K=1; ``packed`` at K>1 on the CPU);
* **D, shards** (``device_sweep``): the ``mesh`` engine at every D = 1,
  2, 4, 8 shards of one instance each, one shard a device where there are
  enough and the devices repeated where there are fewer (the counterpart
  of the reference's forced host devices; each row states how many
  distinct devices the shards sat on), at the section's group size and
  R-MAT scale over ``device_groups`` steps.

Each leg records its engine; every instance's snapshot must hold its own
stream's count of distinct keys, with no overflow.  The streams are drawn
on the device (:func:`~repro_torch.data.rmat.rmat_edges_torch`) before the
clock starts, and their distinct keys counted there.
``update_path_collectives`` counts the collectives one mesh update runs
(the port's mesh counts each, ``core.mesh``): the paper's linear scaling
rests on there being none.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import d4m
from repro_torch.bench.reporting import BenchmarkReport
from repro_torch.core.mesh import Mesh
from repro_torch.data import rmat

from . import _common

#: the D axis' shard counts
MESH_SHARDS = (1, 2, 4, 8)


def make_session(
    k_per_device: int,
    n_dev: int,
    cuts,
    top_capacity: int,
    group_size: int,
    branchless: bool | None = True,
    device: str | torch.device = "cuda",
) -> d4m.D4MStream:
    """A mesh-engine session of ``n_dev`` shards over ``device``'s kind,
    the devices taken in turn (:meth:`Mesh.over` with ``repeat``)."""
    dev = _common.device_of(device)
    return d4m.D4MStream(d4m.StreamConfig(
        cuts=tuple(cuts),
        top_capacity=top_capacity,
        batch_size=group_size,
        instances_per_device=k_per_device,
        engine="mesh",
        branchless=branchless,
    ), mesh=Mesh.over(dev.type, n_dev, repeat=True))


def update_path_collectives(
    n_dev: int | None = None, k_per_device: int = 4, device: str | torch.device = "cuda"
) -> dict:
    """The collectives one mesh update runs, by the reference's HLO
    names (``n_dev`` shards, :data:`MESH_SHARDS`' largest by default).
    The paper's linear-scaling argument is structural: the instances are
    independent, so the update path must hold no collective."""
    n_dev = n_dev or max(MESH_SHARDS)
    sess = make_session(k_per_device, n_dev, (64,), top_capacity=4096, group_size=32,
                        branchless=None, device=device)
    n = sess.n_instances
    r = torch.zeros((n, 32), dtype=torch.int32, device=sess.device)
    c = torch.zeros((n, 32), dtype=torch.int32, device=sess.device)
    v = torch.ones((n, 32), dtype=torch.float32, device=sess.device)
    batch = sess.shard_stream(r, c, v)
    sess.state  # allocated before the count starts
    sess.mesh.reset_collectives()
    sess.update(*batch)
    return dict(sess.mesh.collectives)


def run_packed(
    k_per_device: int,
    n_dev: int = 1,
    groups: int = 20,
    group_size: int = 32,
    scale: int = 16,
    cuts=None,
    top_capacity: int | None = None,
    device: str | torch.device = "cuda",
    seed: int = 0,
    mesh: bool = False,
):
    """Aggregate updates/s of ``k_per_device`` x ``n_dev`` instances, each
    fed its own R-MAT group every step: at ``n_dev=1`` the engine
    ``engine="auto"`` picks, at ``n_dev>1`` (or with ``mesh``) the ``mesh``
    engine.  Returns ``(aggregate_rate, wall_s, n_instances, engine,
    nnz_exact, launches, distinct_devices)``."""
    dev = _common.device_of(device)
    cuts = cuts if cuts is not None else (group_size, 4 * group_size)
    top = top_capacity if top_capacity is not None else int(groups * group_size * 1.25)
    if n_dev > 1 or mesh:
        sess = make_session(k_per_device, n_dev, cuts, top, group_size, branchless=None, device=dev)
    else:
        sess = d4m.D4MStream(
            d4m.StreamConfig(cuts=tuple(cuts), top_capacity=top, batch_size=group_size,
                             instances_per_device=k_per_device),
            device=dev,
        )
    n_inst = sess.n_instances
    # the whole stream drawn on the device, placed, before the clock
    # starts: the timed loop is pure update cost
    gen = torch.Generator(device=dev).manual_seed(seed)
    R, C = rmat.rmat_edges_torch(gen, (groups, n_inst, group_size), scale)
    # each instance's distinct keys: (instance, row, col) packed in an int64
    inst = torch.arange(n_inst, dtype=torch.int64, device=dev).view(1, n_inst, 1)
    keys = torch.unique((inst << (2 * scale)) | (R.long() << scale) | C.long())
    want = torch.bincount(keys >> (2 * scale), minlength=n_inst).tolist()
    del inst, keys
    V = torch.ones((n_inst, group_size), dtype=torch.float32, device=dev)
    single = sess.kind == "single"
    if single:
        batches = [(R[g, 0], C[g, 0], V[0]) for g in range(groups)]
    else:
        batches = [sess.shard_stream(R[g], C[g], V) for g in range(groups)]

    before = _common.launch_counts()
    sess.update(*batches[0])  # warm-up (builds the kernels at first use)
    sess.synchronize()
    sess.reset()
    sess.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        sess.update(*b)
    sess.synchronize()
    dt = time.perf_counter() - t0
    launches = _common.launches_since(before)
    snaps = sess.snapshot(cap=sum(sess.plan.layer_caps), per_instance=not single)
    got = snaps.nnz.reshape(-1).tolist()
    exact = got == want and not sess.overflowed()
    total_updates = n_inst * groups * group_size
    kind = sess.kind
    distinct = sess.mesh.distinct_devices() if sess.mesh is not None else 1
    del sess, snaps, batches, R, C, V
    _common.release(dev)
    return total_updates / dt, dt, n_inst, kind, exact, launches, distinct


def run_parallel(
    n_dev: int,
    groups: int = 20,
    group_size: int = 10_000,
    scale: int = 18,
    device: str | torch.device = "cuda",
):
    """``n_dev`` one-instance shards (K = 1) on the ``mesh`` engine at
    every ``n_dev``, D = 1 included, as in the reference; the reference's
    cut schedule and top layer, scaled with ``groups`` and ``group_size``
    (its defaults are the reference's CI sizes).  Returns
    :func:`run_packed`'s tuple."""
    return run_packed(
        1,
        n_dev,
        groups=groups,
        group_size=group_size,
        scale=scale,
        cuts=(2 * group_size, 16 * group_size),
        top_capacity=groups * group_size * 2,
        device=device,
        mesh=True,
    )


def main(
    k_values=(1, 8, 64, 256),
    groups: int = 20,
    group_size: int = 32,
    scale: int = 16,
    device_sweep: bool = True,
    device: str = "cuda",
    device_groups: int | None = None,
):
    """Both axes at ``group_size`` records of R-MAT ``scale`` an instance a
    step: the K axis over ``groups`` steps, the D axis over
    ``device_groups`` (``groups`` by default)."""
    dev = _common.device_of(device)
    d_groups = device_groups or groups
    report = BenchmarkReport("scaling", device=str(dev))
    failures = []

    # -- D axis: one instance a shard (the reference's device sweep) --------
    if device_sweep:
        for n in MESH_SHARDS:
            rate, wall, _, engine, exact, launches, distinct = run_parallel(
                n, groups=d_groups, group_size=group_size, scale=scale, device=dev)
            if not exact:
                failures.append(f"d={n}: a shard's snapshot is not its stream's distinct keys")
            print(
                f"scaling,device_axis,n_instances={n},distinct_devices={distinct},engine={engine},"
                f"aggregate_rate={rate:,.0f}/s,per_instance={rate / n:,.0f}/s,wall_s={wall:.3f},"
                f"nnz_exact={exact},launches={launches}", flush=True,
            )
            report.add(
                "device_scaling",
                params={"n_devices": n, "k_per_device": 1, "n_instances": n,
                        "distinct_devices": distinct, "engine": engine,
                        "groups": d_groups, "group_size": group_size, "rmat_scale": scale},
                updates_per_sec=rate,
                wall_s=wall,
                per_instance_rate=rate / n,
                nnz_exact=bool(exact),
                launches=launches,
            )

    # -- K axis: packed instances a device (paper Fig. 6 shape) -------------
    n_dev = 1
    k_rates = {}
    for k in k_values:
        rate, wall, n_inst, engine, exact, launches, _ = run_packed(
            k, groups=groups, group_size=group_size, scale=scale, device=dev
        )
        if not exact:
            failures.append(f"k={k}: an instance's snapshot is not its stream's distinct keys")
        k_rates[k] = rate
        print(
            f"scaling,instance_axis,k_per_device={k},n_instances={n_inst},engine={engine},"
            f"aggregate_rate={rate:,.0f}/s,per_instance={rate / n_inst:,.0f}/s,"
            f"wall_s={wall:.3f},nnz_exact={exact},launches={launches}", flush=True,
        )
        report.add(
            "packed_scaling",
            params={
                "k_per_device": k,
                "n_devices": n_dev,
                "n_instances": n_inst,
                "groups": groups,
                "group_size": group_size,
                "rmat_scale": scale,
                "engine": engine,
            },
            updates_per_sec=rate,
            wall_s=wall,
            per_instance_rate=rate / n_inst,
            nnz_exact=bool(exact),
            launches=launches,
        )
    # the aggregate rate rises with K while packing amortizes the per-step
    # cost, then flattens once the card (or the host feeding it) saturates:
    # the verdict checks the rise up to the best K, which must not be the
    # first sweep point
    ks = sorted(k_rates)
    best_k = max(k_rates, key=k_rates.get)
    rising = [k for k in ks if k <= best_k]
    monotone_rise = len(rising) > 1 and all(
        k_rates[a] < k_rates[b] for a, b in zip(rising, rising[1:])
    )
    print(
        f"verdict,aggregate_rate_increases_with_k,{monotone_rise},"
        f"saturation_k={best_k},rates={k_rates}"
    )
    report.add(
        "verdict_rate_increases_with_k",
        params={"k_values": ks},
        passed=bool(monotone_rise),
        saturation_k=int(best_k),
        rates={str(k): k_rates[k] for k in ks},
    )

    # -- structural evidence: zero update-path collectives -------------------
    coll_k, coll_d = 4, max(MESH_SHARDS)
    colls = update_path_collectives(coll_d, k_per_device=coll_k, device=dev)
    total = sum(colls.values())
    if total:
        failures.append(f"a mesh update ran collectives: {colls}")
    print(f"verdict,update_path_collective_free,{total == 0},ops={colls}")
    report.add(
        "update_path_collectives",
        params={"k_per_device": coll_k, "n_devices": coll_d},
        passed=bool(total == 0),
        **colls,
    )
    per_inst = k_rates[best_k] / best_k
    proj = per_inst * 34_000
    print(
        f"projection,34000_instances,{proj:,.0f}/s at this device's "
        f"per-instance rate,(paper: 1.9e9/s on 34,000 Xeon cores)"
    )
    report.add(
        "projection_34000_instances",
        params={"basis_k": best_k, "basis_devices": n_dev},
        updates_per_sec=proj,
    )
    report.write()
    _common.raise_failures("scaling", failures)
    return k_rates


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, nargs="+", default=[1, 8, 64, 256],
                    help="instances-per-device sweep points")
    ap.add_argument("--groups", type=int, default=20)
    ap.add_argument("--group-size", type=int, default=32)
    ap.add_argument("--scale", type=int, default=16)
    ap.add_argument("--no-device-sweep", action="store_true")
    ap.add_argument("--device-groups", type=int, default=None,
                    help="steps of the D axis (default: --groups)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    main(
        k_values=tuple(args.k),
        groups=args.groups,
        group_size=args.group_size,
        scale=args.scale,
        device_sweep=not args.no_device_sweep,
        device=args.device,
        device_groups=args.device_groups,
    )
