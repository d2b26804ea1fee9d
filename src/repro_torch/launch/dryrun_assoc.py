"""Dry run of the paper's distributed structures over D shards (the
counterpart of ``repro.launch.dryrun_assoc``).

The reference lowers and compiles, at 512 forced devices, the update of:
  1. ``ParallelHierStream`` — one independent hierarchical array a shard
     (the paper's Section V design; its update must stay collective-free);
  2. ``ShardedAssoc`` — one global array sharded by row-key range, its
     update routed by ``all_to_all``;
and reads the collectives from the compiled program.  The port lowers
nothing: it builds both over a mesh of ``--devices`` shards on one device
(the port's mesh engine, A6), runs one update of ``--group`` records a
shard through each, and reports the collectives its mesh counted.  The
shape is the reference's: ``cuts = (group, 10 group)``, top capacity
``20 group``, ``ShardedAssoc``'s slots ``group / 16`` over a key space of
2^30.  The state's bytes are printed first; on one card, ``--devices`` and
``--group`` are cut to fit (the defaults are the reference's 512 and
100,000).

Usage:  python -m repro_torch.launch.dryrun_assoc [--devices 512] [--group 100000]
            [--out DIR] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

import torch

from repro_torch.core import distributed
from repro_torch.core.hierarchical import telescoped_caps
from repro_torch.core.mesh import Mesh
from repro_torch.device import resolve_device

ENTRY_BYTES = 12  # int32 row + int32 col + float32 value
KEY_SPACE = 1 << 30


def shapes(devices: int, group: int) -> dict:
    """Both designs' shape and state bytes (all shards)."""
    cuts = (group, 10 * group)
    top = 20 * group
    slot_cap = max(1, group // 16)
    par = sum(telescoped_caps(cuts, top, group)) * ENTRY_BYTES
    sh = sum(telescoped_caps(cuts, top, devices * slot_cap)) * ENTRY_BYTES
    return {"devices": devices, "group": group, "cuts": cuts, "top_capacity": top, "slot_cap": slot_cap,
            "parallel_state_bytes": devices * par, "sharded_state_bytes": devices * sh,
            "batch_bytes": devices * group * ENTRY_BYTES}


def _batch(devices: int, group: int, device, seed: int = 0):
    """``[D, group]`` uniform random triples over the key space, drawn on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    r = torch.randint(0, KEY_SPACE, (devices, group), generator=gen, device=device, dtype=torch.int64).to(torch.int32)
    c = torch.randint(0, KEY_SPACE, (devices, group), generator=gen, device=device, dtype=torch.int64).to(torch.int32)
    return r, c, torch.ones((devices, group), dtype=torch.float32, device=device)


def run(devices: int = 512, group: int = 100_000, device=None, log=print) -> dict:
    """Both designs' update over ``devices`` shards: collectives by kind,
    the state's bytes and the update's wall time."""
    dev = resolve_device(device)
    shp = shapes(devices, group)
    log(json.dumps({"bytes": shp}))
    mesh = Mesh([dev] * devices, ("data",))
    r, c, v = _batch(devices, group, dev)
    results = {"shape": shp}

    # --- 1. paper design: independent instances ---------------------------
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ps = distributed.ParallelHierStream(mesh, shp["cuts"], top_capacity=shp["top_capacity"], batch_size=group)
    h = ps.init_state()
    mesh.reset_collectives()
    t0 = time.perf_counter()
    h = ps.update(h, r, c, v)
    _sync(dev)
    colls = dict(mesh.collectives)
    results[f"parallel_hier_{devices}"] = {
        "status": "ran",
        "update_s": time.perf_counter() - t0,
        "collectives": colls,
        "update_path_collective_free": sum(colls.values()) == 0,
        "instances": devices,
        "updates_per_step": devices * group,
    }
    del h, ps

    # --- 2. beyond paper: one global key-range-sharded array ---------------
    sa = distributed.ShardedAssoc(mesh, "data", shp["cuts"], top_capacity=shp["top_capacity"],
                                  batch_size=group, key_space=KEY_SPACE, slot_cap=shp["slot_cap"])
    hs = sa.init_state()
    mesh.reset_collectives()
    t0 = time.perf_counter()
    hs, dropped = sa.update(hs, r, c, v)
    _sync(dev)
    colls2 = dict(mesh.collectives)
    results[f"sharded_assoc_{devices}"] = {
        "status": "ran",
        "update_s": time.perf_counter() - t0,
        "collectives": colls2,
        "collective_bytes": dict(mesh.collective_bytes),
        "routes_via_all_to_all": colls2.get("all-to-all", 0) > 0,
        "dropped": int(dropped),
    }
    del hs, sa
    return results


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--devices", type=int, default=512)
    ap.add_argument("--group", type=int, default=100_000)
    ap.add_argument("--device", default=None, help="the mesh's device (default cuda)")
    args = ap.parse_args(argv)
    results = run(args.devices, args.group, args.device)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"assoc_{args.devices}.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
