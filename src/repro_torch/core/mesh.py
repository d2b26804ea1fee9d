"""Device meshes, placement and collectives in one process (the port's
counterpart of ``jax.sharding.Mesh``, ``PartitionSpec``/``NamedSharding``,
``jax.device_put``, ``shard_map``'s per-device view and the ``lax``
collectives the reference's mesh path uses: ``psum``, ``pmax``,
``all_to_all``, ``axis_index``).

A :class:`Mesh` is an n-d grid of ``torch.device``\\ s held by one
process, as the reference's mesh is held by one controller running one
``shard_map`` program.  A device may repeat: the counterpart of the
reference's ``--xla_force_host_platform_device_count``.
``Mesh([torch.device("cpu")] * 4, ("data",))`` holds four shards on the
CPU, ``Mesh([torch.device("cuda", 0)] * 4, ("data",))`` four on one card,
and on a host with four cards shard ``d`` sits on ``cuda:d`` with nothing
else changed.

A value over the mesh is a sequence holding one tensor per mesh device, in
row-major order of ``mesh.devices`` (:attr:`Mesh.device_list`): what
``shard_map`` hands each device as its local block.  The collectives take
such sequences and return one.  Each call counts once in
:attr:`Mesh.collectives` under the name XLA's HLO gives the reference's
collective (``psum``/``pmax``: ``all-reduce``; ``all_to_all``:
``all-to-all``); the reference's other three kinds (``all-gather``,
``reduce-scatter``, ``collective-permute``) are counted too, and stay zero
while no ported caller needs their operations.  Data moves
between two distinct devices with ``.to(device, non_blocking=True)`` from
the calling thread; on a repeated device it does not move.  Placement
(:func:`device_put`) and reading a placed value back (:meth:`Sharded.gather`)
are transfers, not collectives, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

#: the reference's collective kinds, by their HLO names, in the order its
#: ``bench_scaling.update_path_collectives`` reports them
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


class PartitionSpec(tuple):
    """How a leaf lies over a mesh: ``P()`` replicated, ``P("data")`` or
    ``P(("data", "model"))`` its leading dimension split over those axes
    (row-major over them) and replicated over the others.  The port splits
    leading dimensions only; later entries must be ``None``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    @property
    def axes(self) -> Tuple[str, ...]:
        if any(p is not None for p in self[1:]):
            raise NotImplementedError(f"{self!r}: the port splits a leaf on its leading dimension only")
        if not self or self[0] is None:
            return ()
        return tuple(self[0]) if isinstance(self[0], (tuple, list)) else (self[0],)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """An n-d grid of devices with one name per axis; ``shape[axis]`` is
    the axis' size, ``devices`` the grid (a numpy object array of
    ``torch.device``), as the reference reads its ``Mesh``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if grid.ndim != len(self.axis_names) or grid.size == 0:
            raise ValueError(
                f"a mesh needs a non-empty {len(self.axis_names)}-d grid of devices for "
                f"axes {self.axis_names}, got shape {grid.shape}"
            )
        self.device_list: List[torch.device] = [torch.device(d) for d in grid.ravel()]
        self.devices = np.asarray(self.device_list, dtype=object).reshape(grid.shape)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))
        self.size = len(self.device_list)
        #: collectives run over this mesh, by kind (see the module docstring)
        self.collectives: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)

    @classmethod
    def over(cls, kind, n: int, axis: str = "data", repeat: bool = False) -> "Mesh":
        """A one-axis mesh of ``n`` shards over the devices of ``kind``
        (``"cuda"``: every card, in index order; ``"cpu"``: the one CPU
        device).  Shard ``d`` sits on device ``d``; with ``repeat`` the
        devices are taken in turn, so a device holds several shards where
        there are fewer than ``n``.  Fewer devices than ``n`` without
        ``repeat`` raise ``ValueError``."""
        kind = torch.device(kind).type
        if kind == "cuda":
            devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devs = [torch.device(kind)]
        if not devs:
            raise ValueError(f"no {kind} device to build a mesh over")
        if n > len(devs) and not repeat:
            raise ValueError(
                f"{n} shards need {n} devices but only {len(devs)} {kind} device(s) are "
                f"available; to hold {n} shards on fewer devices, build a mesh that repeats "
                f"one: Mesh([torch.device({kind!r})] * {n}, ({axis!r},))"
            )
        return cls([devs[i % len(devs)] for i in range(n)], (axis,))

    def reset_collectives(self) -> None:
        self.collectives = dict.fromkeys(COLLECTIVES, 0)

    def distinct_devices(self) -> int:
        return len(set(self.device_list))

    def axis_index(self, axis: str) -> List[int]:
        """Each device's coordinate along ``axis`` (``lax.axis_index``)."""
        pos = self.axis_names.index(axis)
        return [int(c) for c in np.indices(self.devices.shape)[pos].ravel()]

    def _groups(self, axis: str) -> np.ndarray:
        """``[n_groups, size(axis)]`` flat device indices: each row the
        devices that share every coordinate but ``axis``, in axis order."""
        pos = self.axis_names.index(axis)
        idx = np.arange(self.size).reshape(self.devices.shape)
        return np.moveaxis(idx, pos, -1).reshape(-1, self.shape[axis])

    def chunk_of(self, spec: PartitionSpec) -> Tuple[List[int], int]:
        """Which chunk of a leading dimension split by ``spec`` each device
        holds, and the number of chunks."""
        axes = spec.axes
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"{spec!r} names axis {a!r}, not one of {self.axis_names}")
        dims = [self.shape[a] for a in axes]
        coords = np.indices(self.devices.shape).reshape(len(self.axis_names), -1)
        sel = [coords[self.axis_names.index(a)] for a in axes]
        chunks = np.ravel_multi_index(sel, dims) if axes else np.zeros(self.size, np.int64)
        return [int(c) for c in chunks], math.prod(dims)

    def _put(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return x.to(self.device_list[i], non_blocking=True)

    def _check(self, xs) -> None:
        if len(xs) != self.size:
            raise ValueError(f"a value over this mesh holds {self.size} tensors, got {len(xs)}")

    def _reduce(self, xs, axis: str, op) -> List[torch.Tensor]:
        self._check(xs)
        out: List[Any] = [None] * self.size
        for g in self._groups(axis):
            acc = xs[g[0]]
            for j in g[1:]:
                acc = op(acc, self._put(xs[j], g[0]))
            for j in g:
                out[j] = self._put(acc, j)
        self.collectives["all-reduce"] += 1
        return out

    # -- the collectives ------------------------------------------------------
    def psum(self, xs, axis: str) -> List[torch.Tensor]:
        """Every device gets the sum over its group along ``axis``, summed
        in axis order."""
        return self._reduce(xs, axis, torch.add)

    def pmax(self, xs, axis: str) -> List[torch.Tensor]:
        """Every device gets the maximum over its group along ``axis``."""
        return self._reduce(xs, axis, torch.maximum)

    def all_to_all(self, xs, axis: str) -> List[torch.Tensor]:
        """``lax.all_to_all(x, axis, 0, 0, tiled=False)``: each ``x`` has a
        leading dimension of ``size(axis)``; device ``j`` of a group gets
        ``stack([x_i[j] for i in the group])``."""
        self._check(xs)
        out: List[Any] = [None] * self.size
        for g in self._groups(axis):
            if any(xs[i].shape[0] != len(g) for i in g):
                raise ValueError(f"all_to_all over {axis!r} needs a leading dimension of {len(g)}")
            for j, dst in enumerate(g):
                out[dst] = torch.stack([self._put(xs[i][j], dst) for i in g])
        self.collectives["all-to-all"] += 1
        return out

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Mesh({self.shape}, devices={[str(d) for d in self.device_list]})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout: ``spec`` over ``mesh``."""

    mesh: Mesh
    spec: PartitionSpec


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A leaf placed over a mesh: ``shards[i]`` is device ``i``'s block
    (devices in :attr:`Mesh.device_list` order); devices that a spec
    replicates hold equal blocks."""

    sharding: NamedSharding
    shards: Tuple[torch.Tensor, ...]

    def gather(self, device=None) -> torch.Tensor:
        """The whole leaf on one device (the mesh's first by default), from
        one replica of each chunk."""
        mesh = self.sharding.mesh
        device = mesh.device_list[0] if device is None else torch.device(device)
        chunks, n = mesh.chunk_of(self.sharding.spec)
        first = {c: i for i, c in reversed(list(enumerate(chunks)))}
        parts = [self.shards[first[c]].to(device) for c in range(n)]
        return torch.cat(parts) if self.sharding.spec.axes else parts[0]

    def __array__(self, dtype=None, copy=None):
        out = self.gather("cpu").numpy()
        return out if dtype is None else out.astype(dtype)


def _tensor(x) -> torch.Tensor:
    """A tensor view of a leaf (numpy's ``|V2`` and ``ml_dtypes`` bfloat16
    by their bits)."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if x.dtype == np.dtype("V2") or x.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(x).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _children(tree):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, (type, Sharded, NamedSharding)):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, PartitionSpec):
        return list(tree)
    if isinstance(tree, dict):
        return [tree[k] for k in tree]
    return None


def _rebuild(tree, kids):
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: k for f, k in zip(dataclasses.fields(tree), kids)})
    if isinstance(tree, dict):
        return dict(zip(tree, kids))
    return type(tree)(kids)


def tree_map(fn, tree, prefix):
    """``fn(leaf, p)`` over the leaves of ``tree`` (tensors, arrays or
    :class:`Sharded` leaves inside dataclasses, tuples, lists and dicts),
    where ``prefix`` has ``tree``'s structure down to its own leaves: a
    leaf of ``prefix`` applies to every leaf of ``tree`` below it."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, prefix)
    pk = [prefix[k] for k in tree] if isinstance(tree, dict) and isinstance(prefix, dict) else _children(prefix)
    if pk is None:
        return _rebuild(tree, [tree_map(fn, k, prefix) for k in kids])
    if len(pk) != len(kids):
        raise ValueError(f"the spec tree does not match the state: {len(pk)} != {len(kids)} children")
    return _rebuild(tree, [tree_map(fn, k, p) for k, p in zip(kids, pk)])


def device_put(x, sharding, copy: bool = False):
    """Place ``x`` (a tensor, a numpy array, a :class:`Sharded` leaf, or a
    tree of them) by ``sharding`` (a :class:`NamedSharding`, or a tree of
    them with ``x``'s structure down to them): each device gets its chunk
    of the leading dimension, moved with ``.to(device, non_blocking=True)``.
    A chunk already on its device is a view unless ``copy=True``, which
    gives every device buffers of its own (state that is updated in place
    needs them)."""

    def put(leaf, sh: NamedSharding):
        if isinstance(leaf, Sharded):
            leaf = leaf.gather()
        t = _tensor(leaf)
        mesh = sh.mesh
        chunks, n = mesh.chunk_of(sh.spec)
        if sh.spec.axes and (t.ndim == 0 or t.shape[0] % n):
            raise ValueError(f"a leading dimension of {tuple(t.shape)[:1]} does not split into {n} chunks")
        step = t.shape[0] // n if sh.spec.axes else 0
        parts = [t[c * step:(c + 1) * step] if sh.spec.axes else t for c in range(n)]
        return Sharded(sh, tuple(
            parts[c].to(dev, non_blocking=True, copy=copy)
            for c, dev in zip(chunks, mesh.device_list)
        ))

    return tree_map(put, x, sharding)


def local_shards(tree, n: int) -> Tuple[Any, ...]:
    """The per-device trees of a tree of :class:`Sharded` leaves over a
    mesh of ``n`` devices: tree ``i`` holds device ``i``'s blocks."""
    return tuple(tree_map(lambda leaf, _: leaf.shards[i], tree, None) for i in range(n))
