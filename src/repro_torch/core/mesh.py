"""Device meshes, placement and collectives in one process (the port's
counterpart of ``jax.sharding.Mesh``, ``PartitionSpec``/``NamedSharding``,
``jax.device_put``, ``shard_map``'s per-device view and the ``lax``
collectives the reference's mesh and sharded-LM paths use: ``psum``,
``pmax``, ``all_to_all``, ``all_gather``, ``psum_scatter``,
``axis_index``).

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
``all-to-all``; ``all_gather``: ``all-gather``; ``psum_scatter``:
``reduce-scatter``; ``collective-permute`` stays zero: no ported caller
needs it), and adds one device's result bytes to
:attr:`Mesh.collective_bytes` (the per-chip bytes a roofline reads).  Data
moves between two distinct devices with ``.to(device, non_blocking=True)``
from the calling thread; on a repeated device it does not move.  Placement
(:func:`device_put`) and reading a placed value back (:meth:`Sharded.gather`)
are transfers, not collectives, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: the reference's collective kinds, by their HLO names, in the order its
#: ``bench_scaling.update_path_collectives`` reports them
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


class PartitionSpec(tuple):
    """How a leaf lies over a mesh: entry ``i`` says how dimension ``i`` is
    split: ``None`` not at all, an axis name or a tuple of them over those
    axes (row-major over them); missing trailing entries are ``None`` and
    the leaf is replicated over the axes it does not name.  ``P()`` is
    replicated, ``P("data")`` splits the leading dimension,
    ``P(None, "model")`` the second, ``P(("data", "model"), None)`` the
    leading one over both axes."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def dim_axes(self, i: int) -> Tuple[str, ...]:
        """The axes dimension ``i`` is split over (``()``: not split)."""
        p = self[i] if i < len(self) else None
        if p is None:
            return ()
        return tuple(p) if isinstance(p, (tuple, list)) else (p,)

    @property
    def axes(self) -> Tuple[str, ...]:
        """Every axis the leaf is split over, dimension by dimension: a
        device's block is numbered row-major over them
        (:meth:`Mesh.chunk_of`)."""
        return tuple(a for i in range(len(self)) for a in self.dim_axes(i))

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
        #: one device's result bytes of those collectives, by kind
        self.collective_bytes: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)
        self.counting = True

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
        self.collective_bytes = dict.fromkeys(COLLECTIVES, 0)

    @contextlib.contextmanager
    def uncounted(self):
        """Collectives run inside are not counted (a pass that only the
        one-shard-at-a-time executor runs)."""
        saved, self.counting = self.counting, False
        try:
            yield
        finally:
            self.counting = saved

    def count(self, kind: str, result: torch.Tensor) -> None:
        """Count one collective of ``kind`` whose result on a device is
        ``result`` (its bytes go to :attr:`collective_bytes`)."""
        if not self.counting:
            return
        self.collectives[kind] += 1
        self.collective_bytes[kind] += result.numel() * result.element_size()

    def axis_size(self, axis) -> int:
        """The size of an axis, or the product over a tuple of axes."""
        return math.prod(self.shape[a] for a in axis_tuple(axis))

    def distinct_devices(self) -> int:
        return len(set(self.device_list))

    def axis_index(self, axis: str) -> List[int]:
        """Each device's coordinate along ``axis`` (``lax.axis_index``)."""
        pos = self.axis_names.index(axis)
        return [int(c) for c in np.indices(self.devices.shape)[pos].ravel()]

    def _groups(self, axis) -> np.ndarray:
        """``[n_groups, size(axis)]`` flat device indices: each row the
        devices that share every coordinate but ``axis`` (a name or a tuple
        of names), in axis order (row-major over a tuple)."""
        axes = axis_tuple(axis)
        pos = [self.axis_names.index(a) for a in axes]
        idx = np.arange(self.size).reshape(self.devices.shape)
        return np.moveaxis(idx, pos, list(range(-len(pos), 0))).reshape(-1, self.axis_size(axes))

    def groups(self, axis) -> List[List[int]]:
        """The device groups a collective over ``axis`` runs in (flat
        indices into :attr:`device_list`)."""
        return [[int(i) for i in g] for g in self._groups(axis)]

    def chunk_of(self, spec: PartitionSpec) -> Tuple[List[int], int]:
        """Which block of a leaf split by ``spec`` each device holds
        (numbered row-major over ``spec.axes``), and the number of
        blocks."""
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
        self.count("all-reduce", out[0])
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
        self.count("all-to-all", out[0])
        return out

    def all_gather(self, xs, axis, dim: int = 0) -> List[torch.Tensor]:
        """``lax.all_gather(x, axis, axis=dim, tiled=True)``: every device
        gets its group's blocks concatenated along ``dim`` in axis order
        (one result per distinct device of a group, shared where the
        device repeats)."""
        self._check(xs)
        out: List[Any] = [None] * self.size
        for g in self._groups(axis):
            made: Dict[torch.device, torch.Tensor] = {}
            for j in g:
                dev = self.device_list[j]
                if dev not in made:
                    made[dev] = torch.cat([self._put(xs[i], j) for i in g], dim)
                out[j] = made[dev]
        self.count("all-gather", out[0])
        return out

    def psum_scatter(self, xs, axis, dim: int = 0) -> List[torch.Tensor]:
        """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
        the group's sum (in axis order), device ``j`` of a group keeping
        block ``j`` of it along ``dim`` as a buffer of its own."""
        self._check(xs)
        out: List[Any] = [None] * self.size
        for g in self._groups(axis):
            n = xs[g[0]].shape[dim]
            if n % len(g):
                raise ValueError(f"psum_scatter over {axis!r} needs dimension {dim} a multiple of {len(g)}, got {n}")
            acc = xs[g[0]]
            for j in g[1:]:
                acc = acc + self._put(xs[j], g[0])
            step = n // len(g)
            for k, j in enumerate(g):
                out[j] = acc.narrow(dim, k * step, step).to(self.device_list[j], copy=True)
        self.count("reduce-scatter", out[0])
        return out

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Mesh({self.shape}, devices={[str(d) for d in self.device_list]})"


# ---------------------------------------------------------------------------
# differentiable collectives over one model group (the sharded training step)
# ---------------------------------------------------------------------------
# A head-split training step runs one data shard's model group at a time as
# the SPMD program would: each device holds a copy of the values that are
# replicated over "model" (the residual stream, norms, the loss) and its own
# part of the split ones (its heads, FFN columns, experts, vocabulary block).
# Every device's copy of the loss is seeded with 1 in the backward, so the
# collectives between the two kinds of value take Megatron's pair:
# :class:`_SumToReplicas` ("g": the partial outputs of a row-split block
# summed; backward the identity) and :class:`_CopyToSplit` ("f": the
# identity before a column-split block; backward the sum of the parts'
# gradients).  A collective inside the split region keeps its own transpose
# (:class:`_GroupPsum`, :class:`_GroupAllGather`); one from the split region
# into the replicated one that gathers (the logits' vocabulary blocks) takes
# each device's own block back (:class:`_GatherToReplicas`).  Each counts on
# the mesh every time it runs, its backward included; a checkpointed
# layer's recompute runs (and counts) the forward again.

def _outputs_on(acc: torch.Tensor, devs) -> Tuple[torch.Tensor, ...]:
    """``acc`` on each of ``devs``, a tensor of its own each (a repeated
    device gets a copy)."""
    out, used = [], set()
    for dev in devs:
        same = torch.device(dev) == acc.device
        out.append(acc if same and acc.device not in used else acc.to(dev, copy=True))
        used.add(torch.device(dev))
    return tuple(out)


def _group_sum(xs, dev) -> torch.Tensor:
    acc = xs[0].to(dev)
    for x in xs[1:]:
        acc = acc + x.to(dev, non_blocking=True)
    return acc


def _sum_on_each(mesh, devs, xs, like=None):
    """The group's sum on every device (one counted ``all-reduce``);
    ``like`` gives the shape, dtype and device of a part whose gradient is
    ``None``."""
    if like is not None:
        xs = [torch.zeros(s, dtype=t, device=d) if x is None else x for x, (s, t, d) in zip(xs, like)]
    out = _outputs_on(_group_sum(xs, devs[0]), devs)
    mesh.count("all-reduce", out[0])
    return out


def _like(xs):
    return [(x.shape, x.dtype, x.device) for x in xs]


class _SumToReplicas(torch.autograd.Function):
    """g: the group's sum on every device (one ``all-reduce``); backward:
    each part takes its own device's gradient."""

    @staticmethod
    def forward(ctx, mesh, devs, *xs):
        return _sum_on_each(mesh, devs, xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(grads)


class _CopyToSplit(torch.autograd.Function):
    """f: the identity; backward: the sum of the devices' gradients on each
    of them (one ``all-reduce``)."""

    @staticmethod
    def forward(ctx, mesh, devs, *xs):
        ctx.mesh, ctx.devs, ctx.like = mesh, devs, _like(xs)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + _sum_on_each(ctx.mesh, ctx.devs, grads, ctx.like)


class _GroupPsum(torch.autograd.Function):
    """A psum inside the split region: the sum on every device, forward and
    backward (an ``all-reduce`` each way)."""

    @staticmethod
    def forward(ctx, mesh, devs, *xs):
        ctx.mesh, ctx.devs, ctx.like = mesh, devs, _like(xs)
        return _sum_on_each(mesh, devs, xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + _sum_on_each(ctx.mesh, ctx.devs, grads, ctx.like)


class _GroupAllGather(torch.autograd.Function):
    """An all-gather inside the split region (``dim``); backward its
    transpose, a ``reduce-scatter``: each device's block of the sum of the
    gathered gradients."""

    @staticmethod
    def forward(ctx, mesh, devs, dim, *xs):
        ctx.mesh, ctx.devs, ctx.dim = mesh, devs, dim
        ctx.sizes = [x.shape[dim] for x in xs]
        out = _outputs_on(torch.cat([x.to(devs[0]) for x in xs], dim), devs)
        mesh.count("all-gather", out[0])
        return out

    @staticmethod
    def backward(ctx, *grads):
        total = _group_sum([g for g in grads if g is not None], ctx.devs[0])
        parts = torch.split(total, ctx.sizes, ctx.dim)
        out = tuple(p.to(dev, copy=True) for p, dev in zip(parts, ctx.devs))
        ctx.mesh.count("reduce-scatter", out[0])
        return (None, None, None) + out


class _GatherToReplicas(torch.autograd.Function):
    """An all-gather (``dim``) from the split region into the replicated one
    (the loss); backward: each device keeps its own block of its own
    gradient (no collective)."""

    @staticmethod
    def forward(ctx, mesh, devs, dim, *xs):
        ctx.dim = dim
        ctx.sizes = [x.shape[dim] for x in xs]
        out = _outputs_on(torch.cat([x.to(devs[0]) for x in xs], dim), devs)
        mesh.count("all-gather", out[0])
        return out

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for k, g in enumerate(grads):
            lo = sum(ctx.sizes[:k])
            out.append(None if g is None else g.narrow(ctx.dim, lo, ctx.sizes[k]))
        return (None, None, None) + tuple(out)


class _CopyToGroup(torch.autograd.Function):
    """f from one device's value: ``x`` on each of ``devs``; backward the sum
    of their gradients on ``x``'s device (one ``all-reduce``)."""

    @staticmethod
    def forward(ctx, mesh, devs, x):
        ctx.mesh, ctx.dev = mesh, x.device
        return tuple(x.view_as(x) if torch.device(d) == x.device else x.to(d) for d in devs)

    @staticmethod
    def backward(ctx, *grads):
        acc = _group_sum([g for g in grads if g is not None], ctx.dev)
        ctx.mesh.count("all-reduce", acc)
        return None, None, acc


class _SumToOne(torch.autograd.Function):
    """g onto one device: the parts' sum on the first part's device (one
    ``all-reduce``); backward: each part takes that gradient."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.devs = [x.device for x in xs]
        acc = _group_sum(xs, xs[0].device)
        mesh.count("all-reduce", acc)
        return acc

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(g.to(d) for d in ctx.devs)


class ModelGroup:
    """The collectives over one model group of ``mesh`` (flat device
    indices ``idx``, in "model" order), on lists of one tensor a group
    device, differentiable and counted on ``mesh`` (see above).  Groups of
    one run nothing and count nothing."""

    def __init__(self, mesh: "Mesh", idx: Sequence[int]):
        self.full = mesh
        self.idx = list(idx)
        self.devs = [mesh.device_list[i] for i in self.idx]
        self.size = len(self.idx)

    def _run(self, fn, xs, *extra):
        if self.size == 1:
            return list(xs)
        return list(fn.apply(self.full, self.devs, *extra, *xs))

    def to_replicas(self, xs) -> List[torch.Tensor]:
        """g: the partial outputs summed onto every device."""
        return self._run(_SumToReplicas, xs)

    def to_split(self, xs) -> List[torch.Tensor]:
        """f: replicated values entering split compute."""
        return self._run(_CopyToSplit, xs)

    def gather_to_replicas(self, xs, dim: int) -> List[torch.Tensor]:
        return self._run(_GatherToReplicas, xs, dim)

    # ``serving``'s mesh calls inside the split region (the axis is "model")
    def psum(self, xs, axis=None) -> List[torch.Tensor]:
        return self._run(_GroupPsum, xs)

    def all_gather(self, xs, axis=None, dim: int = 0) -> List[torch.Tensor]:
        return self._run(_GroupAllGather, xs, dim)


def copy_to_group(mesh: Optional["Mesh"], x: torch.Tensor, devs) -> List[torch.Tensor]:
    """``x`` on each of ``devs`` (f: its gradient is their sum, one counted
    ``all-reduce`` where there are several)."""
    if mesh is None or len(devs) == 1:
        return [x.to(d) for d in devs]
    return list(_CopyToGroup.apply(mesh, list(devs), x))


def sum_to_one(mesh: Optional["Mesh"], parts) -> torch.Tensor:
    """The parts' sum on the first part's device (g onto one device: one
    counted ``all-reduce`` where there are several; its gradient goes to
    every part unchanged)."""
    if mesh is None or len(parts) == 1:
        return _group_sum(parts, parts[0].device)
    return _SumToOne.apply(mesh, *parts)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout: ``spec`` over ``mesh``."""

    mesh: Mesh
    spec: PartitionSpec


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A leaf placed over a mesh: ``shards[i]`` is device ``i``'s block
    (devices in :attr:`Mesh.device_list` order); devices that a spec
    replicates hold equal blocks.  ``shape`` is the leaf's own shape where
    its blocks carry padding (an uneven split, padded as GSPMD pads it:
    ``ceil(n / k)`` a block, zeros at the end); ``None`` where they tile it
    exactly."""

    sharding: NamedSharding
    shards: Tuple[torch.Tensor, ...]
    shape: Optional[Tuple[int, ...]] = None

    def gather(self, device=None) -> torch.Tensor:
        """The whole leaf on one device (the mesh's first by default), from
        one replica of each block, padding stripped."""
        mesh = self.sharding.mesh
        spec = self.sharding.spec
        device = mesh.device_list[0] if device is None else torch.device(device)
        chunks, n = mesh.chunk_of(spec)
        first = {c: i for i, c in reversed(list(enumerate(chunks)))}
        parts = [self.shards[first[c]].to(device) for c in range(n)]
        split = [i for i in range(parts[0].ndim) if spec.dim_axes(i)]
        if not split:
            out = parts[0]
        elif split == [0]:
            out = torch.cat(parts)
        else:
            dims = [mesh.axis_size(spec.dim_axes(i)) for i in split]
            block = parts[0].shape
            full = list(block)
            for i, k in zip(split, dims):
                full[i] *= k
            out = torch.empty(full, dtype=parts[0].dtype, device=device)
            for c, part in enumerate(parts):
                idx = [slice(None)] * len(full)
                for i, ci in zip(split, np.unravel_index(c, dims)):
                    idx[i] = slice(int(ci) * block[i], (int(ci) + 1) * block[i])
                out[tuple(idx)] = part
        if self.shape is not None and tuple(out.shape) != tuple(self.shape):
            out = out[tuple(slice(0, k) for k in self.shape)]
        return out

    def __array__(self, dtype=None, copy=None):
        out = self.gather("cpu").numpy()
        return out if dtype is None else out.astype(dtype)


def axis_tuple(axis) -> Tuple[str, ...]:
    """Mesh axes as a tuple: a name, a tuple or list of names, or ``None``
    (no axis)."""
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def block_shape(mesh: Mesh, spec: PartitionSpec, shape) -> Tuple[int, ...]:
    """The shape of a device's block of a leaf of ``shape`` split by
    ``spec``: ``ceil(n / k)`` along a dimension split ``k`` ways."""
    return tuple(-(-n // mesh.axis_size(spec.dim_axes(i))) if spec.dim_axes(i) else n
                 for i, n in enumerate(shape))


def block_of(t: torch.Tensor, mesh: Mesh, spec: PartitionSpec, i: int) -> torch.Tensor:
    """Device ``i``'s block of the whole leaf ``t`` (a view where no padding
    is needed; zeros fill an uneven split's last blocks)."""
    bshape = block_shape(mesh, spec, t.shape)
    chunks, _ = mesh.chunk_of(spec)
    split = [d for d in range(t.ndim) if spec.dim_axes(d)]
    coords = np.unravel_index(chunks[i], [mesh.axis_size(spec.dim_axes(d)) for d in split]) if split else ()
    out = t
    for d, c in zip(split, coords):
        lo = int(c) * bshape[d]
        out = out.narrow(d, min(lo, t.shape[d]), max(0, min(bshape[d], t.shape[d] - lo)))
    if tuple(out.shape) != bshape:
        full = torch.zeros(bshape, dtype=t.dtype, device=t.device)
        full[tuple(slice(0, k) for k in out.shape)] = out
        out = full
    return out


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


def device_put(x, sharding, copy: bool = False, pad: bool = False):
    """Place ``x`` (a tensor, a numpy array, a :class:`Sharded` leaf, or a
    tree of them) by ``sharding`` (a :class:`NamedSharding`, or a tree of
    them with ``x``'s structure down to them): each device gets its block,
    moved with ``.to(device, non_blocking=True)``.  A block already on its
    device is a view unless ``copy=True``, which gives every device buffers
    of its own (state that is updated in place needs them).  A split that
    does not divide its dimension raises ``ValueError``; with ``pad=True``
    it is padded as GSPMD pads it (:class:`Sharded`'s ``shape``)."""

    def put(leaf, sh: NamedSharding):
        if isinstance(leaf, Sharded):
            leaf = leaf.gather()
        t = _tensor(leaf)
        mesh, spec = sh.mesh, sh.spec
        for a in spec.axes:
            if a not in mesh.shape:
                raise ValueError(f"{spec!r} names axis {a!r}, not one of {mesh.axis_names}")
        if any(spec.dim_axes(d) for d in range(t.ndim, len(spec))):
            raise ValueError(f"{spec!r} has more entries than a leaf of shape {tuple(t.shape)} has dimensions")
        even = all(t.shape[d] % mesh.axis_size(spec.dim_axes(d)) == 0 for d in range(t.ndim) if spec.dim_axes(d))
        if not even and not pad:
            raise ValueError(f"a leaf of {tuple(t.shape)} does not split into {mesh.chunk_of(spec)[1]} blocks "
                             f"by {spec!r} (pad=True pads it as GSPMD does)")
        chunks, _ = mesh.chunk_of(spec)
        blocks: Dict[int, torch.Tensor] = {}
        for i, c in enumerate(chunks):
            if c not in blocks:
                blocks[c] = block_of(t, mesh, spec, i)
        return Sharded(sh, tuple(
            blocks[c].to(dev, non_blocking=True, copy=copy)
            for c, dev in zip(chunks, mesh.device_list)
        ), None if even else tuple(t.shape))

    return tree_map(put, x, sharding)


def local_shards(tree, n: int) -> Tuple[Any, ...]:
    """The per-device trees of a tree of :class:`Sharded` leaves over a
    mesh of ``n`` devices: tree ``i`` holds device ``i``'s blocks."""
    return tuple(tree_map(lambda leaf, _: leaf.shards[i], tree, None) for i in range(n))
