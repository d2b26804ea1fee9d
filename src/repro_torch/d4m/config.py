"""Validated configuration + capacity planning for a D4M streaming session
(port of ``repro.d4m.config``: ``ServeConfig``, ``StreamConfig``,
``CapacityPlan``, ``plan``).

The wire form is the reference's, both ways: :meth:`StreamConfig.from_dict`
takes the reference's dict unchanged, and :meth:`StreamConfig.to_dict`
writes one the reference reads.  The reference's ``engine="pallas"`` (its
TPU kernel engine) names the port's kernel engine, ``"cuda"``: ``from_dict``
maps it there and ``to_dict`` writes it back.  ``devices=D > 1`` resolves
to the ``mesh`` engine, D shards of K instances
(:class:`~repro_torch.core.multistream.MultiStreamEngine`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Tuple

import torch

from repro_torch.core import semiring as semiring_mod
from repro_torch.core.hierarchical import geometric_cuts, telescoped_caps
from repro_torch.core.semiring import Semiring

ENGINES = ("auto", "single", "packed", "cuda", "mesh")

# opt-in override for "auto" engine resolution (CI forces paths with it)
ENGINE_ENV_VAR = "REPRO_D4M_ENGINE"

#: the reference's engine names that mean a port engine of another name
ENGINE_ALIASES = {"pallas": "cuda"}
#: the port's engine names that the reference's wire form spells otherwise
WIRE_ENGINES = {v: k for k, v in ENGINE_ALIASES.items()}

BACKPRESSURE_POLICIES = ("block", "drop")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the streaming ingress loop (:mod:`repro_torch.serve`); the
    reference's fields, defaults, checks and wire form.

    * ``max_batch``: records per global microbatch (``None``: the session's
      ``batch_size``, which it must not exceed);
    * ``max_latency_ms``: a partial microbatch flushes (PAD-padded) once its
      oldest record has waited this long;
    * ``queue_depth`` / ``backpressure``: the routed-batch queue between the
      batching thread and the feed loop holds ``queue_depth`` batches; when
      full, ``"block"`` stalls the producer (lossless) and ``"drop"``
      discards the newest batch and counts its records;
    * ``checkpoint_every``: checkpoint every N fed microbatches (needs the
      session's ``checkpoint_dir`` and ``backpressure="block"``: the saved
      cursor claims the fed records are an exact prefix of the source);
    * ``poll_interval_s``: the feed loop's queue poll and stale-flush cadence;
    * ``drain_timeout_s``: bound on the graceful drain at shutdown;
    * ``publish_every``: publish an immutable
      :class:`~repro_torch.d4m.session.StreamView` every N fed microbatches
      (``None``: no query plane); ``publish_cap`` its snapshot capacity;
    * ``track_degrees``: keep degree vectors on the host per fed microbatch
      and seed each published view with them;
    * ``faults``: a :class:`repro_torch.faults.FaultPlan` (chaos tests), else
      the ``REPRO_FAULTS`` environment variable;
    * ``metrics``: ``True``/``False`` arms or disarms the serve loop's
      :class:`~repro_torch.obs.MetricsRegistry`; ``None`` reads ``REPRO_OBS``;
    * ``profile_dir``: when set, the feed loop runs under
      :func:`repro_torch.obs.torch_profile` and writes its trace there.
    """

    max_batch: int | None = None
    max_latency_ms: float = 50.0
    queue_depth: int = 8
    backpressure: str = "block"
    checkpoint_every: int | None = None
    poll_interval_s: float = 0.005
    drain_timeout_s: float = 60.0
    publish_every: int | None = None
    publish_cap: int | None = None
    track_degrees: bool = True
    faults: Any = None  # Optional[repro_torch.faults.FaultPlan]
    metrics: bool | None = None
    profile_dir: str | None = None

    def validate(self) -> "ServeConfig":
        if self.max_batch is not None and self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_latency_ms <= 0:
            raise ValueError(f"max_latency_ms must be positive, got {self.max_latency_ms}")
        if self.queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {self.queue_depth}")
        if self.backpressure not in BACKPRESSURE_POLICIES:
            raise ValueError(
                f"backpressure must be one of {BACKPRESSURE_POLICIES}, got {self.backpressure!r}"
            )
        if self.checkpoint_every is not None and self.checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {self.checkpoint_every}")
        if self.checkpoint_every is not None and self.backpressure != "block":
            raise ValueError(
                "checkpoint_every requires backpressure='block': the saved "
                "cursor assumes fed records are an exact prefix of the "
                "source stream, which the 'drop' policy breaks (a restore "
                "would double-feed the post-drop tail and never replay the "
                "dropped batches)"
            )
        if self.publish_every is not None and self.publish_every < 1:
            raise ValueError(f"publish_every must be >= 1, got {self.publish_every}")
        if self.publish_cap is not None and self.publish_cap < 1:
            raise ValueError(f"publish_cap must be >= 1, got {self.publish_cap}")
        if self.publish_cap is not None and self.publish_every is None:
            raise ValueError(
                "publish_cap is set but publish_every is None — views are "
                "never published; set publish_every to enable the query plane"
            )
        if self.poll_interval_s <= 0:
            raise ValueError(f"poll_interval_s must be positive, got {self.poll_interval_s}")
        if self.drain_timeout_s <= 0:
            raise ValueError(f"drain_timeout_s must be positive, got {self.drain_timeout_s}")
        if self.faults is not None:
            from repro_torch.faults import FaultPlan

            if not isinstance(self.faults, FaultPlan):
                raise ValueError(
                    f"faults must be a repro_torch.faults.FaultPlan or None, "
                    f"got {type(self.faults).__name__}"
                )
        if self.metrics is not None and not isinstance(self.metrics, bool):
            raise ValueError(f"metrics must be True, False, or None, got {self.metrics!r}")
        if self.profile_dir is not None and not isinstance(self.profile_dir, str):
            raise ValueError(
                f"profile_dir must be a string path or None, got {type(self.profile_dir).__name__}"
            )
        return self

    def to_dict(self) -> dict:
        """JSON-ready dict; inverse of :meth:`from_dict`.  A fault plan
        travels as its spec list (a rebuilt plan starts with fresh
        counters)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "faults" and v is not None:
                v = v.to_dict()
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "ServeConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ServeConfig keys {sorted(unknown)}")
        d = dict(d)
        if d.get("faults") is not None and not hasattr(d["faults"], "fire"):
            from repro_torch.faults import FaultPlan

            d["faults"] = FaultPlan.from_dict(d["faults"])
        return cls(**d).validate()


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Everything a :class:`~repro_torch.d4m.session.D4MStream` needs,
    validated; the same fields and wire form as the reference."""

    top_capacity: int
    batch_size: int
    cuts: Tuple[int, ...] | None = None
    c1: int | None = None
    cut_ratio: int = 8
    n_layers: int | None = None
    semiring: str | Semiring = "plus.times"
    dtype: Any = "float32"
    instances_per_device: int = 1
    devices: int | None = 1
    axis_name: str = "data"
    engine: str = "auto"
    branchless: bool | None = None
    snapshot_cap: int | None = None
    max_fanout: int = 32
    seed: int = 0
    serve: ServeConfig | None = None

    def __post_init__(self):
        engine = ENGINE_ALIASES.get(self.engine, self.engine)
        object.__setattr__(self, "engine", engine)

    # -- resolution helpers -------------------------------------------------
    @property
    def sr(self) -> Semiring:
        if isinstance(self.semiring, Semiring):
            return self.semiring
        return semiring_mod.get(self.semiring)

    @property
    def torch_dtype(self) -> torch.dtype:
        if isinstance(self.dtype, torch.dtype):
            return self.dtype
        dt = getattr(torch, str(self.dtype), None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt

    def resolved_cuts(self) -> Tuple[int, ...]:
        if self.cuts is not None:
            return tuple(int(c) for c in self.cuts)
        if self.c1 is None or self.n_layers is None:
            raise ValueError(
                "StreamConfig needs either explicit cuts=... or a geometric "
                "schedule via c1=, cut_ratio=, n_layers="
            )
        return geometric_cuts(self.c1, self.cut_ratio, self.n_layers)

    def resolved_devices(self, device: str | torch.device = "cuda") -> int:
        """``devices``, where ``None`` means every device of ``device``'s
        kind: ``torch.cuda.device_count()`` on the card, 1 on the CPU."""
        if self.devices is None:
            if torch.device(device).type == "cpu":
                return 1
            return max(1, torch.cuda.device_count())
        return int(self.devices)

    def validate(self) -> "StreamConfig":
        cuts = self.resolved_cuts()
        if any(c <= 0 for c in cuts):
            raise ValueError(f"cuts must be positive, got {cuts}")
        if any(b <= a for a, b in zip(cuts, cuts[1:])):
            raise ValueError(f"cuts must be strictly increasing, got {cuts}")
        if self.top_capacity <= 0:
            raise ValueError(f"top_capacity must be positive, got {self.top_capacity}")
        if self.batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {self.batch_size}")
        if self.instances_per_device < 1:
            raise ValueError(
                f"instances_per_device must be >= 1, got {self.instances_per_device}"
            )
        d = self.resolved_devices()
        if d < 1:
            raise ValueError(f"devices must be >= 1, got {d}")
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {self.engine!r}")
        k = self.instances_per_device
        if self.engine == "single" and (k != 1 or d != 1):
            raise ValueError(
                f"engine='single' requires instances_per_device=1 and devices=1, "
                f"got K={k}, D={d}"
            )
        if self.engine in ("packed", "cuda") and d != 1:
            raise ValueError(f"engine={self.engine!r} requires devices=1, got D={d}")
        if self.max_fanout < 1:
            raise ValueError(f"max_fanout must be >= 1, got {self.max_fanout}")
        if self.serve is not None:
            self.serve.validate()
            if self.serve.max_batch is not None and self.serve.max_batch > self.batch_size:
                raise ValueError(
                    f"serve.max_batch ({self.serve.max_batch}) must not exceed "
                    f"batch_size ({self.batch_size}): the per-instance routing "
                    f"slot capacity is batch_size, so larger global microbatches "
                    f"could overflow a hash-skewed instance"
                )
        self.sr  # raises KeyError on an unknown semiring name
        self.torch_dtype
        return self

    # -- wire form -----------------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-ready dict in the reference's wire form (the kernel engine
        as ``"pallas"``); inverse of :meth:`from_dict`."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "semiring":
                v = v.name if isinstance(v, Semiring) else v
            elif f.name == "dtype":
                v = str(self.torch_dtype).removeprefix("torch.")
            elif f.name == "engine":
                v = WIRE_ENGINES.get(v, v)
            elif f.name == "serve" and v is not None:
                v = v.to_dict()
            elif isinstance(v, tuple):
                v = list(v)
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "StreamConfig":
        """Build from either package's :meth:`to_dict` wire form."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown StreamConfig keys {sorted(unknown)}")
        kw = dict(d)
        if kw.get("cuts") is not None:
            kw["cuts"] = tuple(int(c) for c in kw["cuts"])
        if kw.get("serve") is not None:
            kw["serve"] = ServeConfig.from_dict(kw["serve"])
        return cls(**kw).validate()

    def _engine_fits(self, engine: str, device: str | torch.device = "cuda") -> bool:
        """Whether ``engine`` is structurally valid for this K/D shape."""
        d = self.resolved_devices(device)
        if engine == "single":
            return self.instances_per_device == 1 and d == 1
        if engine in ("packed", "cuda"):
            return d == 1
        return engine in ENGINES

    def resolved_engine(self, device: str | torch.device = "cuda") -> str:
        """The engine ``"auto"`` resolves to on ``device``.

        The reference's order: an explicit ``engine=`` always wins; then the
        ``REPRO_D4M_ENGINE`` environment variable (the reference's names,
        ``"pallas"`` read as ``"cuda"``), when it fits the K/D shape (an
        override that does not fit is ignored; an unknown name raises
        ``ValueError``); then the shape heuristics: ``mesh`` at D>1 (D
        shards of K instances); at D=1, K>1 picks the ``cuda`` kernel engine
        on a CUDA device and the branchless ``packed`` engine on the CPU,
        and K=1 picks ``single``.
        """
        self.validate()
        engine = self.engine
        if engine == "auto":
            raw = os.environ.get(ENGINE_ENV_VAR, "").strip()
            env = ENGINE_ALIASES.get(raw, raw)
            if env and env not in ENGINES:
                raise ValueError(f"{ENGINE_ENV_VAR}={raw!r} is not one of {ENGINES}")
            if env and env != "auto" and self._engine_fits(env, device):
                engine = env
            elif self.resolved_devices(device) > 1:
                engine = "mesh"
            elif self.instances_per_device > 1:
                engine = "cuda" if torch.device(device).type == "cuda" else "packed"
            else:
                engine = "single"
        return engine

    # -- capacity planning ---------------------------------------------------
    def plan(self, hosts: int = 1) -> "CapacityPlan":
        """Telescoped layer capacities and the memory footprint, exactly as
        the reference plans them."""
        self.validate()
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        cuts = self.resolved_cuts()
        caps = list(telescoped_caps(cuts, self.top_capacity, self.batch_size))
        itemsize = self.torch_dtype.itemsize
        bytes_per_layer = tuple(cap * (4 + 4 + itemsize) for cap in caps)
        n_instances = self.instances_per_device * self.resolved_devices() * int(hosts)
        per_instance = sum(bytes_per_layer)
        snap = (
            int(self.snapshot_cap)
            if self.snapshot_cap is not None
            else sum(caps) * n_instances
        )
        return CapacityPlan(
            cuts=cuts,
            layer_caps=tuple(caps),
            bytes_per_layer=bytes_per_layer,
            bytes_per_instance=per_instance,
            n_instances=n_instances,
            total_bytes=per_instance * n_instances,
            snapshot_cap=snap,
            batch_size=int(self.batch_size),
            max_fanout=int(self.max_fanout),
            dtype_itemsize=itemsize,
            hosts=int(hosts),
        )


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """Resolved static-shape contract of a session (see StreamConfig.plan)."""

    cuts: Tuple[int, ...]
    layer_caps: Tuple[int, ...]
    bytes_per_layer: Tuple[int, ...]
    bytes_per_instance: int
    n_instances: int
    total_bytes: int
    snapshot_cap: int
    batch_size: int
    max_fanout: int
    dtype_itemsize: int
    hosts: int = 1

    @property
    def n_layers(self) -> int:
        return len(self.layer_caps)

    def describe(self) -> str:
        """Human-readable capacity/memory table."""
        fleet = f" on {self.hosts} host(s)" if self.hosts > 1 else ""
        lines = [
            f"D4M capacity plan: {self.n_layers} layers, "
            f"{self.n_instances} instance(s){fleet}, batch {self.batch_size}",
        ]
        for i, cap in enumerate(self.layer_caps):
            cut = self.cuts[i] if i < len(self.cuts) else None
            role = f"cut={cut}" if cut is not None else "top"
            lines.append(
                f"  layer {i + 1}: cap={cap:>12,}  {role:<16} "
                f"{self.bytes_per_layer[i] / 1e6:10.2f} MB"
            )
        lines.append(
            f"  per-instance {self.bytes_per_instance / 1e6:.2f} MB, total "
            f"{self.total_bytes / 1e6:.2f} MB across {self.n_instances} instance(s); "
            f"snapshot cap {self.snapshot_cap:,}"
        )
        return "\n".join(lines)
