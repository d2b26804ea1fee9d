"""Deterministic, seeded fault injection for the serve/fleet stack.

Port of ``repro.faults.plan``, copied: it imports no JAX, and its wire
forms (environment variables, JSON, state dicts) are the reference's, so
what one package writes reads the same in the other.

The paper's operating regime (34,000 instances on 1,100 nodes) makes
worker death, torn writes and flaky sockets *routine*, not exceptional.
This module is the test substrate that proves the recovery contract —
exactly-once ingest or exactly-accounted loss — holds for every failure
class we can name, on one box, deterministically.

A :class:`FaultPlan` is a list of :class:`FaultSpec`\\ s, each naming one
**injection site** (a string from :data:`SITES`, compiled into the serve /
fleet / checkpoint code) and a seeded :class:`Trigger` deciding *when* the
site fires.  Components consult the plan with :meth:`FaultPlan.fire`;
when no plan is attached the per-call cost is one ``is not None`` check —
the plane costs nothing when disabled (gated by the serve/fleet trend
benches).

Activation paths:

* in-process — ``ServeConfig(faults=plan)`` / ``FleetController(faults=)``
  / ``CheckpointManager(..., faults=)``;
* subprocess workers — the :data:`ENV_VAR` environment variable carries
  ``plan.to_env()`` (JSON); ``FaultPlan.from_env()`` rebuilds it.  The
  fleet controller propagates its plan to every worker it spawns, and
  :data:`WORKER_ENV_VAR` binds each process to its worker id so
  ``only_worker=``-scoped specs target a single worker.

Trigger state (call counters, the probability PRNG) lives on the plan
*instance*: a plan shipped to N worker processes gives each an independent
counter set, which is exactly the semantics chaos tests want ("crash after
3 batches" means 3 batches of *each incarnation*).
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import threading
from typing import Any, Dict, List, Mapping, Optional

#: Environment variable carrying a JSON-serialized plan into subprocesses.
ENV_VAR = "REPRO_FAULTS"

#: Environment variable binding a process to a fleet worker id (set by the
#: worker entry point before it builds anything that reads :data:`ENV_VAR`).
WORKER_ENV_VAR = "REPRO_FAULTS_WORKER"

#: Environment variable binding a process to its worker *incarnation*
#: number (stamped by the fleet controller at spawn), for
#: ``only_generation``-scoped specs: crash generation 0 once, let every
#: revival run clean.
GENERATION_ENV_VAR = "REPRO_FAULTS_GENERATION"

#: Every injection site compiled into the stack.  A spec naming anything
#: else is rejected at construction, and ``fire()`` rejects unknown sites
#: too, so a typo'd site can never silently never-fire.
SITES = (
    # serve wire/client: send half of one chunk's encoded bytes, then stop
    # (a producer dying mid-frame)
    "wire.truncate_frame",
    # TCP ingress: forcibly reset one live producer connection on the
    # receive side (ECONNRESET semantics: parsed records survive, the
    # unparsed tail is lost and counted malformed)
    "source.conn_reset",
    # feed loop: sleep before dispatching a batch (a slow consumer, so the
    # bounded queue fills and the backpressure policy engages)
    "router.slow_consumer",
    # feed loop: hard-exit the process after the Nth fed batch (SIGKILL
    # shape: no unwind, no final checkpoint)
    "worker.crash_after_n_batches",
    # fleet worker report loop: stop making progress/reporting while the
    # control socket stays open (hung-but-connected; only the controller's
    # heartbeat deadline can see it)
    "worker.hang",
    # checkpoint publish: truncate arrays.npz before the atomic rename, so
    # a *published* checkpoint is torn (what a lying disk produces)
    "checkpoint.torn_write",
    # checkpoint publish: flip one payload byte before the rename (CRC
    # mismatch on restore)
    "checkpoint.corrupt_payload",
    # controller journal: the append fails as if the journal device were
    # full — the record must be rejected before any socket write
    "controller.journal_disk_full",
)


@dataclasses.dataclass(frozen=True)
class Trigger:
    """When a spec fires.  Construct via the classmethods.

    * ``nth(n)`` — fire exactly once, on the n-th consult (1-based);
    * ``prob(p, seed)`` — fire independently per consult with probability
      ``p`` from a dedicated seeded PRNG (deterministic per plan instance);
    * ``once_at(at)`` — fire once, at the first consult whose ``cursor``
      context value reaches ``at`` (cursor/count semantics are site-local);
    * ``always()`` — fire on every consult.
    """

    kind: str  # "nth" | "prob" | "once_at" | "always"
    n: int = 0
    p: float = 0.0
    seed: int = 0
    at: int = 0

    @classmethod
    def nth(cls, n: int) -> "Trigger":
        if n < 1:
            raise ValueError(f"nth trigger needs n >= 1, got {n}")
        return cls(kind="nth", n=int(n))

    @classmethod
    def prob(cls, p: float, seed: int = 0) -> "Trigger":
        if not 0.0 < p <= 1.0:
            raise ValueError(f"prob trigger needs 0 < p <= 1, got {p}")
        return cls(kind="prob", p=float(p), seed=int(seed))

    @classmethod
    def once_at(cls, at: int) -> "Trigger":
        return cls(kind="once_at", at=int(at))

    @classmethod
    def always(cls) -> "Trigger":
        return cls(kind="always")

    def validate(self) -> "Trigger":
        if self.kind not in ("nth", "prob", "once_at", "always"):
            raise ValueError(f"unknown trigger kind {self.kind!r}")
        if self.kind == "nth" and self.n < 1:
            raise ValueError(f"nth trigger needs n >= 1, got {self.n}")
        if self.kind == "prob" and not 0.0 < self.p <= 1.0:
            raise ValueError(f"prob trigger needs 0 < p <= 1, got {self.p}")
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Trigger":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown Trigger keys {sorted(unknown)}")
        return cls(**d).validate()


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault: a site, a trigger, optional action arguments.

    ``args`` parameterize the site's action (e.g. ``{"seconds": 0.05}`` for
    ``router.slow_consumer``) and must be JSON-serializable.
    ``only_worker`` scopes the spec to one fleet worker id; elsewhere (the
    controller process, plain serve) such a spec never fires unless the
    consult supplies a matching ``worker=``.  ``only_generation`` scopes it
    to one incarnation of that worker (the fleet controller stamps each
    spawn's generation into the environment) — generation 0 lets a chaos
    test crash/hang a worker exactly once and assert clean recovery, while
    an unscoped spec re-fires in every incarnation (the crash-loop /
    quarantine scenario).
    """

    site: str
    trigger: Trigger
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    only_worker: Optional[int] = None
    only_generation: Optional[int] = None

    def validate(self) -> "FaultSpec":
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; known sites: {SITES}"
            )
        self.trigger.validate()
        json.dumps(self.args)  # must survive the env/wire round trip
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "site": self.site,
            "trigger": self.trigger.to_dict(),
            "args": dict(self.args),
            "only_worker": self.only_worker,
            "only_generation": self.only_generation,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FaultSpec":
        known = {"site", "trigger", "args", "only_worker", "only_generation"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FaultSpec keys {sorted(unknown)}")
        return cls(
            site=d["site"],
            trigger=Trigger.from_dict(d["trigger"]),
            args=dict(d.get("args") or {}),
            only_worker=d.get("only_worker"),
            only_generation=d.get("only_generation"),
        ).validate()


class _SpecState:
    """Mutable per-spec runtime state (never serialized)."""

    __slots__ = ("calls", "fires", "done", "rng")

    def __init__(self, spec: FaultSpec):
        self.calls = 0
        self.fires = 0
        self.done = False  # one-shot triggers latch here
        self.rng = (
            random.Random(spec.trigger.seed)
            if spec.trigger.kind == "prob"
            else None
        )


class FaultPlan:
    """A set of :class:`FaultSpec`\\ s plus their runtime trigger state.

    Thread-safe: ``fire()`` may be consulted concurrently from reader /
    feeder / control threads.  Serialization (:meth:`to_dict` /
    :meth:`to_env`) carries only the specs — a deserialized plan starts
    with fresh counters, which is the per-process semantics fleet chaos
    tests rely on.
    """

    def __init__(self, specs: List[FaultSpec] | None = None):
        self.specs: List[FaultSpec] = [s.validate() for s in (specs or [])]
        self._state = {id(s): _SpecState(s) for s in self.specs}
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for s in self.specs:
            self._by_site.setdefault(s.site, []).append(s)
        self._lock = threading.Lock()
        self._bound_worker: Optional[int] = None
        self._bound_generation: Optional[int] = None

    # -- construction sugar --------------------------------------------------
    def add(
        self,
        site: str,
        trigger: Trigger,
        args: Dict[str, Any] | None = None,
        only_worker: Optional[int] = None,
        only_generation: Optional[int] = None,
    ) -> "FaultPlan":
        spec = FaultSpec(
            site=site, trigger=trigger, args=dict(args or {}),
            only_worker=only_worker, only_generation=only_generation,
        ).validate()
        self.specs.append(spec)
        self._state[id(spec)] = _SpecState(spec)
        self._by_site.setdefault(site, []).append(spec)
        return self

    def bind(self, worker: Optional[int]) -> "FaultPlan":
        """Bind this plan instance to a fleet worker id (the default
        ``worker=`` context for every subsequent :meth:`fire`)."""
        self._bound_worker = None if worker is None else int(worker)
        return self

    def bind_generation(self, generation: Optional[int]) -> "FaultPlan":
        """Bind this plan instance to a worker incarnation number (set by
        the fleet controller's spawn environment), for ``only_generation``
        scoping."""
        self._bound_generation = (
            None if generation is None else int(generation)
        )
        return self

    # -- the hot path --------------------------------------------------------
    def fire(
        self,
        site: str,
        worker: Optional[int] = None,
        cursor: Optional[int] = None,
    ) -> Optional[FaultSpec]:
        """Consult one injection site; returns the firing spec or ``None``.

        ``worker`` overrides the bound worker id for ``only_worker``
        scoping; ``cursor`` is the site-local progress value ``once_at``
        triggers compare against (records fed, batches fed, ...).
        """
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r}; known sites: {SITES}"
            )
        specs = self._by_site.get(site)
        if not specs:
            return None
        who = worker if worker is not None else self._bound_worker
        gen = self._bound_generation
        with self._lock:
            for spec in specs:
                if spec.only_worker is not None and spec.only_worker != who:
                    continue
                if spec.only_generation is not None and spec.only_generation != gen:
                    continue
                st = self._state[id(spec)]
                st.calls += 1
                t = spec.trigger
                hit = False
                if t.kind == "always":
                    hit = True
                elif t.kind == "nth":
                    hit = not st.done and st.calls == t.n
                elif t.kind == "prob":
                    hit = st.rng.random() < t.p
                elif t.kind == "once_at":
                    hit = (
                        not st.done
                        and cursor is not None
                        and int(cursor) >= t.at
                    )
                if hit:
                    if t.kind in ("nth", "once_at"):
                        st.done = True
                    st.fires += 1
                    return spec
        return None

    # -- observability -------------------------------------------------------
    def summary(self) -> Dict[str, Dict[str, int]]:
        """Per-site consult/fire counters (chaos tests assert on these)."""
        out: Dict[str, Dict[str, int]] = {}
        with self._lock:
            for spec in self.specs:
                st = self._state[id(spec)]
                agg = out.setdefault(spec.site, {"calls": 0, "fires": 0})
                agg["calls"] += st.calls
                agg["fires"] += st.fires
        return out

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"specs": [s.to_dict() for s in self.specs]}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FaultPlan":
        unknown = set(d) - {"specs"}
        if unknown:
            raise ValueError(f"unknown FaultPlan keys {sorted(unknown)}")
        return cls([FaultSpec.from_dict(s) for s in d.get("specs", [])])

    def to_env(self) -> str:
        """The :data:`ENV_VAR` value that rebuilds this plan in a
        subprocess (fresh counters, by design)."""
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_env(cls, environ: Mapping[str, str] | None = None) -> Optional["FaultPlan"]:
        """Rebuild a plan from the environment; ``None`` when unset (the
        zero-overhead default).  Auto-binds to :data:`WORKER_ENV_VAR` when
        the worker entry point has set it."""
        env = environ if environ is not None else os.environ
        raw = env.get(ENV_VAR)
        if not raw:
            return None
        plan = cls.from_dict(json.loads(raw))
        wid = env.get(WORKER_ENV_VAR)
        if wid is not None and wid != "":
            plan.bind(int(wid))
        gen = env.get(GENERATION_ENV_VAR)
        if gen is not None and gen != "":
            plan.bind_generation(int(gen))
        return plan

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        sites = [s.site for s in self.specs]
        return f"FaultPlan({sites}, bound_worker={self._bound_worker})"
