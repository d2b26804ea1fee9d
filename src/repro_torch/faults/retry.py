"""Shared retry policy: bounded exponential backoff + jitter + deadline.

Port of ``repro.faults.retry``, copied: it imports no JAX, and its wire
forms (environment variables, JSON, state dicts) are the reference's, so
what one package writes reads the same in the other.

One policy object serves every transient-failure path in the stack —
``serve.wire.send_triples`` connects, the fleet controller's data-plane
connects, and the worker's control-channel attach.  Keeping it here (not
per-module) means chaos tests and production callers tune one knob set.

Deterministic by construction: jitter comes from a seeded PRNG owned by
the policy *call*, so a given (policy, seed) pair produces the same sleep
schedule every run — chaos tests can assert on attempt counts.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with jitter and a wall-clock deadline.

    * ``max_attempts`` — total tries (first call counts as attempt 1);
    * ``base_delay_s`` — sleep after the first failure; doubles each retry;
    * ``max_delay_s`` — backoff ceiling;
    * ``deadline_s`` — total wall-clock budget across all attempts; the
      policy raises the last error rather than start an attempt it cannot
      possibly finish in budget (``None`` = unbounded);
    * ``jitter`` — each sleep is multiplied by ``1 ± jitter·u`` with
      ``u ~ U[-1, 1)`` from the seeded PRNG (0 disables jitter).
    """

    max_attempts: int = 5
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    deadline_s: Optional[float] = 30.0
    jitter: float = 0.1
    seed: int = 0

    def validate(self) -> "RetryPolicy":
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < self.base_delay_s:
            raise ValueError(
                f"need 0 <= base_delay_s <= max_delay_s, got "
                f"{self.base_delay_s}/{self.max_delay_s}"
            )
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        return self

    def delays(self) -> Tuple[float, ...]:
        """The jittered sleep schedule (len == max_attempts - 1)."""
        self.validate()
        rng = random.Random(self.seed)
        out = []
        for i in range(self.max_attempts - 1):
            d = min(self.base_delay_s * (2.0 ** i), self.max_delay_s)
            if self.jitter:
                d *= 1.0 + self.jitter * (rng.random() * 2.0 - 1.0)
            out.append(max(0.0, d))
        return tuple(out)

    def call(
        self,
        fn: Callable[[], T],
        retry_on: Tuple[Type[BaseException], ...] = (OSError,),
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ) -> T:
        """Invoke ``fn`` under this policy; returns its result or raises
        the final error.  ``on_retry(attempt, err)`` fires before each
        sleep (attempt is the 1-based attempt that just failed)."""
        delays = self.delays()
        start = clock()
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn()
            except retry_on as err:  # noqa: PERF203 - the whole point
                last = err
                if attempt >= self.max_attempts:
                    break
                d = delays[attempt - 1]
                if (
                    self.deadline_s is not None
                    and clock() - start + d > self.deadline_s
                ):
                    break
                if on_retry is not None:
                    on_retry(attempt, err)
                sleep(d)
        assert last is not None
        raise last
