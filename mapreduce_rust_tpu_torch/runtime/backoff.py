"""Jittered exponential backoff with a cap and a budget.

A copy of ``mapreduce_rust_tpu/runtime/backoff.py`` (stdlib only).

The RPC plane's retry primitive: every loop that used to
sleep a fixed constant on failure — the worker's connect retry, transient
call timeouts, the sentinel poll — now draws its delays from one of these.
Three properties, each encoding a production incident class:

- **exponential with jitter**: a fleet of workers reconnecting to a
  restarted coordinator must not arrive in lockstep (thundering herd); the
  jitter decorrelates them, the growth stops a tight failure loop from
  busy-hammering a struggling peer.
- **cap**: the delay never grows past ``cap_s`` — a transient blip must
  not leave a worker sleeping minutes after the peer recovered.
- **budget**: the total slept time is bounded by ``budget_s``; when it is
  spent, :meth:`next_delay` raises :class:`BackoffExhausted` so the caller
  surfaces the real error instead of retrying forever. ``budget_s=None``
  disarms the bound (sentinel polls: the phase gate can legitimately take
  arbitrarily long).

Pure stdlib — usable from the jax-free control-plane processes. The
mrlint ``unbounded-retry`` rule recognizes ``next_delay()`` as the
shipped-fix pattern for constant-sleep retry loops.
"""

from __future__ import annotations

import random


class BackoffExhausted(RuntimeError):
    """The retry budget is spent: stop retrying, raise the real error."""


class Backoff:
    def __init__(self, base_s: float, cap_s: float | None = None,
                 budget_s: float | None = None, factor: float = 2.0,
                 jitter: float = 0.5, rng: "random.Random | None" = None) -> None:
        if base_s <= 0:
            raise ValueError("base_s must be positive")
        if factor < 1.0:
            raise ValueError("factor must be >= 1.0 (delays must not shrink)")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.base_s = base_s
        self.cap_s = cap_s if cap_s is not None else base_s * 32
        self.budget_s = budget_s
        self.factor = factor
        self.jitter = jitter
        self._rng = rng or random
        self.attempts = 0
        self.spent_s = 0.0

    def next_delay(self) -> float:
        """The next sleep in seconds (monotonically growing envelope,
        jittered downward so concurrent retriers decorrelate). Raises
        :class:`BackoffExhausted` once ``budget_s`` is spent."""
        if self.budget_s is not None and self.spent_s >= self.budget_s:
            raise BackoffExhausted(
                f"retry budget exhausted after {self.attempts} attempts "
                f"({self.spent_s:.2f}s of {self.budget_s:.2f}s slept)"
            )
        delay = min(self.base_s * self.factor ** self.attempts, self.cap_s)
        if self.jitter:
            delay *= 1.0 - self.jitter * self._rng.random()
        if self.budget_s is not None:
            # The last sleep lands exactly on the budget, never past it.
            delay = min(delay, self.budget_s - self.spent_s)
        self.attempts += 1
        self.spent_s += delay
        return delay

    def reset(self) -> None:
        """Back to the base delay — call after a SUCCESS, so the next
        failure starts the envelope over instead of resuming at the cap."""
        self.attempts = 0
        self.spent_s = 0.0
