"""Bounded retries with exponential backoff and full jitter (port of
the reference's ``utils/retry.py``): the one loop the orchestrator's
phases and its HTTP plane retry with.

* **full jitter** — the AWS-architecture-blog shape: the sleep before
  retry ``n`` is uniform in ``[0, min(cap, base * 2**n)]``. Full (not
  equal or decorrelated) jitter because every caller here is a
  *thundering-herd* path: coalesced ingest flushes against one backend,
  a fleet of orchestrators against one registry.
* **per-attempt timeout** — an attempt optionally runs on its own
  daemon thread (:func:`start_attempt_thread`) so a hung callee can
  never wedge the slot the next attempt needs. The thread is NOT
  reaped (Python cannot kill threads); the caller decides whether a
  still-running attempt makes a retry unsafe (the write buffer's
  hung-flush adoption) or merely wasteful (orchestrator phases, which
  are idempotent per cycle id).
* **BaseException discipline** — injected kills (storage.faults
  CrashError) and KeyboardInterrupt always propagate immediately; only
  ``retry_on`` Exception types are retried.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import random
import threading
import time
from typing import Callable, Optional, Tuple, Type

from predictionio_tpu_torch.obs.tracing import capture_context, carried


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How often, how long, and how patiently to retry.

    ``retries`` counts RE-tries: ``retries=4`` means up to 5 attempts.
    ``timeout_s`` bounds one attempt (None = unbounded); enforcement is
    the caller's (``retry_call`` runs timed attempts on their own
    thread). Defaults mirror the ingest flush tuning that shipped in
    the group-commit PR.
    """

    retries: int = 4
    backoff_s: float = 0.05
    backoff_cap_s: float = 1.0
    timeout_s: Optional[float] = None

    def attempts(self) -> int:
        return max(0, self.retries) + 1

    def delay_s(self, attempt: int, rng: Optional[random.Random] = None
                ) -> float:
        """The full-jitter sleep before retry ``attempt`` (0-based: the
        sleep between the first failure and the second attempt is
        ``delay_s(0)``)."""
        ceiling = min(self.backoff_cap_s,
                      self.backoff_s * (2.0 ** max(0, attempt)))
        if ceiling <= 0:
            return 0.0
        return (rng or _module_rng).uniform(0.0, ceiling)


#: module RNG: jitter needs no reproducibility by default; tests inject
#: a seeded random.Random for exact assertions
_module_rng = random.Random()


class RetryTimeout(Exception):
    """One attempt exceeded the policy's per-attempt timeout."""


def start_attempt_thread(fn: Callable, args: Tuple = (), *,
                         name: str = "pio-retry-attempt"
                         ) -> "concurrent.futures.Future":
    """Run one call on a fresh daemon thread, returning its future.

    A per-attempt thread (not a pool) so a hung callee can never wedge
    the slot the NEXT attempt needs; the thread dies whenever the call
    finally returns. The attempt re-enters the caller's trace context
    so a slow callee shows up inside the caller's span tree instead of
    as an orphan.
    """
    f: concurrent.futures.Future = concurrent.futures.Future()
    ctx = capture_context()

    def run():
        try:
            with carried(ctx, name, record=False):
                f.set_result(fn(*args))
        except BaseException as e:  # noqa: BLE001 — relayed to the waiter
            f.set_exception(e)

    threading.Thread(target=run, daemon=True, name=name).start()
    return f


def retry_call(fn: Callable, args: Tuple = (), *,
               policy: RetryPolicy,
               retry_on: Tuple[Type[Exception], ...] = (Exception,),
               on_retry: Optional[Callable[[int, Exception], None]] = None,
               sleep: Callable[[float], None] = time.sleep,
               rng: Optional[random.Random] = None,
               thread_name: str = "pio-retry-attempt"):
    """Call ``fn(*args)`` under the policy's attempt/backoff/timeout
    discipline; returns its result or raises the last failure.

    * only ``retry_on`` exceptions are retried; anything else —
      including BaseException kills — propagates immediately;
    * with ``policy.timeout_s`` set, each attempt runs on its own
      daemon thread and an over-budget attempt raises (and, if it was
      the last, re-raises) :class:`RetryTimeout`. The hung thread is
      abandoned — only use timeouts on calls that are safe to overlap
      with their own retry (idempotent, or keyed so the loser no-ops);
    * ``on_retry(attempt, error)`` fires before each backoff sleep —
      the metrics/log hook.
    """
    last_err: Optional[Exception] = None
    for attempt in range(policy.attempts()):
        try:
            if policy.timeout_s is None:
                return fn(*args)
            running = start_attempt_thread(fn, args, name=thread_name)
            try:
                return running.result(timeout=policy.timeout_s)
            except concurrent.futures.TimeoutError:
                if running.done():      # resolved between wait and check
                    return running.result(timeout=0)
                raise RetryTimeout(
                    f"attempt {attempt + 1} exceeded "
                    f"{policy.timeout_s}s") from None
        except RetryTimeout as e:
            last_err = e                # timeouts are always retryable
        except retry_on as e:
            last_err = e
        if attempt >= policy.retries:
            break
        if on_retry is not None:
            on_retry(attempt, last_err)
        sleep(policy.delay_s(attempt, rng))
    assert last_err is not None
    raise last_err


async def retry_call_async(coro_fn: Callable, args: Tuple = (), *,
                           policy: RetryPolicy,
                           retry_on: Tuple[Type[Exception], ...] = (
                               Exception,),
                           on_retry: Optional[Callable] = None,
                           rng: Optional[random.Random] = None):
    """The asyncio twin of :func:`retry_call` for coroutine callables
    (the admin server's fleet fetches). Per-attempt timeout uses
    ``asyncio.wait_for`` — the attempt is properly CANCELLED on
    timeout, so no abandoned work."""
    import asyncio

    last_err: Optional[Exception] = None
    for attempt in range(policy.attempts()):
        try:
            if policy.timeout_s is None:
                return await coro_fn(*args)
            return await asyncio.wait_for(coro_fn(*args),
                                          timeout=policy.timeout_s)
        except asyncio.TimeoutError:
            last_err = RetryTimeout(
                f"attempt {attempt + 1} exceeded {policy.timeout_s}s")
        except retry_on as e:
            last_err = e
        if attempt >= policy.retries:
            break
        if on_retry is not None:
            on_retry(attempt, last_err)
        await asyncio.sleep(policy.delay_s(attempt, rng))
    assert last_err is not None
    raise last_err
