"""Jittered exponential backoff with a deadline (port of
``paddle_tpu/robustness/retry.py``): the one retry policy every
transient-failure path shares (the TCPStore client's ops today).

* **Typed terminal error** — a retry budget that runs dry raises
  :class:`RetryError` carrying the attempt count, the elapsed time and the
  last underlying exception, never a bare re-raise.
* **Transient-only by default** — :func:`transient` matches connection
  resets and timeouts and a short list of retryable errnos; ``ENOSPC``,
  ``EACCES`` and ``ENOENT`` style errors fail fast.
* **Deterministic under test** — ``sleep`` and ``rng`` are injectable, and
  :func:`backoff_delays` draws its jitter from ``rng`` exactly as the JAX
  package does, so one seed gives the same delays in both packages.

Env knobs (read per call): ``PADDLE_TPU_RETRY_TRIES`` (default 5),
``PADDLE_TPU_RETRY_BASE_DELAY`` (default 0.05 s),
``PADDLE_TPU_RETRY_MAX_DELAY`` (default 2 s).
"""
from __future__ import annotations

import errno as _errno
import functools
import os
import random
import time
from typing import Callable, Iterator, Optional

__all__ = ["RetryError", "retry_call", "retrying", "transient",
           "backoff_delays", "env_float"]

#: OSError errnos worth retrying (transient IO and network hiccups).
#: ENOSPC, EACCES, ENOENT and the like are absent on purpose.
_TRANSIENT_ERRNOS = frozenset({
    _errno.EAGAIN, _errno.EBUSY, _errno.EINTR, _errno.EIO, _errno.ESTALE,
    _errno.ETIMEDOUT, _errno.ECONNRESET, _errno.ECONNREFUSED,
    _errno.ECONNABORTED, _errno.EPIPE, _errno.ENETRESET,
    _errno.EHOSTUNREACH, _errno.ENETUNREACH, _errno.ENETDOWN,
})


class RetryError(RuntimeError):
    """All attempts exhausted (count or deadline).  ``last_error`` holds
    the final underlying exception (also chained as ``__cause__``)."""

    def __init__(self, name: str, attempts: int, elapsed: float,
                 last_error: BaseException):
        super().__init__(
            "%s failed after %d attempt(s) over %.2fs; last error: %r"
            % (name, attempts, elapsed, last_error))
        self.name = name
        self.attempts = attempts
        self.elapsed = elapsed
        self.last_error = last_error


def transient(exc: BaseException) -> bool:
    """Default retry predicate: connection-level and short-lived OS
    errors."""
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError)):
        return True
    if isinstance(exc, OSError):
        return exc.errno in _TRANSIENT_ERRNOS
    return False


def backoff_delays(base: float = 0.05, factor: float = 2.0,
                   cap: float = 2.0, jitter: float = 0.0,
                   rng: Optional[random.Random] = None) -> Iterator[float]:
    """Infinite ``base * factor**k`` (capped) delay stream; with
    ``jitter`` in (0, 1], each delay is scaled by ``1 ± jitter``
    uniformly, so hosts retrying the same dead store do not retry in
    step."""
    delay = float(base)
    while True:
        d = min(delay, cap)
        if jitter:
            r = rng.random() if rng is not None else random.random()
            d *= 1.0 + jitter * (2.0 * r - 1.0)
        yield max(0.0, d)
        delay = min(delay * factor, cap)


def env_float(name: str, default: float) -> float:
    """A float knob from the environment; unset or empty -> ``default``."""
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError("%s must be a number of seconds, got %r"
                         % (name, raw))


def retry_call(fn: Callable, *args,
               retry_on=transient,
               tries: Optional[int] = None,
               base_delay: Optional[float] = None,
               max_delay: Optional[float] = None,
               deadline: Optional[float] = None,
               jitter: float = 0.25,
               rng: Optional[random.Random] = None,
               sleep: Callable[[float], None] = time.sleep,
               on_retry: Optional[Callable] = None,
               name: Optional[str] = None,
               **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying matching failures with
    jittered exponential backoff.

    ``retry_on`` is a predicate (exception -> bool) or an exception class
    or tuple; a non-matching exception propagates at once, untouched.
    ``deadline`` (seconds of wall clock from the first attempt) bounds the
    total time whatever ``tries`` says.  ``on_retry(exc, attempt, delay)``
    runs before each sleep: the hook where a store client reconnects its
    dead socket.  Exhaustion raises :class:`RetryError` from the last
    error.
    """
    if tries is None:
        tries = int(env_float("PADDLE_TPU_RETRY_TRIES", 5))
    if base_delay is None:
        base_delay = env_float("PADDLE_TPU_RETRY_BASE_DELAY", 0.05)
    if max_delay is None:
        max_delay = env_float("PADDLE_TPU_RETRY_MAX_DELAY", 2.0)
    if isinstance(retry_on, (tuple, list)) or isinstance(retry_on, type):
        excs = tuple(retry_on) if isinstance(retry_on, (tuple, list)) \
            else (retry_on,)

        def matcher(e):
            return isinstance(e, excs)
    else:
        matcher = retry_on
    # the label of the robustness.retry_attempts{op=} metric, whose value
    # space must stay bounded: a name, never repr(fn) (an address)
    target = getattr(fn, "func", fn)
    label = (name or getattr(fn, "__qualname__", None)
             or getattr(target, "__qualname__", None) or type(fn).__name__)
    delays = backoff_delays(base_delay, cap=max_delay, jitter=jitter,
                            rng=rng)
    start = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn(*args, **kwargs)
        except BaseException as e:
            if not matcher(e):
                raise
            elapsed = time.monotonic() - start
            out_of_budget = attempt >= tries or (
                deadline is not None and elapsed >= deadline)
            if out_of_budget:
                raise RetryError(label, attempt, elapsed, e) from e
            delay = next(delays)
            if deadline is not None:
                delay = min(delay, max(0.0, deadline - elapsed))
            from ..observability import registry as _metrics
            _metrics.counter("robustness.retry_attempts",
                             ("op",)).labels(op=label).inc()
            if on_retry is not None:
                on_retry(e, attempt, delay)
            sleep(delay)


def retrying(**cfg):
    """Decorator form of :func:`retry_call` with a fixed policy."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(fn, *args, name=getattr(fn, "__qualname__",
                                                      None), **cfg, **kwargs)
        return wrapper
    return deco
