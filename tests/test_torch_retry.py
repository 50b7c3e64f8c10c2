"""paddle_tpu_torch's retry policy against ``paddle_tpu``'s, after the
retry cases of ``tests/test_chaos.py``: the same backoff delays under one
seed (jitter on and off, capped), the same sleeps on the way to a
success, a typed exhaustion, non-transient errors failing fast, the
deadline bounding the total time, the ``retrying`` decorator and the
``robustness.retry_attempts`` counter."""
import errno
import random

import pytest

from paddle_tpu.robustness import retry as jax_retry
from paddle_tpu_torch.observability import registry as obs
from paddle_tpu_torch.robustness import retry as retry_mod
from paddle_tpu_torch.robustness.retry import (RetryError, backoff_delays,
                                               retry_call, retrying,
                                               transient)


@pytest.mark.parametrize("kw", [dict(base=0.1, jitter=0.5),
                                dict(base=0.05, cap=0.3, jitter=0.25),
                                dict(base=0.1, cap=0.4),
                                dict(base=0.01, factor=3.0, jitter=1.0)])
@pytest.mark.parametrize("seed", [0, 3])
def test_backoff_delays_equal_jax_under_one_seed(kw, seed):
    a = backoff_delays(rng=random.Random(seed), **kw)
    b = jax_retry.backoff_delays(rng=random.Random(seed), **kw)
    assert [next(a) for _ in range(12)] == [next(b) for _ in range(12)]


def test_backoff_without_jitter_is_capped_exponential():
    d = backoff_delays(0.1, cap=0.4, jitter=0.0)
    assert [next(d) for _ in range(4)] == [0.1, 0.2, 0.4, 0.4]


def test_retry_sleeps_equal_jax_on_the_way_to_success():
    """The same flaky call through both policies, one seed each: the
    same number of calls and the same jittered sleeps."""
    out = []
    for call in (retry_call, jax_retry.retry_call):
        calls, sleeps = {"n": 0}, []

        def flaky(calls=calls):
            calls["n"] += 1
            if calls["n"] < 4:
                raise ConnectionResetError("nope")
            return "ok"

        got = call(flaky, tries=6, base_delay=0.01, jitter=0.25,
                   rng=random.Random(7), sleep=sleeps.append)
        out.append((got, calls["n"], sleeps))
    assert out[0] == out[1] and out[0][1] == 4


def test_retry_exhaustion_raises_typed_error():
    def always():
        raise ConnectionResetError("still down")

    with pytest.raises(RetryError) as ei:
        retry_call(always, tries=3, base_delay=0.001, sleep=lambda d: None)
    assert ei.value.attempts == 3
    assert isinstance(ei.value.last_error, ConnectionResetError)
    assert isinstance(ei.value.__cause__, ConnectionResetError)


def test_retry_nontransient_fails_fast():
    calls = {"n": 0}

    def enospc():
        calls["n"] += 1
        raise OSError(errno.ENOSPC, "No space left on device")

    with pytest.raises(OSError) as ei:
        retry_call(enospc, tries=5, sleep=lambda d: None)
    assert calls["n"] == 1 and ei.value.errno == errno.ENOSPC
    for exc in (ei.value, ConnectionResetError(),
                OSError(errno.ETIMEDOUT, "t"), TimeoutError(), KeyError()):
        assert transient(exc) == jax_retry.transient(exc)


def test_retry_deadline_bounds_total_time(monkeypatch):
    t = {"now": 0.0}
    sleeps = []

    def fake_sleep(d):
        sleeps.append(d)
        t["now"] += d

    def always():
        raise ConnectionError("down")

    monkeypatch.setattr(retry_mod.time, "monotonic", lambda: t["now"])
    with pytest.raises(RetryError) as ei:
        retry_call(always, tries=1000, base_delay=0.5, jitter=0.0,
                   deadline=2.0, sleep=fake_sleep)
    assert ei.value.elapsed >= 2.0
    assert len(sleeps) < 10


def test_retrying_decorator_and_attempt_counter():
    c = obs.counter("robustness.retry_attempts", ("op",))
    calls = {"n": 0}

    @retrying(tries=4, base_delay=0.0, sleep=lambda d: None)
    def twice_flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionResetError("again")
        return calls["n"]

    label = twice_flaky.__qualname__
    before = c.labels(op=label).value
    assert twice_flaky() == 3
    assert c.labels(op=label).value - before == 2


def test_env_knobs(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_RETRY_TRIES", "2")
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise ConnectionResetError("x")

    with pytest.raises(RetryError):
        retry_call(always, base_delay=0.0, sleep=lambda d: None)
    assert calls["n"] == 2
    monkeypatch.setenv("PADDLE_TPU_RETRY_BASE_DELAY", "soon")
    with pytest.raises(ValueError, match="PADDLE_TPU_RETRY_BASE_DELAY"):
        retry_call(lambda: 1)
