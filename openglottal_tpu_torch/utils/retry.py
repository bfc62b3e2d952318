"""Retry a call on a transient error.

Counterpart of ``openglottal_tpu/utils/retry.py``.  Measurement and
validation drivers that run for many minutes (a whole-cohort evaluation, a
chip run's phases) can lose their evidence to one failure that the next
attempt would not repeat: an I/O hiccup reading a video off a network
share, an out-of-memory error while another process briefly holds the
card's memory.  :func:`retry_transient` retries a call with a short linear
backoff.  It retries on ANY ``Exception`` by default: its callers are
harnesses, where a deterministic bug fails every attempt alike (costing
seconds, and still raising), while a transient error taken for a bug would
lose real results.
"""

from __future__ import annotations

import time
from typing import Callable, TypeVar

T = TypeVar("T")


OnError = Callable[[int, BaseException], None]


def retry_transient(fn: Callable[[], T], attempts: int = 3,
                    backoff_s: float = 3.0, on_error: OnError | None = None,
                    sleep: Callable[[float], None] = time.sleep) -> T:
    """Run ``fn()`` with up to ``attempts`` tries, sleeping ``backoff_s *
    (i + 1)`` after failure i.  ``on_error(attempt_index, exc)`` is called
    after each failed attempt (for logging); the last failure re-raises.
    ``sleep`` is injectable for tests."""
    last: BaseException | None = None
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 -- see the module docstring
            last = e
            if on_error is not None:
                on_error(i, e)
            if i + 1 < attempts:
                sleep(backoff_s * (i + 1))
    assert last is not None
    raise last
