"""Failure-handling primitives shared by the feed manager and the trainer:
bounded exponential-backoff retry and a metrics surface for fault events
(a copy of ``repro.runtime.fault``)."""

from __future__ import annotations

import functools
import logging
import time
from typing import Callable, Tuple, Type

log = logging.getLogger(__name__)


def retry(max_attempts: int = 3, backoff_s: float = 0.05,
          exceptions: Tuple[Type[BaseException], ...] = (Exception,),
          on_retry: Callable[[int, BaseException], None] | None = None):
    """Decorator: retries with exponential backoff; re-raises after
    ``max_attempts`` total attempts."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            attempt = 0
            while True:
                try:
                    return fn(*args, **kwargs)
                except exceptions as e:
                    attempt += 1
                    if attempt >= max_attempts:
                        raise
                    if on_retry is not None:
                        on_retry(attempt, e)
                    log.warning("retry %d/%d after %s", attempt,
                                max_attempts, e)
                    time.sleep(backoff_s * (2 ** (attempt - 1)))
        return wrapped
    return deco
