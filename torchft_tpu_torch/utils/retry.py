"""Unified retry/backoff policy for every failure-bearing loop.

Before this module the package retried in three divergent ad-hoc loops
(RPC connect in coordination.py, checkpoint fetch in http_transport.py,
the manager-address store probe in manager.py), each with its own backoff
curve, deadline handling, and no jitter or accounting.  Centralizing the
policy is the stance of the reliable-collective literature (Prime PCCL,
"Reliable and Resilient Collective Communication Library", PAPERS.md):
retry behaviour must be one reviewable object, not folklore scattered
across call sites.

:class:`RetryPolicy` provides:

- **exponential backoff with full jitter**: each sleep is drawn uniformly
  from ``[0, min(max_delay, base_delay * multiplier**n)]`` — full jitter
  decorrelates retry storms after a shared failure (the AWS architecture
  result), which matters exactly when many replicas lose the same peer;
- **deadline budgets**: a total budget (``timeout`` per call or
  ``total_timeout`` on the policy) that is never exceeded, plus an
  optional per-attempt budget; attempts receive their remaining budget as
  an argument.  Expiry can arm an abort callback via
  :func:`torchft_tpu_torch.utils.futures.context_timeout` (e.g. ``pg.abort``)
  so a wedged attempt is cancelled, not just abandoned;
- **retryable-exception classification**: a tuple of types and/or a
  predicate — everything else propagates immediately;
- **accounting**: every retry increments
  ``torchft_retries_total{op}`` and records its backoff in
  ``torchft_retry_backoff_seconds{op}``.

Policies are frozen dataclasses — share them module-level, derive
variants with :func:`dataclasses.replace`.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Type

from torchft_tpu_torch.utils.futures import context_timeout

__all__ = ["RetryPolicy", "DEFAULT_RETRYABLE"]

#: Connection-ish failures that are safe to retry by default.  This
#: includes per-attempt socket timeouts (``TimeoutError`` subclasses
#: ``OSError`` since PEP 3151) — which is correct for connect-style
#: attempts whose budget is the *total* deadline; policies whose
#: attempts own their full timeout budget (e.g. the quorum RPC) should
#: narrow this to ``(ConnectionError,)`` so an expired attempt is not
#: doubled.  The ``TimeoutError`` :meth:`RetryPolicy.run` itself raises
#: on budget exhaustion is raised outside the attempt try and is never
#: self-retried.
DEFAULT_RETRYABLE: "Tuple[Type[BaseException], ...]" = (ConnectionError, OSError)


@dataclass(frozen=True)
class RetryPolicy:
    """Declarative retry/backoff policy; execute callables via :meth:`run`.

    Args:
        name: default metrics ``op`` label (override per call with ``op=``).
        max_attempts: total attempts allowed (``None`` = bounded only by
            the deadline budget).
        base_delay / multiplier / max_delay: the exponential backoff curve.
        jitter: full jitter (uniform in ``[0, cap]``) when True, the
            deterministic cap when False.
        total_timeout: default overall budget in seconds (``None`` =
            unbounded); ``run(timeout=...)`` overrides per call.
        attempt_timeout: optional per-attempt budget (clamped to the
            remaining total).
        retryable: exception types that may be retried.
        retry_if: optional predicate overriding ``retryable`` entirely.
    """

    name: str = "retry"
    max_attempts: "Optional[int]" = None
    base_delay: float = 0.1
    multiplier: float = 2.0
    max_delay: float = 10.0
    jitter: bool = True
    total_timeout: "Optional[float]" = None
    attempt_timeout: "Optional[float]" = None
    retryable: "Tuple[Type[BaseException], ...]" = DEFAULT_RETRYABLE
    retry_if: "Optional[Callable[[BaseException], bool]]" = None

    def is_retryable(self, exc: BaseException) -> bool:
        """Classification: predicate wins when present, else isinstance."""
        if self.retry_if is not None:
            return bool(self.retry_if(exc))
        return isinstance(exc, self.retryable)

    def backoff(self, attempt: int, rng: "Any" = random) -> float:
        """Sleep before retry number ``attempt`` (0-based): full jitter in
        ``[0, min(max_delay, base_delay * multiplier**attempt)]``."""
        cap = min(self.max_delay, self.base_delay * self.multiplier**attempt)
        return rng.uniform(0.0, cap) if self.jitter else cap

    def run(
        self,
        fn: "Callable[[Optional[float]], Any]",
        *,
        timeout: "Optional[float]" = None,
        op: "Optional[str]" = None,
        abort_cb: "Optional[Callable[[], None]]" = None,
        on_retry: "Optional[Callable[[BaseException, int, float], None]]" = None,
        rng: "Any" = random,
    ) -> Any:
        """Call ``fn(attempt_budget_seconds)`` until success/exhaustion.

        ``fn`` receives its per-attempt budget (``None`` when unbounded)
        and should pass it down as the attempt's own timeout.  When
        ``abort_cb`` is given and the attempt has a budget, the attempt is
        wrapped in ``context_timeout(abort_cb, budget)`` so expiry actively
        cancels it (e.g. ``pg.abort`` closing sockets).

        Raises ``TimeoutError`` when the deadline budget expires (the last
        attempt's error chained as ``__cause__``); re-raises the attempt's
        error when it is non-retryable or ``max_attempts`` is exhausted.
        ``on_retry(exc, attempt_number, delay)`` observes each retry.
        """
        from torchft_tpu_torch.utils import metrics as _metrics
        from torchft_tpu_torch.utils import flightrecorder as _flightrec

        op = op or self.name
        budget = self.total_timeout if timeout is None else timeout
        deadline = None if budget is None else time.monotonic() + budget
        attempt = 0
        last_exc: "Optional[BaseException]" = None
        while True:
            remaining: "Optional[float]" = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{op}: retry budget ({budget}s) exhausted after "
                        f"{attempt} attempt(s): {last_exc}"
                    ) from last_exc
            att_budget = remaining
            if self.attempt_timeout is not None:
                att_budget = (
                    self.attempt_timeout
                    if remaining is None
                    else min(self.attempt_timeout, remaining)
                )
            try:
                if abort_cb is not None and att_budget is not None:
                    with context_timeout(abort_cb, att_budget):
                        return fn(att_budget)
                return fn(att_budget)
            except Exception as e:  # noqa: BLE001 - classified below
                if not self.is_retryable(e):
                    raise
                last_exc = e
                attempt += 1
                if self.max_attempts is not None and attempt >= self.max_attempts:
                    raise
                delay = self.backoff(attempt - 1, rng)
                if deadline is not None:
                    delay = min(delay, max(deadline - time.monotonic(), 0.0))
                _metrics.RETRIES.labels(op=op).inc()
                _metrics.RETRY_BACKOFF.labels(op=op).observe(delay)
                # flight record per retry: torchft-torch-diagnose flags retry
                # storms (many of these in a short window) as a culprit
                # signal
                _flightrec.record(
                    "retry",
                    status="retry",
                    retry_op=op,
                    attempt=attempt,
                    backoff_s=round(delay, 4),
                    error=repr(e),
                )
                if on_retry is not None:
                    on_retry(e, attempt, delay)
                if delay > 0:
                    time.sleep(delay)
