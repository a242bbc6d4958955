"""Bounded retry of transient host-side failures: the port of
commefficient_tpu/utils/retry.py.

TRANSIENT faults (a connection reset, a timed-out rendezvous, an
"unavailable" from a neighbour restarting) heal within seconds; FATAL
ones (shape errors, config mistakes, a scripted InjectedFault, an
out-of-memory) only get louder when replayed. `with_retries` retries
the transient class with exponential backoff up to a bound and
re-raises everything else at once.

FedModel.dispatch_rounds guards its span dispatch with it. A span's
rounds write the participants' client rows in place (federated/
round.scatter_back), the torch counterpart of the JAX engine's donated
state: a dispatch that already wrote into its input state must not be
replayed, so the model's `classify` refuses a retry once any state
tensor's version counter has moved (FedModel._span_classify).

The other guarded call is the rendezvous of a multi-process run
(parallel/multihost.initialize), the most failure-prone moment of a
launch: a neighbour starting a few seconds late looks like a dead
coordinator. `is_rendezvous_transient` adds torch.distributed's own
network error type to the transient class there.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")

# lowercase substrings that mark an error message as transient
_TRANSIENT_MARKERS = (
    "deadline_exceeded",
    "deadline exceeded",
    "unavailable",
    "connection refused",
    "connection reset",
    "connection closed",
    "socket closed",
    "failed to connect",
    "broken pipe",
    "temporarily unavailable",
    "transport closed",
    "timed out",
)

_TRANSIENT_TYPES: Tuple[Type[BaseException], ...] = (
    ConnectionError, TimeoutError,
)


def is_transient_error(exc: BaseException) -> bool:
    """Transient (retryable) or fatal. A scripted InjectedFault is
    always fatal: a retry would defeat the fault drills."""
    from commefficient_tpu_torch.utils.faults import InjectedFault
    if isinstance(exc, InjectedFault):
        return False
    if isinstance(exc, _TRANSIENT_TYPES):
        return True
    msg = str(exc).lower()
    return any(marker in msg for marker in _TRANSIENT_MARKERS)


def is_rendezvous_transient(exc: BaseException) -> bool:
    """The initialize guard's triage: is_transient_error, or a
    torch.distributed network error (a store that cannot reach its
    server yet). Anything else, a refused backend included, is
    fatal."""
    if is_transient_error(exc):
        return True
    import torch.distributed as dist
    net = getattr(dist, "DistNetworkError", None)
    return net is not None and isinstance(exc, net)


def with_retries(fn: Callable[[], T], *,
                 retries: int = 3,
                 base_delay: float = 0.5,
                 backoff: float = 2.0,
                 max_delay: float = 30.0,
                 classify: Callable[[BaseException], bool]
                 = is_transient_error,
                 describe: str = "operation",
                 sleep: Optional[Callable[[float], None]] = None,
                 on_retry: Optional[Callable[
                     [int, BaseException, float], None]] = None) -> T:
    """Call `fn()`; on a failure `classify` marks transient, retry up
    to `retries` more times after base_delay * backoff**attempt seconds
    (at most max_delay). Fatal failures, and the last transient one,
    re-raise unchanged. `on_retry(attempt, exc, delay)` runs before
    each backoff (the journal's `retry` event). `sleep` defaults to
    time.sleep, looked up at each backoff."""
    delay = base_delay
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as exc:
            if attempt >= retries or not classify(exc):
                raise
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            print(f"transient failure in {describe} "
                  f"(attempt {attempt + 1}/{retries + 1}): {exc!r}; "
                  f"retrying in {delay:.1f}s")
            (sleep or time.sleep)(delay)
            delay = min(delay * backoff, max_delay)
    raise AssertionError("unreachable")  # pragma: no cover
