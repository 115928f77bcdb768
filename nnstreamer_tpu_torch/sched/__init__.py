"""Serving QoS: the circuit breaker.

The port's part of the JAX package's ``sched`` package that the pipeline
watchdog needs: :mod:`.breaker` (:class:`~.breaker.CircuitBreaker` and the
weak registry whose :func:`~.breaker.trip_all` the watchdog's
overdue-device escalation calls).  The dispatch policies, admission
control and the ``Scheduler`` facade are not ported yet.
"""

from .breaker import (  # noqa: F401
    CODE_UNAVAILABLE,
    BreakerOpenError,
    CircuitBreaker,
    all_breakers,
    trip_all,
)
