"""Static and dynamic analysis instruments for the port's runtime.

The port's copy of the JAX package's ``analysis`` package:

- :mod:`.lockdep`, a runtime lock-order verifier (the Linux-kernel lockdep
  idea in CPython terms), opt-in through ``NNSTPU_LOCKDEP=1`` or ini
  ``[analysis] lockdep``: it wraps ``threading.Lock``/``RLock``/
  ``Condition`` construction, keys every lock by allocation site, and
  accumulates the cross-thread acquisition-order graph.  Cycles in that
  graph are potential ABBA deadlocks; it also flags blocking acquires
  while holding other locks and blocking calls (socket receives without a
  timeout, an untimed ``queue.get``, ``subprocess`` waits) made under a
  lock.
- :mod:`.lint`, an AST contract lint (CLI:
  ``python -m nnstreamer_tpu_torch.tools.nnslint``) holding the port's
  hand-maintained registries against their use sites: hook points
  (``obs/hooks.py``), ``nnstpu_*`` metric names and conf knobs against
  ``docs/torch-observability.md``, NNSQ ``ERROR_TYPES`` wire codes
  against the typed exceptions, thread daemon/join hygiene, and bare
  ``except:`` handlers.
"""

from __future__ import annotations
