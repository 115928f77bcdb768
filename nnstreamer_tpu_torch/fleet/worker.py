"""One fleet worker: a QueryServer (and optionally a DecodeServer) plus
lifecycle — graceful drain on SIGTERM, abrupt kill for chaos, restart
for churn soaks — behind a single handle.

The port of the JAX package's ``fleet/worker.py``.  A worker serves on its
``device``: the card by default (without one the constructor raises unless
``device="cpu"``).  On the card it serves the ``fragment`` backend (a
launch-string chain, e.g. slice 1's normalize and MobileNet-v2) or
``framework=torch``; :data:`BUILTIN_MODELS` (framework ``custom``) stay for
the CPU tests.  :meth:`FleetWorker.stats` carries the launch counts of the
port's kernel wrappers in this process (``kernels``), so a fleet scrape
shows which kernels its workers ran.

Two deployment shapes share this class:

- **subprocess** (``python -m nnstreamer_tpu_torch.fleet worker``): one
  worker per process.  ``health_port`` starts a
  :class:`~nnstreamer_tpu_torch.obs.export.MetricsServer` whose
  ``/healthz`` (JSON status + reasons) is what fleet membership probes, and
  whose ``/profile`` and ``/trace.json`` the cluster collector reads; a
  SIGTERM drains both servers — in-flight dispatches finish, idle
  connections get typed ``[UNAVAILABLE]`` goodbyes, live decode sessions
  get the drain deadline — and the process exits 0.
- **in-process** (tests, chaos soaks): many workers inside one test
  process, each with its own servers on distinct ports.  Membership
  probes them through :meth:`probe` instead of HTTP (process-global
  health providers would cross-talk), and the chaos harness drives
  :meth:`kill` / :meth:`hang` / :meth:`restart`.

``tracers`` (``"device;costmodel"``) attaches the named tracers to the
worker's serving scope (:class:`ServeScope`): the stages of a fragment
served here dispatch under it, so the device lane times each request's
dispatch by CUDA events (a ``device_exec`` span on the request's trace)
and the cost model banks it per stage (``stats()["cost_model"]``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..device import resolve_device
from ..elements.query import QueryServer

# models servable by name from the worker CLI (framework "custom");
# tiny on purpose — the fleet tests need workers, not accuracy
BUILTIN_MODELS: Dict[str, Callable] = {
    "x2": lambda x: x * 2.0,
    "x3": lambda x: x * 3.0,
    "sum": lambda x: x.reshape(-1).sum()[None],
}


def resolve_model(model, framework: str = "custom"):
    """A CLI ``--model`` name -> callable; callables pass through.

    Only the ``custom`` frameworks take builtin-model names — other
    backends (``fragment`` launch strings, ``torch`` model files) own
    their model argument's meaning, so it passes through untouched."""
    if isinstance(model, str) and framework.startswith("custom"):
        try:
            return BUILTIN_MODELS[model]
        except KeyError:
            raise ValueError(
                f"unknown builtin model {model!r} "
                f"(known: {sorted(BUILTIN_MODELS)})") from None
    return model


def kernel_launches() -> Dict[str, int]:
    """This process's launch count of each kernel wrapper (a wrapper adds
    one where it launches its kernel on the card, and nowhere else)."""
    from ..ops.kernels import KERNELS

    return {k.__name__: int(k.launches) for k in KERNELS}


class ServeScope:
    """What a worker's served stages dispatch under: the tracers of
    ``tracers`` are started on it as on a pipeline named ``name``
    (``node.pipeline is scope`` is how they recognize its stages)."""

    def __init__(self, name: str):
        self.name = name
        self._leaves: set = set()
        self.tracers: Dict[str, object] = {}

    def attach(self, names) -> None:
        """Start the named tracers on this scope (again, after a
        :meth:`detach`: a restarted worker keeps its tracers' data)."""
        from ..obs.tracers import make_tracer

        for name in names:
            if name not in self.tracers:
                self.tracers[name] = make_tracer(name)
            self.tracers[name].start(self)

    def detach(self) -> None:
        for tracer in self.tracers.values():
            tracer.stop()


class FleetWorker:
    """The servers of one worker plus drain/kill/restart lifecycle."""

    def __init__(self, name: str = "worker", host: str = "127.0.0.1",
                 port: int = 0, framework: str = "custom", model="x2",
                 custom: str = "", batch: int = 0,
                 batch_window_ms: float = 2.0, max_batch: int = 64,
                 scheduler=None, engine=None, decode_port: Optional[int] = None,
                 health_port: Optional[int] = None,
                 drain_timeout_s: float = 10.0,
                 warmup_spec=None, warmup_engine: bool = False,
                 device="cuda", tracers: str = "",
                 on_warmup_error: Optional[Callable[[BaseException], None]] = None):
        """``engine`` turns on the stateful surface: either a live
        :class:`~nnstreamer_tpu_torch.serving.ContinuousBatcher` or a kwargs
        dict to build one on ``device`` (the CLI path), served by a
        DecodeServer on ``decode_port``.  ``health_port`` (subprocess mode)
        starts the metrics/health endpoint and registers this worker's
        drain state as a health provider.

        ``warmup_spec`` (a :class:`~nnstreamer_tpu_torch.spec.TensorsSpec`
        of one request ROW) turns on capture-ahead: after the servers come
        up, a warmup thread drives :meth:`QueryServer.warmup` over the
        sub-dispatch bucket ladder (plus :meth:`ContinuousBatcher.
        warmup_prefill` when ``warmup_engine``), and the worker reports
        ``warming`` to membership — suspend-dispatch, not unhealthy —
        until it finishes.  A failed warmup calls ``on_warmup_error``
        with the exception (the worker CLI exits non-zero there, so a
        worker that cannot launch its kernels fails its spawn); without
        one the worker serves on and captures lazily."""
        self.name = name
        self.host = host
        self.device = resolve_device(device)
        self._q_kwargs = dict(
            framework=framework, model=resolve_model(model, framework),
            custom=custom,
            host=host, port=int(port), batch=batch,
            batch_window_ms=batch_window_ms, max_batch=max_batch,
            scheduler=scheduler, device=self.device)
        self._engine_cfg = engine
        self._decode_port = decode_port
        self._health_port = health_port
        self.drain_timeout_s = float(drain_timeout_s)
        self.query_server: Optional[QueryServer] = None
        self.decode_server = None
        self.engine = None
        self.metrics_server = None
        self.degraded_reason = ""  # tests / operators: deprioritize me
        self._warmup_spec = warmup_spec
        self._warmup_engine = bool(warmup_engine)
        self._on_warmup_error = on_warmup_error
        self._warming = False
        self._warmup_thread: Optional[threading.Thread] = None
        self.warmup_report: Optional[dict] = None
        self._tracer_names = [t.strip() for t in str(tracers or "").split(";")
                              if t.strip()]
        self.scope: Optional[ServeScope] = None
        self._killed = False
        self._draining = False
        self._lock = threading.Lock()
        self.restarts = 0
        # incarnation nonce: regenerated per start(), surfaced on
        # /healthz ("nonce") and the (status, nonce) probe — membership
        # keys breaker/suspect state by it, so a respawned worker never
        # inherits its dead predecessor's failure streak
        self.incarnation = ""

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetWorker":
        self._killed = False
        self._draining = False
        import uuid

        self.incarnation = uuid.uuid4().hex[:12]
        if self._tracer_names:
            if self.scope is None:
                self.scope = ServeScope(f"worker:{self.name}")
            self.scope.attach(self._tracer_names)
        self.query_server = QueryServer(**self._q_kwargs)
        self.query_server.obs_scope = self.scope
        self.query_server.start()
        self._q_kwargs["port"] = self.query_server.port  # pin for restart
        if self._engine_cfg is not None:
            from ..serving import ContinuousBatcher, DecodeServer

            if isinstance(self._engine_cfg, ContinuousBatcher):
                self.engine = self._engine_cfg
            else:
                cfg = dict(self._engine_cfg)
                cfg.setdefault("device", self.device)
                self.engine = ContinuousBatcher(**cfg)
            self.decode_server = DecodeServer(
                self.engine, host=self.host,
                port=int(self._decode_port or 0),
                device=self.engine.device).start()
            self._decode_port = self.decode_server.port
        if self._health_port is not None:
            from ..obs.export import (
                MetricsServer,
                register_degraded,
                register_health,
                register_stats,
                register_warming,
                set_health_nonce,
            )

            # subprocess mode (one worker per process): stamp this
            # incarnation into /healthz so membership keys state by it
            set_health_nonce(self.incarnation)
            self.metrics_server = MetricsServer(
                port=int(self._health_port)).start()
            self._health_port = self.metrics_server.port
            register_health(f"worker:{self.name}", self._health_provider)
            register_degraded(f"worker:{self.name}", lambda:
                              self.degraded_reason)
            register_warming(f"worker:{self.name}", lambda:
                             "capture-ahead warmup" if self._warming else "")
            register_stats(f"worker:{self.name}", self.stats)
        if self._warmup_spec is not None or (
                self.engine is not None and self._warmup_engine):
            # capture-ahead off the serving path: the worker reports
            # "warming" to membership until every bucket's graph is
            # captured, THEN becomes routable
            self._warming = True
            self._warmup_thread = threading.Thread(
                target=self._warm, name=f"warmup:{self.name}", daemon=True)
            self._warmup_thread.start()
        return self

    def _warm(self) -> None:
        report = {}
        failure = None
        try:
            if self._warmup_spec is not None and self.query_server is not None:
                report["query"] = self.query_server.warmup(self._warmup_spec)
            if self.engine is not None and self._warmup_engine:
                report["prefill"] = self.engine.warmup_prefill()
        except Exception as exc:  # noqa: BLE001 — reported below
            import logging

            logging.getLogger("nnstreamer_tpu_torch.fleet").exception(
                "worker %s warmup failed", self.name)
            report["error"] = repr(exc)
            failure = exc
        finally:
            self.warmup_report = report
            if failure is None or self._on_warmup_error is None:
                self._warming = False
        if failure is not None and self._on_warmup_error is not None:
            self._on_warmup_error(failure)

    def _health_provider(self):
        if self._draining:
            return False, "draining"
        return True, ""

    @property
    def query_port(self) -> int:
        return self.query_server.port

    @property
    def decode_port(self) -> Optional[int]:
        return self._decode_port if self.decode_server is not None else None

    @property
    def health_port(self) -> Optional[int]:
        return self._health_port if self.metrics_server is not None else None

    @property
    def trace_addr(self) -> Optional[str]:
        """``host:port`` serving this worker's ``/trace.json`` +
        ``/metrics`` (the collector's federation address); None without
        a metrics server (in-process fleets share one recorder and use a
        single local collector source instead)."""
        if self.metrics_server is None:
            return None
        return f"{self.metrics_server.host}:{self.metrics_server.port}"

    # -- deep profiling ------------------------------------------------------

    def profile(self, seconds: Optional[float] = None,
                frames: Optional[int] = None) -> dict:
        """Capture one deep-profiling window on this worker
        (obs/profiler.py) and return the parsed summary — the in-process
        twin of ``GET /profile`` on :attr:`trace_addr` (the remote path:
        ``obs.collector.fetch_profile(worker.trace_addr, seconds=...)``).
        Raises the profiler's typed ``ProfileBusyError`` when a capture
        already holds the window."""
        from ..obs.profiler import capture_profile

        return capture_profile(seconds=seconds, frames=frames,
                               trigger="fleet")

    # -- membership probe (in-process fleets) --------------------------------

    def probe(self, _info=None) -> str:
        """The :class:`~.membership.Membership` probe contract: a status
        string, raising = unreachable (a killed worker's endpoint)."""
        if self._killed:
            raise ConnectionError(f"{self.name}: killed")
        if self._draining:
            # distinct from unhealthy: membership maps this to DRAINING,
            # which is the stateful router's cue to migrate this
            # worker's live decode sessions off before the drain
            # deadline force-breaks them
            return "draining"
        if self._warming:
            return "warming:capture-ahead warmup"
        if self.degraded_reason:
            return f"degraded:{self.degraded_reason}"
        return "ok"

    def probe_inc(self, _info=None):
        """The incarnation-aware probe: ``(status, nonce)``.  Supervised
        fleets register THIS with membership so a respawned worker's
        fresh nonce resets the dead incarnation's breaker/suspect
        state."""
        return self.probe(_info), self.incarnation

    # -- shutdown paths ------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful removal (the SIGTERM path): both servers drain —
        in-flight work finishes, idle peers get typed goodbyes, live
        decode sessions run to the deadline."""
        timeout = self.drain_timeout_s if timeout is None else float(timeout)
        with self._lock:
            if self._draining:
                return True
            self._draining = True
        warm = self._warmup_thread
        if warm is not None and warm.is_alive():
            # drained while it captures (a scale-down cancelling a joining
            # worker): the capture ends before the servers stop under it,
            # within the same deadline
            t0 = time.monotonic()
            warm.join(timeout)
            timeout = max(0.0, timeout - (time.monotonic() - t0))
        clean = True
        if self.query_server is not None:
            clean = self.query_server.drain(timeout) and clean
        if self.decode_server is not None:
            clean = self.decode_server.drain(timeout) and clean
        if self.engine is not None:
            self.engine.stop()
        self._teardown_obs()
        return clean

    def kill(self) -> None:
        """Chaos ``worker_kill``: abrupt socket teardown, no goodbyes —
        peers see exactly what a SIGKILL would give them."""
        self._killed = True
        if self.query_server is not None:
            self.query_server.kill()
        if self.decode_server is not None:
            self.decode_server.kill()
        if self.engine is not None:
            # the engine thread dies with the "process" (kept from
            # leaking OS threads across a long chaos soak)
            self.engine.stop()
        self._teardown_obs()

    def hang(self, ms: float) -> None:
        """Chaos ``worker_hang``: hold the query server's backend lock
        for ``ms`` so every dispatch wedges (the router's request
        timeout is the intended observer).  Returns immediately."""
        qs = self.query_server
        if qs is None:
            return

        def hold():
            with qs._lock:
                time.sleep(ms / 1e3)

        threading.Thread(target=hold, daemon=True,
                         name=f"hang:{self.name}").start()

    def restart(self) -> "FleetWorker":
        """Churn: bring the worker back on the SAME ports (kill/restart
        cycles must converge through the membership revival path)."""
        self.restarts += 1
        if self._engine_cfg is not None and not isinstance(
                self._engine_cfg, dict):
            # a live engine object died with the kill; rebuild needs a
            # config dict
            raise RuntimeError(
                f"{self.name}: restart needs engine= as a kwargs dict")
        return self.start()

    def stop(self) -> None:
        """Plain teardown (tests): no goodbyes, no crash semantics."""
        self._killed = True
        if self.query_server is not None:
            self.query_server.stop()
        if self.decode_server is not None:
            self.decode_server.stop()
        if self.engine is not None:
            self.engine.stop()
        self._teardown_obs()

    def _teardown_obs(self) -> None:
        if self.metrics_server is not None:
            from ..obs.export import (
                unregister_degraded,
                unregister_health,
                unregister_stats,
                unregister_warming,
            )

            unregister_health(f"worker:{self.name}")
            unregister_degraded(f"worker:{self.name}")
            unregister_warming(f"worker:{self.name}")
            unregister_stats(f"worker:{self.name}")
            self.metrics_server.stop()
            self.metrics_server = None
        if self.scope is not None:
            # the tracers stop with the servers; their data stays readable
            self.scope.detach()

    def __enter__(self) -> "FleetWorker":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stats(self) -> dict:
        out = {
            "name": self.name,
            "draining": self._draining,
            "warming": self._warming,
            "killed": self._killed,
            "restarts": self.restarts,
            "degraded_reason": self.degraded_reason,
            "device": str(self.device),
            "kernels": kernel_launches(),
        }
        if self.query_server is not None:
            out["query"] = self.query_server.stats()
        if self.decode_server is not None:
            out["decode"] = self.decode_server.stats()
        if self.engine is not None:
            out["engine"] = self.engine.stats()
        if self.warmup_report is not None:
            out["warmup"] = self.warmup_report
        try:
            # per-worker view of the cost observatory: each worker's
            # compute-vs-transfer split next to its serving stats
            from ..obs import costmodel as _costmodel

            cm = _costmodel.live_summaries()
            if cm:
                out["cost_model"] = cm
        except Exception:  # noqa: BLE001 — stats must never fail a scrape
            pass
        return out
