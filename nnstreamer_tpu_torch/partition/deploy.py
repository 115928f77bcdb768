"""Materialize a :class:`~nnstreamer_tpu_torch.partition.planner.PartitionPlan`.

The port's copy of the JAX package's ``partition/deploy.py``.  The client
fragment stays local; the server fragment becomes a
:class:`~nnstreamer_tpu_torch.fleet.worker.FleetWorker` running the
``fragment`` backend (``partition/fragment.py``), in this process or, with
:class:`SubprocFragmentWorker` as the factory, in a worker process of its
own.  That buys the fleet's lifecycle: the worker is **warming-gated**
(deploy waits for its probe to report ``ok``, after its capture-ahead
warmup, before any client traffic), and a re-deploy retires the old worker
through the fleet's **migrate-first drain** (in-flight requests finish,
idle peers get typed ``[UNAVAILABLE]`` goodbyes), never a torn connection.

The split edge is a first-class wire: :func:`probe_edge_health` measures
its put rate with real NNSQ round trips, publishes under the edge's
``host:port`` address label, and registers the prober with ``obs/util.py``
so the serving watchdog re-probes it on its wire cadence: regime flips on
the edge reach the repartition monitor without polling.

Entry points run on the card: the in-process worker and the worker
process take ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..elements.query import PROBE_PTS, recv_tensors, send_tensors
from ..graph.parse import split_launch
from ..obs import util as _util
from ..spec import TensorsSpec
from .planner import PartitionPlan

_PROBE_NBYTES = 150_528


def probe_edge_health(host: str, port: int, spec: TensorsSpec,
                      n: int = 4, connect_timeout: float = 5.0) -> dict:
    """Measure one partition edge with real NNSQ negotiation probes.

    Sends ``n + 1`` plain ``PROBE_PTS`` zero-frames of ``spec`` and times
    the round trips (the first, which may build the server's backend for
    this spec, is discarded).  Returns the ``probe_wire_health`` shape:
    ``put_150k_ms`` is the best round trip normalized to the 150 KB
    reference payload when the probe payload exceeds it (bandwidth-bound:
    scaling down is sound); smaller payloads report the raw round trip
    (latency dominates there, and extrapolating a 48-byte round trip to
    150 KB would brand every low-latency edge "slow").  ``dispatch_ms`` is
    the best raw round trip."""
    zeros = tuple(np.zeros(t.shape, t.dtype) for t in spec.tensors)
    nbytes = max(1, sum(z.nbytes for z in zeros))
    times = []
    with socket.create_connection((host, int(port)),
                                  timeout=connect_timeout) as sock:
        for i in range(int(n) + 1):
            t0 = time.perf_counter()
            send_tensors(sock, zeros, PROBE_PTS)
            recv_tensors(sock)
            dt_ms = (time.perf_counter() - t0) * 1e3
            if i:  # the first probe pays the backend's build, not the wire's cost
                times.append(dt_ms)
    best = min(times)
    scale = (_PROBE_NBYTES / nbytes) if nbytes >= _PROBE_NBYTES else 1.0
    return {
        "put_150k_ms": round(best * scale, 3),
        "dispatch_ms": round(best, 3),
    }


class SubprocFragmentWorker:
    """A server fragment in a worker process of its own:
    ``python -m nnstreamer_tpu_torch.fleet worker --framework fragment``.

    The same surface :class:`PartitionDeployment` drives on an in-process
    :class:`~nnstreamer_tpu_torch.fleet.worker.FleetWorker`: ``start``,
    ``probe`` (the worker's ``/healthz``, read as membership reads it),
    ``drain`` (SIGTERM: the worker's own drain, then its exit) and ``stop``.
    ``warmup_spec`` (``"uint8:224x224x3"``, one request row) makes the worker
    capture ahead and report ``warming`` until done; ``stderr`` is where its
    standard error goes.  ``stats()`` reads the worker's ``/stats.json``
    section (``kernels``: its process's kernel launches)."""

    def __init__(self, name: str, host: str, port: int, server_desc: str, *,
                 device: str = "cuda", warmup_spec: str = "", env: Optional[dict] = None,
                 stderr=subprocess.DEVNULL, line_timeout_s: float = 120.0,
                 exit_timeout_s: float = 60.0):
        self.name = name
        self.host = host
        self._port = int(port)
        self.server_desc = server_desc
        self.device = device
        self.warmup_spec = warmup_spec
        self.env = env
        self.stderr = stderr
        self.line_timeout_s = float(line_timeout_s)
        self.exit_timeout_s = float(exit_timeout_s)
        self.handle = None
        self.returncode: Optional[int] = None

    def start(self) -> "SubprocFragmentWorker":
        from ..fleet.supervisor import SubprocWorkerFactory

        args = ["--host", self.host, "--framework", "fragment", "--model", self.server_desc]
        if self.warmup_spec:
            args += ["--warmup-spec", self.warmup_spec]
        factory = SubprocWorkerFactory(args, env=self.env, device=self.device,
                                       line_timeout_s=self.line_timeout_s,
                                       stderr=self.stderr)
        self.handle = factory.spawn(self.name)
        return self

    @property
    def query_port(self) -> int:
        return int(self.handle.info["port"])

    @property
    def health_addr(self) -> str:
        return self.handle.ports["health_addr"]

    @property
    def pid(self) -> int:
        return self.handle.pid

    def probe(self, _info=None) -> str:
        """The worker's ``/healthz`` status (``ok``, ``warming:...``,
        ``draining``); raises when the process is gone."""
        from ..fleet.membership import WorkerInfo, _http_probe

        if not self.handle.alive():
            raise ConnectionError(f"{self.name}: worker process exited "
                                  f"({self.handle.proc.poll()})")
        info = WorkerInfo(self.name, self.host, self.query_port,
                          health_addr=self.health_addr)
        status, _ = _http_probe(info, 5.0)
        return status

    def stats(self) -> dict:
        from ..obs.collector import http_get_json

        return http_get_json(f"http://{self.health_addr}/stats.json",
                             30)[f"worker:{self.name}"]

    def drain(self) -> bool:
        """SIGTERM: the worker drains (in-flight requests finish, idle peers
        get goodbyes) and exits.  True when it exited within
        ``exit_timeout_s``; else it is killed."""
        proc = self.handle.proc
        if proc.poll() is None:
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        try:
            self.returncode = proc.wait(timeout=self.exit_timeout_s)
            return True
        except subprocess.TimeoutExpired:
            proc.kill()
            self.returncode = proc.wait(timeout=10)
            return False

    def stop(self) -> None:
        if self.handle is None:
            return
        proc = self.handle.proc
        if proc.poll() is None:
            proc.kill()
        self.returncode = proc.wait(timeout=10)


def subproc_worker_factory(device: str = "cuda", warmup_spec: str = "",
                           env: Optional[dict] = None, **kwargs) -> Callable:
    """A :class:`PartitionDeployment` ``worker_factory`` that puts each
    server fragment in a :class:`SubprocFragmentWorker`.  ``env`` defaults
    to this process's, with the checkout on ``PYTHONPATH``."""
    if env is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")

    def factory(name: str, host: str, port: int, server_desc: str):
        return SubprocFragmentWorker(name, host, port, server_desc, device=device,
                                     warmup_spec=warmup_spec, env=dict(env), **kwargs)

    return factory


class PartitionDeployment:
    """One live placement: the plan, its server worker, its edge.

    ``deploy = PartitionDeployment(plan).start()`` brings up the server
    fragment (warming-gated) and ``deploy.client_launch()`` is the launch
    string to run locally, the split edge pre-wired with ``caps=true
    require_caps=true edge=<edge>`` so the remote fragment negotiates
    formats over the wire and every round trip is hop-attributable.  An
    all-local plan deploys trivially: no worker, ``client_launch()`` is the
    original description.  ``device`` is the in-process worker's (the
    default factory)."""

    def __init__(self, plan: PartitionPlan, *,
                 host: str = "127.0.0.1", port: int = 0,
                 worker_name: Optional[str] = None,
                 warm_timeout_s: Optional[float] = None,
                 client_props: Optional[Dict[str, str]] = None,
                 worker_factory: Optional[Callable] = None,
                 device="cuda"):
        from ..conf import conf

        self.plan = plan
        self.host = host
        self._port = int(port)
        self._worker_name = worker_name or f"partition:{plan.edge}"
        self.warm_timeout_s = (
            float(warm_timeout_s) if warm_timeout_s is not None
            else conf.get_float("partition", "warm_timeout_s", 30.0))
        self._client_props = dict(client_props or {})
        self._worker_factory = worker_factory or self._default_factory
        self.device = device
        self.worker = None
        self.redeploys = 0          # observability: monitor-driven swaps
        self._probe_spec: Optional[TensorsSpec] = None

    def _default_factory(self, name: str, host: str, port: int, server_desc: str):
        from ..fleet.worker import FleetWorker

        return FleetWorker(name=name, host=host, port=port,
                           framework="fragment", model=server_desc, device=self.device)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "PartitionDeployment":
        if self.plan.split:
            self.worker = self._spawn(self.plan)
        return self

    def _spawn(self, plan: PartitionPlan):
        _, server_desc = split_launch(plan.description, plan.cut)
        worker = self._worker_factory(
            self._worker_name, self.host, self._port, server_desc)
        worker.start()
        deadline = time.monotonic() + self.warm_timeout_s
        while True:
            status = worker.probe()
            if status == "ok":
                return worker
            if time.monotonic() > deadline:
                worker.stop()
                raise TimeoutError(
                    f"server fragment worker {worker.name} not servable "
                    f"within {self.warm_timeout_s}s (last: {status})")
            time.sleep(0.02)

    @property
    def addr(self) -> Optional[str]:
        """The live edge's ``host:port`` (the wire-health label), or None
        for an all-local deployment."""
        if self.worker is None:
            return None
        return f"{self.worker.host}:{self.worker.query_port}"

    def client_launch(self) -> str:
        """The launch string to run locally under this deployment."""
        if not self.plan.split:
            return self.plan.description
        props = {
            "name": f"qc_{self.plan.edge}",
            "host": self.worker.host,
            "port": str(self.worker.query_port),
            "caps": "true",
            "require_caps": "true",
            "edge": self.plan.edge,
        }
        props.update(self._client_props)
        client_desc, _ = split_launch(self.plan.description,
                                      self.plan.cut, client_props=props)
        return client_desc

    # -- edge health ---------------------------------------------------------

    def register_edge(self, probe_spec: TensorsSpec,
                      n: Optional[int] = None,
                      registry=None) -> Optional[dict]:
        """Probe the live edge once, publish under its address, and register
        the prober for the watchdog's re-probe walk.  Needs the cut
        boundary's input spec (what the client fragment feeds the wire)."""
        if self.worker is None:
            return None
        from ..conf import conf

        n = int(n) if n is not None else int(
            conf.get_float("partition", "probe_n", 4))
        self._probe_spec = probe_spec
        addr = self.addr
        host, port = self.worker.host, self.worker.query_port

        def prober() -> dict:
            return probe_edge_health(host, port, probe_spec, n=n)

        health = prober()
        _util.register_wire_edge(addr, prober)
        return _util.publish_wire_health(health, registry, addr=addr)

    def _unregister_edge(self) -> None:
        addr = self.addr
        if addr is not None:
            _util.unregister_wire_edge(addr)

    # -- repartitioning ------------------------------------------------------

    def redeploy(self, plan: PartitionPlan, registry=None) -> None:
        """Swap to ``plan`` make-before-break: the new server fragment comes
        up and proves servable (the warming gate) while the old one still
        serves; only then does the old worker leave through the
        migrate-first drain."""
        old_worker = self.worker
        self._unregister_edge()
        new_worker = self._spawn(plan) if plan.split else None
        self.plan = plan
        self.worker = new_worker
        if new_worker is not None and self._probe_spec is not None:
            self.register_edge(self._probe_spec, registry=registry)
        if old_worker is not None:
            old_worker.drain()
            old_worker.stop()
        self.redeploys += 1

    def stop(self, drain: bool = True) -> None:
        self._unregister_edge()
        if self.worker is not None:
            if drain:
                self.worker.drain()
            self.worker.stop()
            self.worker = None


__all__ = ["PartitionDeployment", "SubprocFragmentWorker", "probe_edge_health",
           "subproc_worker_factory"]
