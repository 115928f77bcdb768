"""``python -m nnstreamer_tpu_torch.fleet worker|router|repo|autoscale``.

The port of the JAX package's fleet CLI.  Every role runs on the card
unless ``--device cpu`` asks for the host (the JAX package's
``--platform`` is not copied: the port has one device switch).

Worker (one per card or host)::

    python -m nnstreamer_tpu_torch.fleet worker --port 0 --health-port 0 \\
        --framework fragment --model "tensor_transform ... ! tensor_filter \\
framework=torch ..." --warmup-spec uint8:224x224x3 [--tracers device;costmodel]
    python -m nnstreamer_tpu_torch.fleet worker --device cpu --model x2 \\
        [--decode capacity=4,t_max=32,d_in=4,n_out=4,d_model=16,\\
n_heads=2,n_layers=1 --decode-port 0]

Router (the front door)::

    python -m nnstreamer_tpu_torch.fleet router --port 0 \\
        --workers 127.0.0.1:7001/9001,127.0.0.1:7002/9002 [--stateful] \\
        [--repo 127.0.0.1:9500]

Repo (a shared TensorRepoServer — cross-process recurrence slots AND
the channel live session migration snapshots cross)::

    python -m nnstreamer_tpu_torch.fleet repo --port 0

Autoscale (router(s) + supervisor + autoscaler in one process, worker
subprocesses spawned and drained to track the SLO — ``[autoscale]`` conf
knobs / ``NNSTPU_AUTOSCALE_*``)::

    python -m nnstreamer_tpu_torch.fleet autoscale --device cpu --port 0 \\
        --health-port 0 --model x2 --min-workers 1 --max-workers 3 \\
        --worker-rps 40

Each process prints ONE JSON line describing its bound ports (a
supervisor parses it), then serves until signalled:

- ``SIGTERM`` → graceful drain: in-flight dispatches finish, idle
  connections get typed ``[UNAVAILABLE]`` goodbyes, live decode
  sessions run to the drain deadline — then exit 0;
- ``SIGINT``  → plain stop.

A worker on the card loads the port's kernel libraries before it serves
(``ops/build.py`` builds one that is missing); one that cannot load them,
or whose warmup capture fails, exits non-zero, so its spawn fails.

Worker specs for ``--workers`` are ``host:query_port[/health_port]``;
the health port feeds membership's ``/healthz`` heartbeats.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time


def _parse_kv_ints(spec: str) -> dict:
    out = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = int(v)
    return out


def _serve_until_signal(drain, stop) -> int:
    """Park the main thread; SIGTERM drains, SIGINT stops."""
    done = threading.Event()

    def on_term(signum, frame):
        del signum, frame
        threading.Thread(target=lambda: (drain(), done.set()),
                         daemon=True).start()

    def on_int(signum, frame):
        del signum, frame
        threading.Thread(target=lambda: (stop(), done.set()),
                         daemon=True).start()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_int)
    # wake now and then: a signal taken by another thread only sets a flag
    # that this thread's next bytecode reads, so an endless wait here could
    # leave the handler unrun
    while not done.wait(0.5):
        pass
    return 0


def _enable_spans(name: str) -> None:
    """Span recording + process naming for subprocess roles: the worker/
    router records ``nnsq_serve``/``nnsq_route``/``device_*`` spans that
    the cluster trace collector federates from ``/trace.json``."""
    from ..obs import collector, spans

    spans.enable(spans.configured_flight_records())
    collector.set_process_name(name)


def _use_device(device: str) -> None:
    """Resolve ``--device`` (raises with no GPU unless it is ``cpu``) and
    make it where models named in launch strings load."""
    from ..device import resolve_device

    resolve_device(device)
    os.environ["NNSTPU_FILTER_TORCH_DEVICE"] = device


def _load_kernels() -> None:
    """Load every kernel library of the port (built by the parent, or
    here on first use): a worker that cannot load one must not serve."""
    from ..ops import build

    for name in build.SOURCES:
        build.load(name)


def _warmup_failed(exc: BaseException) -> None:
    print(f"fleet worker: warmup failed, exiting: {exc!r}", file=sys.stderr,
          flush=True)
    os._exit(3)


def _cmd_worker(args) -> int:
    from .worker import FleetWorker

    _use_device(args.device)
    if args.device != "cpu":
        _load_kernels()
    if args.spans:
        _enable_spans(args.name)
    engine = None
    if args.decode:
        engine = _parse_kv_ints(args.decode)
    warmup_spec = None
    if args.warmup_spec:
        # "float32:4" / "uint8:224x224x3" — the spec of ONE request row;
        # the worker captures the whole sub-dispatch bucket ladder around
        # it and reports "warming" to membership until done
        import numpy as np

        from ..spec import TensorSpec, TensorsSpec

        dt, _, dims = args.warmup_spec.partition(":")
        shape = tuple(int(d) for d in dims.split("x") if d)
        warmup_spec = TensorsSpec.of(
            TensorSpec(dtype=np.dtype(dt), shape=shape))
    worker = FleetWorker(
        name=args.name, host=args.host, port=args.port,
        framework=args.framework, model=args.model, custom=args.custom,
        batch=args.batch, max_batch=args.max_batch, engine=engine,
        decode_port=args.decode_port if engine else None,
        health_port=args.health_port,
        drain_timeout_s=args.drain_timeout,
        warmup_spec=warmup_spec,
        warmup_engine=args.warmup_engine,
        device=args.device, tracers=args.tracers,
        on_warmup_error=_warmup_failed).start()
    # the ports line is the spawn contract: every port may be requested
    # ephemeral (0) and the CHOSEN ports are reported here — a
    # supervisor-spawned worker never collides with a draining
    # predecessor's still-releasing port, because it never asks for a
    # fixed one.  trace_addr feeds the cluster trace collector; nonce is
    # the incarnation witness membership keys per-worker state by.
    print(json.dumps({
        "role": "worker", "name": worker.name, "pid": os.getpid(),
        "port": worker.query_port, "decode_port": worker.decode_port,
        "health_port": worker.health_port,
        "trace_addr": worker.trace_addr,
        "nonce": worker.incarnation,
        "device": str(worker.device),
    }), flush=True)

    def drain():
        import faulthandler

        t0 = time.monotonic()
        print(f"fleet worker {worker.name}: draining", file=sys.stderr, flush=True)
        # a drain still running after drain_timeout plus 20 s has hung: every
        # thread's stack goes to standard error
        faulthandler.dump_traceback_later(args.drain_timeout + 20.0, exit=False)
        clean = worker.drain()
        faulthandler.cancel_dump_traceback_later()
        print(f"fleet worker {worker.name}: drained in {time.monotonic() - t0:.3f} s "
              f"({'clean' if clean else 'deadline reached'})", file=sys.stderr, flush=True)

    return _serve_until_signal(drain, worker.stop)


def _cmd_router(args) -> int:
    from .membership import Membership
    from .router import Router

    if args.spans:
        _enable_spans(args.name)
    membership = Membership()
    for spec in args.workers.split(","):
        spec = spec.strip()
        if not spec:
            continue
        addr, _, health = spec.partition("/")
        host, _, port = addr.rpartition(":")
        membership.add(host or "127.0.0.1", int(port),
                       health_addr=f"{host or '127.0.0.1'}:{health}"
                       if health else None)
    membership.start()
    router = Router(membership, host=args.host, port=args.port,
                    stateful=args.stateful, name=args.name,
                    repo_addr=args.repo or None).start()
    health_port = None
    metrics = None
    if args.health_port is not None:
        from ..obs.export import MetricsServer

        metrics = MetricsServer(port=args.health_port).start()
        health_port = metrics.port
    print(json.dumps({
        "role": "router", "name": router.name, "pid": os.getpid(),
        "port": router.port, "stateful": router.stateful,
        "health_port": health_port,
        "workers": [w.id for w in membership.workers()],
    }), flush=True)

    def stop():
        router.stop()
        membership.stop()
        if metrics is not None:
            metrics.stop()

    return _serve_until_signal(stop, stop)


def _cmd_autoscale(args) -> int:
    """The self-scaling fleet-in-a-box: router(s) + supervisor +
    autoscaler in THIS process, workers spawned as subprocesses with
    every port ephemeral.  SIGTERM drains the whole fleet."""
    from ..obs.export import MetricsServer
    from .autoscaler import Autoscaler, RouterSignals
    from .membership import Membership
    from .router import Router
    from .supervisor import SubprocWorkerFactory, Supervisor, Surface

    if args.spans:
        _enable_spans(args.name)
    worker_args = ["--model", args.model, "--framework", args.framework]
    if args.custom:
        worker_args += ["--custom", args.custom]
    if args.batch:
        worker_args += ["--batch", str(args.batch)]
    worker_args += ["--max-batch", str(args.max_batch)]
    if args.decode:
        worker_args += ["--decode", args.decode]
    if args.warmup_spec:
        worker_args += ["--warmup-spec", args.warmup_spec]
    if args.warmup_engine:
        worker_args += ["--warmup-engine"]
    if args.spans:
        worker_args += ["--spans"]
    factory = SubprocWorkerFactory(worker_args, device=args.device)

    membership = Membership().start()
    router = Router(membership, host=args.host, port=args.port,
                    name=args.name).start()
    surfaces = [Surface(membership, router, port_key="port", name="query")]
    repo_srv = None
    dmembership = drouter = None
    if args.decode:
        repo_addr = args.repo
        if not repo_addr:
            # self-host the migration snapshot channel so a scale-down
            # drain can live-migrate sessions without extra processes
            from .repo import TensorRepoServer

            repo_srv = TensorRepoServer(host=args.host, port=0,
                                        device=args.device).start()
            repo_addr = f"{args.host}:{repo_srv.port}"
        dmembership = Membership().start()
        drouter = Router(dmembership, host=args.host,
                         port=args.decode_router_port, stateful=True,
                         name=f"{args.name}-decode",
                         repo_addr=repo_addr).start()
        surfaces.append(Surface(dmembership, drouter,
                                port_key="decode_port", name="decode"))
    supervisor = Supervisor(factory, surfaces, name=args.name)
    autoscaler = Autoscaler(
        supervisor, RouterSignals(router, membership), name=args.name,
        min_workers=args.min_workers, max_workers=args.max_workers,
        worker_rps=args.worker_rps if args.worker_rps else None)
    for _ in range(autoscaler.min_workers):
        supervisor.spawn_worker(detail="initial fleet floor")
    autoscaler.start()
    metrics = None
    health_port = None
    if args.health_port is not None:
        metrics = MetricsServer(port=args.health_port).start()
        health_port = metrics.port
    print(json.dumps({
        "role": "autoscale", "name": args.name, "pid": os.getpid(),
        "port": router.port,
        "decode_port": drouter.port if drouter is not None else None,
        "repo_port": repo_srv.port if repo_srv is not None else None,
        "health_port": health_port,
        "min_workers": autoscaler.min_workers,
        "max_workers": autoscaler.max_workers,
    }), flush=True)

    def teardown(drain):
        autoscaler.stop()
        supervisor.stop(drain=drain)
        for r in (router, drouter):
            if r is not None:
                r.stop()
        for m in (membership, dmembership):
            if m is not None:
                m.stop()
        if repo_srv is not None:
            repo_srv.stop()
        if metrics is not None:
            metrics.stop()

    return _serve_until_signal(lambda: teardown(True),
                               lambda: teardown(False))


def _cmd_repo(args) -> int:
    from .repo import TensorRepoServer

    srv = TensorRepoServer(host=args.host, port=args.port,
                           device=args.device).start()
    print(json.dumps({
        "role": "repo", "name": args.name, "pid": os.getpid(),
        "port": srv.port,
    }), flush=True)
    return _serve_until_signal(srv.stop, srv.stop)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nnstreamer_tpu_torch.fleet", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="role", required=True)

    w = sub.add_parser("worker", help="one QueryServer/DecodeServer process")
    w.add_argument("--name", default=f"worker-{os.getpid()}")
    w.add_argument("--host", default="127.0.0.1")
    w.add_argument("--port", type=int, default=0)
    w.add_argument("--health-port", type=int, default=0)
    w.add_argument("--framework", default="custom")
    w.add_argument("--model", default="x2",
                   help="builtin model name (custom framework), a launch "
                        "string (fragment) or a model file")
    w.add_argument("--custom", default="")
    w.add_argument("--batch", type=int, default=0)
    w.add_argument("--max-batch", type=int, default=64)
    w.add_argument("--decode", default="",
                   help="ContinuousBatcher kwargs 'capacity=4,t_max=32,...' "
                        "— turns on the stateful DecodeServer surface")
    w.add_argument("--decode-port", type=int, default=0)
    w.add_argument("--drain-timeout", type=float, default=10.0)
    w.add_argument("--warmup-spec", default="", metavar="DTYPE:DIMS",
                   help="capture ahead for one request-row spec, e.g. "
                        "'float32:4' or 'uint8:224x224x3' — the worker "
                        "captures its sub-dispatch bucket ladder before "
                        "reporting ready to membership")
    w.add_argument("--warmup-engine", action="store_true",
                   help="also capture the decode engine's prefill length "
                        "buckets during warmup")
    w.add_argument("--tracers", default="", metavar="NAMES",
                   help="tracers on the worker's serving scope, e.g. "
                        "'device;costmodel'")
    w.set_defaults(fn=_cmd_worker)

    r = sub.add_parser("router", help="the NNSQ fleet front door")
    r.add_argument("--name", default="router")
    r.add_argument("--host", default="127.0.0.1")
    r.add_argument("--port", type=int, default=0)
    r.add_argument("--health-port", type=int, default=None)
    r.add_argument("--workers", required=True,
                   help="host:query_port[/health_port],...")
    r.add_argument("--stateful", action="store_true",
                   help="front a DecodeServer fleet (sticky sessions)")
    r.add_argument("--repo", default="",
                   help="host:port of a TensorRepoServer — enables live "
                        "decode-session migration on planned drains")
    r.set_defaults(fn=_cmd_router)

    p = sub.add_parser("repo", help="a shared TensorRepoServer process")
    p.add_argument("--name", default="repo")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.set_defaults(fn=_cmd_repo)

    a = sub.add_parser(
        "autoscale",
        help="self-scaling fleet: router(s) + supervisor + autoscaler, "
             "workers spawned as subprocesses on ephemeral ports")
    a.add_argument("--name", default="autoscale")
    a.add_argument("--host", default="127.0.0.1")
    a.add_argument("--port", type=int, default=0,
                   help="the stateless (query) router port")
    a.add_argument("--decode-router-port", type=int, default=0,
                   help="the stateful decode router port (with --decode)")
    a.add_argument("--health-port", type=int, default=0)
    a.add_argument("--min-workers", type=int, default=None,
                   help="fleet floor (default [autoscale] min_workers)")
    a.add_argument("--max-workers", type=int, default=None,
                   help="fleet ceiling (default [autoscale] max_workers)")
    a.add_argument("--worker-rps", type=float, default=0.0,
                   help="per-worker capacity estimate feeding the "
                        "predictive leg (0 = [autoscale] worker_rps)")
    a.add_argument("--framework", default="custom")
    a.add_argument("--model", default="x2")
    a.add_argument("--custom", default="")
    a.add_argument("--batch", type=int, default=0)
    a.add_argument("--max-batch", type=int, default=64)
    a.add_argument("--decode", default="",
                   help="ContinuousBatcher kwargs for the workers — also "
                        "starts the stateful decode router surface")
    a.add_argument("--repo", default="",
                   help="host:port of a TensorRepoServer for migrate-first "
                        "drains ('' with --decode = self-host one)")
    a.add_argument("--warmup-spec", default="", metavar="DTYPE:DIMS")
    a.add_argument("--warmup-engine", action="store_true")
    a.set_defaults(fn=_cmd_autoscale)

    for sp in (w, r, p, a):
        sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the role computes: the card (default) "
                             "or the host")
        sp.add_argument("--spans", action="store_true",
                        help="record flight-recorder spans and serve them "
                             "at /trace.json for the cluster trace "
                             "collector (names this process in the merged "
                             "Perfetto timeline)")

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
