"""Pipeline: node container, spec negotiation and the streaming scheduler.

The port's copy of the JAX package's ``graph/pipeline.py``, cut to its
core: :meth:`Pipeline.add` / :meth:`Pipeline.link` build the graph,
:meth:`Pipeline.start` folds transforms into filters
(``graph/optimize.py``, unless ``auto_fuse`` is off) and, with segment
compilation on, whole regions (``graph/segments.py``), then opens every
node, runs the two-phase topological negotiation and starts one streaming
thread per source.  EOS from every leaf ends the run; an exception in a
node's chain posts an error and halts the graph.  A failed start undoes
both folds; :meth:`Pipeline.stop` undoes the segment folds, so the next
start plans the user's graph again (transform fusion stays, as in the JAX
package).

Negotiation captures each filter's geometry on the card
(``backends/torch_backend.py``), so every capture happens before PLAYING,
while no source or queue thread issues CUDA work.  Nodes with threads of
their own (``queue``) start them through ``spawn_threads()`` before the
sources start, and ``stop`` interrupts and joins them.

Observability (``obs/``): tracers named by ``[common] tracers``
(``NNSTPU_TRACERS=latency;stats``) or attached with :meth:`attach_tracer`
connect to the hook bus at each start, before negotiation, and detach at
stop; :meth:`stats` reads them back with the profiled invoke times, and
each start registers it in the scrape endpoint's ``/stats.json``
(``[common] metrics_port`` starts the endpoint).  The pipeline emits
``source_spawn``, ``source_push``, ``state_change`` and ``error``.
:meth:`to_dot` renders the graph with its negotiated specs; ``[common]
dump_dot_dir`` writes it on every state change and on an error, and
``[obs] flight_dump_dir`` the span recorder as a Chrome trace on an
error.  Observability never takes the pipeline down: its failures are
warnings.

With ``[compile] warmup`` on, :meth:`Pipeline.start` runs the warmup
phase after negotiation (``graph/warmup.py``): every geometry a node plans
(``tensor_dynbatch``'s buckets) is captured before PLAYING, and
:attr:`Pipeline.warmup_report` says what was captured and how long it
took; :meth:`Pipeline.warmup` runs the phase on a started pipeline.

Supervised recovery: a node's restart policy (:meth:`Pipeline.set_restart_policy`,
or ``[recovery] policy`` for every node) decides what a fault in its
``process`` does.  ``restart`` drops the frame and runs the node's
``stop()`` and ``start()`` and its commit phase again, on the thread that
met the fault (a filter closes and reopens its backend, which drops its
CUDA graphs and captures again while the pipeline plays), with capped
exponential backoff and a storm budget; ``quarantine-passthrough``
sidelines the node; ``fail-pipeline`` (the default) halts the graph.  A
source whose ``frames()`` raises restarts under ``restart``.  A capture
that fails while a node negotiates at start (``compile_raise``) goes to
the node's ``restart`` policy too: the node restarts and negotiates again,
and no frame is ever served from the CPU instead.
:meth:`Pipeline.restart_source` and :meth:`Pipeline.recover_queue` are the
escalations a watchdog calls; :meth:`Pipeline.recovery_stats` (also
``stats()["recovery"]``) is the ledger: actions, frames shed per node,
quarantined nodes.  ``[faults] spec`` (``NNSTPU_FAULTS``) installs the
chaos engine at start (``faults/``).  An error's flight dump carries the
card's memory (``obs/device.py``) and the captured graphs' memory ledger
(``obs/profiler.py`` :func:`~..obs.profiler.hbm_ledger`) as its
``otherData``.  ``[common] xplane_trace_dir`` traces the whole PLAYING
interval with ``torch.profiler`` (the key keeps the JAX package's name;
the trace is Kineto JSON), started at PLAYING and written at stop through
the deep-profiling lane (:func:`~..obs.profiler.start_whole_run`).  The
warmup phase's report carries the memory check of the captured graphs
against the card (``report["hbm"]``, advisory).

Scheduling substrate: with ``[dispatch] lanes`` > 0 (``NNSTPU_DISPATCH_LANES``)
the start hands every queue and ``tensor_dynbatch`` (nodes with
``lane_task``) and every source to a :class:`~.lanes.LaneRuntime` instead of
a thread of its own; ``stats()["lanes"]`` reads it, ``stop`` ends it, and
:meth:`Pipeline.restart_source`, :meth:`Pipeline.source_alive` and
:meth:`Pipeline.recover_queue` act on its tasks.  ``lanes = 0`` (the
default) keeps a thread an element.
"""

from __future__ import annotations

import threading
import time
import traceback
import warnings
from typing import Dict, List, Optional, Union

from ..buffer import Event
from ..obs import hooks as _hooks
from .node import NegotiationError, Node, Pad, SourceNode


class PipelineError(Exception):
    pass


RESTART_MODES = ("restart", "quarantine-passthrough", "fail-pipeline")


class RestartPolicy:
    """Per-node supervision policy (an element error is always fatal in
    GStreamer; a streaming system that must play through flaky sources needs
    supervision, Erlang-style):

    - ``restart``: stop()+start() the faulting node, drop the offending
      frame, and keep streaming, with capped exponential backoff and a
      restart-storm budget (``max_restarts`` within ``window_s``; a spent
      budget escalates to pipeline failure).
    - ``quarantine-passthrough``: sideline the node: later frames bypass its
      ``process()``, passing through unchanged when the in and out specs
      line up, shed otherwise, both counted.
    - ``fail-pipeline``: the error halts the graph (the default).
    """

    __slots__ = ("mode", "max_restarts", "window_s", "backoff_ms", "backoff_cap_ms")

    def __init__(self, mode: str = "restart", max_restarts: int = 5,
                 window_s: float = 30.0, backoff_ms: float = 50.0,
                 backoff_cap_ms: float = 2000.0):
        if mode not in RESTART_MODES:
            raise ValueError(f"unknown restart policy {mode!r} (known: {RESTART_MODES})")
        self.mode = mode
        self.max_restarts = int(max_restarts)
        self.window_s = float(window_s)
        self.backoff_ms = float(backoff_ms)
        self.backoff_cap_ms = float(backoff_cap_ms)

    @classmethod
    def from_conf(cls) -> Optional["RestartPolicy"]:
        """The conf'd default policy (``[recovery] policy`` /
        ``NNSTPU_RECOVERY_POLICY``); None means fail-pipeline."""
        from ..conf import conf

        mode = (conf.get("recovery", "policy", "") or "").strip()
        if not mode or mode == "fail-pipeline":
            return None
        return cls(
            mode,
            max_restarts=conf.get_int("recovery", "max_restarts", 5),
            window_s=conf.get_float("recovery", "window_s", 30.0),
            backoff_ms=conf.get_float("recovery", "backoff_ms", 50.0),
            backoff_cap_ms=conf.get_float("recovery", "backoff_cap_ms", 2000.0),
        )


class Pipeline:
    def __init__(self, name: str = "pipeline"):
        self.name = name
        self.nodes: Dict[str, Node] = {}
        self.auto_fuse = True  # fold transforms into torch filters on start
        # whole-segment compilation (graph/segments.py): None defers to
        # [segment] enabled; True/False pins it for this pipeline
        self.segment_compile: Optional[bool] = None
        self._segment_undos: List = []
        self.state = "NULL"  # NULL → PLAYING → STOPPED (or ERROR)
        self.threads: List[threading.Thread] = []
        self._eos_leaves: set = set()
        self._leaves: set = set()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._error_node: Optional[str] = None
        self._lock = threading.Lock()
        self._tracers: List = []  # attached obs tracers (GST_TRACERS analog)
        self.warmup_report: Optional[dict] = None  # the last warmup phase's report
        self._xplane_tracing = False  # a whole-run trace ([common] xplane_trace_dir) runs
        # supervised recovery: restart policies and their ledger
        self._restart_policies: Dict[str, RestartPolicy] = {}
        self._conf_policy: Optional[RestartPolicy] = None
        self._recovery_lock = threading.Lock()
        self._restart_log: Dict[str, List[float]] = {}  # node -> restart times
        self._recovery_counts: Dict[str, int] = {}      # action -> count
        self._shed_frames: Dict[str, int] = {}          # node -> frames shed
        # the dispatcher lanes (graph/lanes.py); None: a thread an element
        # ([dispatch] lanes = 0)
        self._lanes = None

    # -- graph construction -------------------------------------------------

    def add(self, *nodes: Node) -> Union[Node, tuple]:
        for node in nodes:
            if node.name in self.nodes:
                raise ValueError(f"duplicate node name {node.name!r}")
            self.nodes[node.name] = node
            node.pipeline = self
        return nodes[0] if len(nodes) == 1 else nodes

    def __getitem__(self, name: str) -> Node:
        return self.nodes[name]

    def get_by_name(self, name: str) -> Node:
        """``gst_bin_get_by_name``."""
        return self.nodes[name]

    def _resolve(self, ref: Union[Node, str]):
        """Resolve 'node' or 'node.pad' references."""
        if isinstance(ref, Node):
            return ref, None
        if "." in ref:
            node_name, _, pad_name = ref.partition(".")
            return self.nodes[node_name], pad_name
        return self.nodes[ref], None

    def link(self, src: Union[Node, str], dst: Union[Node, str]) -> None:
        """Link src's src pad to dst's sink pad; 'name.pad' selects pads."""
        src_node, src_pad = self._resolve(src)
        dst_node, dst_pad = self._resolve(dst)
        src_node.get_src_pad(src_pad).link(dst_node.get_sink_pad(dst_pad))

    def link_chain(self, *nodes: Union[Node, str]) -> None:
        for a, b in zip(nodes, nodes[1:]):
            self.link(a, b)

    # -- supervised recovery ------------------------------------------------

    def set_restart_policy(self, node: Union[Node, str] = "*", mode: str = "restart",
                           max_restarts: int = 5, window_s: float = 30.0,
                           backoff_ms: float = 50.0,
                           backoff_cap_ms: float = 2000.0) -> RestartPolicy:
        """Install a supervision policy for one node (``"*"``: every node
        without one of its own).  See :class:`RestartPolicy`."""
        name = node.name if isinstance(node, Node) else str(node)
        pol = RestartPolicy(mode, max_restarts=max_restarts, window_s=window_s,
                            backoff_ms=backoff_ms, backoff_cap_ms=backoff_cap_ms)
        self._restart_policies[name] = pol
        return pol

    def restart_policy_for(self, name: str) -> Optional[RestartPolicy]:
        """The node's own policy, else the ``"*"`` default, else the conf'd
        ``[recovery] policy`` (read at start); None means fail-pipeline."""
        pol = self._restart_policies.get(name)
        if pol is None:
            pol = self._restart_policies.get("*")
        return pol if pol is not None else self._conf_policy

    def _bump(self, action: str) -> None:
        with self._recovery_lock:
            self._recovery_counts[action] = self._recovery_counts.get(action, 0) + 1

    def _count_shed_frame(self, node: Node) -> None:
        """One frame shed by recovery (a restart's dropped frame, a
        quarantine's shed, a queue drain): the typed-loss side of
        delivered + shed == offered."""
        with self._recovery_lock:
            self._shed_frames[node.name] = self._shed_frames.get(node.name, 0) + 1

    @staticmethod
    def _specs_passthrough(node: Node) -> bool:
        """Quarantine passthrough is sound only when the frames the node
        would have produced have the spec of the ones it receives."""
        sinks = [p.spec for p in node.sink_pads.values() if p.peer is not None]
        srcs = [p.spec for p in node.src_pads.values() if p.peer is not None]
        return len(sinks) == 1 and bool(srcs) and all(s == sinks[0] for s in srcs)

    def _restart_budget_ok(self, node: Node, pol: RestartPolicy) -> Optional[int]:
        """Charge one restart against the node's storm budget; returns the
        restart ordinal (for the backoff), or None when the budget is
        spent."""
        now = time.monotonic()
        with self._recovery_lock:
            log = self._restart_log.setdefault(node.name, [])
            log[:] = [t for t in log if now - t <= pol.window_s]
            if len(log) >= pol.max_restarts:
                return None
            log.append(now)
            return len(log)

    def _attempt_restart(self, node: Node, exc: BaseException, pol: RestartPolicy, action: str,
                 in_specs: Optional[Dict] = None):
        """Charge the budget, back off, and stop()+start() the node, then run
        its commit phase again: on the current pad specs, or on ``in_specs``
        (a negotiation in progress).  Returns ``(True, out_specs)``, or
        ``(False, None)`` after a storm or a failed restart (recorded)."""
        from ..obs import recovery as _recovery

        n = self._restart_budget_ok(node, pol)
        if n is None:
            # restart storm: stop resuscitating, escalate to pipeline failure
            _recovery.record(self.name, action, "storm", node.name, repr(exc))
            return False, None
        backoff_s = min(pol.backoff_cap_ms, pol.backoff_ms * (2 ** (n - 1))) / 1e3
        if backoff_s > 0:
            time.sleep(backoff_s)
        out_specs = None
        try:
            node.stop()
            node.start()
            # restore the negotiated state: a fresh-started filter must
            # reinstall its fused wrapper and capture for the stream it is
            # on (fusion folds pre-transforms into the filter, so the raw
            # spec alone would mis-reconcile)
            if in_specs is not None:  # a negotiation in progress
                out_specs = node.configure(in_specs)
            else:
                specs = {p.name: p.spec for p in node.sink_pads.values()
                         if p.peer is not None and p.spec is not None}
                if specs:
                    node.configure(specs)
        except Exception as rexc:  # noqa: BLE001 - the restart itself failed
            _recovery.record(self.name, action, "error", node.name, repr(rexc))
            return False, None
        self._bump(action)
        _recovery.record(self.name, action, "ok", node.name, repr(exc))
        return True, out_specs

    def _node_fault(self, node: Node, exc: BaseException) -> bool:
        """A node's ``process()`` raised: consult its restart policy.  True:
        handled (frame dropped, node restarted or quarantined); False: the
        error halts the graph."""
        if self.state != "PLAYING":
            return False
        pol = self.restart_policy_for(node.name)
        if pol is None or pol.mode == "fail-pipeline":
            return False
        from ..obs import recovery as _recovery

        if pol.mode == "quarantine-passthrough":
            node._quarantine_passthrough = self._specs_passthrough(node)
            node._quarantined = True
            self._bump("quarantine")
            self._count_shed_frame(node)  # the offending frame is shed
            _recovery.record(self.name, "quarantine", "ok", node.name, repr(exc))
            return True
        if not self._attempt_restart(node, exc, pol, "restart_node")[0]:
            return False
        self._count_shed_frame(node)
        return True

    def _configure_fault(self, node: Node, in_specs: Dict, exc: BaseException):
        """A node's commit phase raised while the pipeline negotiates at
        start (a capture that failed: ``compile_raise``).  Under ``restart``
        the node restarts and negotiates again, and its output specs are
        returned; otherwise the original error is raised.  No frame has
        reached the node yet, so none is shed."""
        pol = self.restart_policy_for(node.name)
        if pol is not None and pol.mode == "restart":
            ok, out_specs = self._attempt_restart(node, exc, pol, "restart_node", in_specs)
            if ok:
                return out_specs
        raise exc

    def _source_fault(self, node: SourceNode, exc: BaseException) -> bool:
        """A source's ``frames()`` raised: only ``restart`` applies (a
        quarantined source is a dead stream).  Restarting enters
        ``frames()`` afresh: right for live sources; a finite data source
        replays from its start."""
        pol = self.restart_policy_for(node.name)
        if pol is None or pol.mode != "restart":
            return False
        return self._attempt_restart(node, exc, pol, "restart_source")[0]

    def restart_source(self, name: str) -> bool:
        """Replace a stalled source's streaming thread (a watchdog's
        escalation).  The stuck thread is joined briefly, then abandoned
        with a bumped epoch (it exits when it unblocks instead of pushing
        twice); the source restarts and streams on a fresh thread, or, under
        the lanes, the stale task is retired and a fresh one armed."""
        from ..obs import recovery as _recovery

        node = self.nodes.get(name)
        if not isinstance(node, SourceNode) or self.state != "PLAYING":
            return False
        node._epoch += 1
        node.request_stop()
        interrupt = getattr(node, "interrupt", None)
        if interrupt is not None:
            try:
                interrupt()
            except Exception:  # noqa: BLE001 - the restart below decides
                pass
        for t in [t for t in self.threads if t.name == f"src:{name}"]:
            t.join(timeout=2.0)
            self.threads.remove(t)
        if self._lanes is not None:
            # the lane twin of the join above: wait out the stale task's
            # executor before the stop event is cleared below
            self._lanes.retire_source(name)
        node._stop_evt.clear()
        try:
            node.stop()
            node.start()
        except Exception as exc:  # noqa: BLE001
            _recovery.record(self.name, "restart_source", "error", name, repr(exc))
            return False
        self._bump("restart_source")
        if _hooks.enabled:
            _hooks.emit("source_spawn", self, node)
        if self._lanes is not None:
            # the stale task exits on the bumped epoch; a fresh pull task
            # takes over
            self._lanes.respawn_source(node)
        else:
            t = threading.Thread(target=self._source_loop, args=(node,), name=f"src:{name}",
                                 daemon=True)
            self.threads.append(t)
            t.start()
        _recovery.record(self.name, "restart_source", "ok", name)
        return True

    def source_alive(self, name: str) -> bool:
        """Is the source executing: its streaming thread alive, or under the
        lanes its task mid-slice or its helper thread alive?  (A watchdog
        keys its stalled-source detection on this.)"""
        if self._lanes is not None:
            return self._lanes.source_alive(name)
        return any(t.name == f"src:{name}" and t.is_alive() for t in self.threads)

    def recover_queue(self, name: str) -> int:
        """Drain a wedged queue (a watchdog's escalation): shed its backlog
        with typed accounting, keeping its in-band events, and respawn its
        worker if the thread died (under the lanes, arm its drain task).
        Returns the frames drained, -1 when the node cannot recover."""
        from ..obs import recovery as _recovery

        node = self.nodes.get(name)
        rec = getattr(node, "recover", None)
        if rec is None:
            _recovery.record(self.name, "drain_queue", "error", name, "node has no recover()")
            return -1
        try:
            drained, new_threads = rec()
        except Exception as exc:  # noqa: BLE001
            _recovery.record(self.name, "drain_queue", "error", name, repr(exc))
            return -1
        for t in new_threads:
            t.daemon = True
            self.threads.append(t)
            t.start()
        with self._recovery_lock:
            if drained:
                self._shed_frames[name] = self._shed_frames.get(name, 0) + drained
        self._bump("drain_queue")
        _recovery.record(self.name, "drain_queue", "ok", name, f"drained={drained}")
        return drained

    def recovery_stats(self) -> dict:
        """The self-healing ledger: actions taken, frames shed per node (the
        typed-loss side of delivered + shed == offered), quarantined
        nodes."""
        with self._recovery_lock:
            out: dict = {}
            if self._recovery_counts:
                out["actions"] = dict(self._recovery_counts)
            if self._shed_frames:
                out["shed_frames"] = dict(self._shed_frames)
                out["shed_total"] = sum(self._shed_frames.values())
        quarantined = [n.name for n in self.nodes.values() if n._quarantined]
        if quarantined:
            out["quarantined"] = quarantined
        return out

    # -- negotiation --------------------------------------------------------

    def negotiate(self) -> None:
        """Topological two-phase spec negotiation over the whole graph."""
        pending = set(self.nodes.values())

        def linked_sinks(node: Node) -> List[Pad]:
            return [p for p in node.sink_pads.values() if p.peer is not None]

        progress = True
        while pending and progress:
            progress = False
            for node in list(pending):
                sinks = linked_sinks(node)
                if any(p.spec is None for p in sinks):
                    continue
                in_specs = {}
                for pad in sinks:
                    template = node.sink_spec(pad.name)
                    merged = template.intersect(pad.spec)
                    if merged is None:
                        raise NegotiationError(
                            f"{pad.full_name}: upstream spec {pad.spec} not accepted "
                            f"(template {template})"
                        )
                    in_specs[pad.name] = merged
                try:
                    out_specs = node.configure(in_specs)
                except NegotiationError:
                    raise
                except Exception as exc:  # noqa: BLE001 - a failed capture
                    out_specs = self._configure_fault(node, in_specs, exc)
                for pad_name, pad in node.src_pads.items():
                    if pad.peer is None:
                        continue
                    spec = out_specs.get(pad_name)
                    if spec is None:
                        raise NegotiationError(
                            f"{node.name}: configure() returned no spec for linked "
                            f"src pad {pad_name!r}"
                        )
                    pad.spec = spec
                    pad.peer.spec = spec
                pending.discard(node)
                progress = True
        if pending:
            names = ", ".join(sorted(n.name for n in pending))
            raise NegotiationError(f"negotiation stalled (cycle or dangling inputs): {names}")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Pipeline":
        if self.state == "PLAYING":
            return self
        self._done.clear()
        self._error = None
        self._error_node = None
        self._eos_leaves.clear()
        self._conf_policy = RestartPolicy.from_conf()
        with self._recovery_lock:
            self._restart_log.clear()
            self._recovery_counts.clear()
            self._shed_frames.clear()
        for node in self.nodes.values():
            node._quarantined = False
            node._quarantine_passthrough = False
        # conf-driven chaos (NNSTPU_FAULTS): a bad spec fails the start
        from ..faults import ensure_configured as _faults_configure

        _faults_configure()
        fuse_undos = []
        if self.auto_fuse:
            from .optimize import fuse_transforms
            from .segments import fuse_segments

            fuse_undos = fuse_transforms(self)
            fuse_segments(self)  # its undos ride on self._segment_undos
        for node in self.nodes.values():
            for pad in list(node.sink_pads.values()) + list(node.src_pads.values()):
                pad.eos = False
                pad.sig = None
                if pad.direction == "sink" and pad.peer is not None:
                    pad.spec = None
        started = []
        try:
            self._leaves = {
                n.name
                for n in self.nodes.values()
                if not any(p.peer is not None for p in n.src_pads.values())
            }
            if not self._leaves:
                raise PipelineError("pipeline has no leaf (sink) nodes")
            # tracers need the leaves, and attach before negotiation as in
            # the JAX package
            try:
                self._attach_observability()
            except Exception as exc:  # noqa: BLE001 - observability stays non-fatal
                warnings.warn(f"observability hooks failed: {exc!r}", stacklevel=2)
            for node in self.nodes.values():
                node.start()
                started.append(node)
            # every capture before PLAYING is warmup-phase: the "warmup"
            # Perfetto track and phase="warmup" of nnstpu_compile_seconds
            from ..obs.device import set_compile_phase
            from .warmup import run_warmup

            set_compile_phase("warmup")
            try:
                self.negotiate()
                run_warmup(self)  # [compile] warmup: every planned capture, before PLAYING
            finally:
                set_compile_phase(None)
        except BaseException:
            for node in started:
                try:
                    node.stop()
                except Exception as exc:  # noqa: BLE001 - keep the first error
                    warnings.warn(f"{node.name}: stop after failed start: {exc!r}",
                                  stacklevel=2)
            for tracer in self._tracers:
                tracer.stop()  # failed start: no hook may stay connected
            from .segments import restore_segments

            restore_segments(self)
            for undo in reversed(fuse_undos):
                undo()
            raise
        self.state = "PLAYING"
        self._post_negotiate_hooks()
        if _hooks.enabled:
            _hooks.emit("state_change", self, "NULL", "PLAYING")
        # the scheduling substrate: with [dispatch] lanes > 0, queue drains
        # and source pulls become lane tasks (graph/lanes.py); lanes = 0
        # keeps a thread an element
        from . import lanes as _lanes

        nlanes = _lanes.configured_lanes()
        if nlanes > 0:
            self._lanes = _lanes.LaneRuntime(self, nlanes)
            self._lanes.start()
        # threads that nodes ask for (queues), then the sources
        for node in self.nodes.values():
            if self._lanes is not None and getattr(node, "lane_task", None) is not None:
                self._lanes.add_element(node)
                continue
            spawn = getattr(node, "spawn_threads", None)
            if spawn is not None:
                for t in spawn():
                    t.daemon = True
                    self.threads.append(t)
                    t.start()
        for node in self.nodes.values():
            if isinstance(node, SourceNode):
                node._stop_evt.clear()
                if _hooks.enabled:
                    _hooks.emit("source_spawn", self, node)
                if self._lanes is not None:
                    self._lanes.add_source(node)
                    continue
                t = threading.Thread(
                    target=self._source_loop, args=(node,), name=f"src:{node.name}",
                    daemon=True,
                )
                self.threads.append(t)
                t.start()
        return self

    def _source_loop(self, node: SourceNode) -> None:
        epoch = node._epoch
        while True:
            try:
                for frame in node.frames():
                    if node.stopped or node._epoch != epoch or self.state != "PLAYING":
                        break
                    if _hooks.enabled:
                        # before the first pad push: the latency tracer
                        # stamps the frame here
                        _hooks.emit("source_push", self, node, frame)
                    node.push(frame)
                if node._epoch != epoch:
                    return  # superseded by restart_source: not this thread's EOS
                for pad in node.src_pads.values():
                    pad.push(Event.eos())
                return
            except BaseException as exc:  # noqa: BLE001 - any node failure
                if node._epoch != epoch:
                    return  # a replacement thread owns this source now
                if (self.state == "PLAYING" and not node.stopped
                        and self._source_fault(node, exc)):
                    continue  # restarted: enter frames() afresh
                self.post_error(node, exc)
                return

    def post_error(self, node: Optional[Node], exc: BaseException) -> None:
        with self._lock:
            first = self._error is None
            if first:
                self._error = exc
                self._error_node = node.name if node else None
        if first and self.state == "PLAYING":
            self.state = "ERROR"  # sources poll the state per frame and stop
            if _hooks.enabled:
                _hooks.emit("state_change", self, "PLAYING", "ERROR")
        if _hooks.enabled:
            _hooks.emit("error", self, node, exc)
        traceback.print_exception(type(exc), exc, exc.__traceback__)
        if first:
            # the graph as it died, and the span recorder
            self._dump_dot("ERROR")
            self._dump_flight("error")
        self._done.set()

    def _node_eos(self, node: Node) -> None:
        """A node whose every sink pad saw EOS; leaves mark completion."""
        if any(p.peer is not None for p in node.src_pads.values()):
            return
        with self._lock:
            self._eos_leaves.add(node.name)
            if self._leaves and self._eos_leaves >= self._leaves:
                self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until EOS on all leaves.  True on EOS, False on timeout;
        raises on error."""
        finished = self._done.wait(timeout)
        if self._error is not None:
            raise PipelineError(
                f"error in node {self._error_node!r}: {self._error!r}"
            ) from self._error
        return finished

    def stop(self) -> None:
        if self.state not in ("PLAYING", "ERROR"):
            self.state = "STOPPED"
            return
        prev = self.state
        self.state = "STOPPED"
        if _hooks.enabled:
            _hooks.emit("state_change", self, prev, "STOPPED")
        # tracers are still connected: the STOPPED dump has the final counts
        self._dump_dot("STOPPED")
        for node in self.nodes.values():
            if isinstance(node, SourceNode):
                node.request_stop()
            interrupt = getattr(node, "interrupt", None)
            if interrupt is not None:
                interrupt()
        leaked = []
        for t in self.threads:
            t.join(timeout=5.0)
            if t.is_alive():
                leaked.append(t.name)
        self.threads.clear()
        if self._lanes is not None:
            leaked.extend(self._lanes.stop(timeout=5.0))
            self._lanes = None
        if leaked:
            warnings.warn(
                f"pipeline {self.name!r}: {len(leaked)} thread(s) did not exit "
                f"within 5s: {', '.join(leaked)}",
                RuntimeWarning,
                stacklevel=2,
            )
        for node in self.nodes.values():
            node.stop()
        # segment folds are per run: the next start plans the user's graph
        from .segments import restore_segments

        restore_segments(self)
        # accumulated data stays readable through stats(); a restart
        # reconnects the tracers
        for tracer in self._tracers:
            tracer.stop()
        if self._xplane_tracing:
            self._xplane_tracing = False
            # the deep-profiling lane writes, parses and banks the trace;
            # a failure surfaces on the health hook, never raises
            from ..obs import profiler as _profiler

            _profiler.stop_whole_run(self)

    def run(self, timeout: Optional[float] = None) -> None:
        """start() + wait() + stop() for finite streams."""
        self.start()
        try:
            if not self.wait(timeout):
                raise PipelineError(f"pipeline did not finish within {timeout}s")
        finally:
            self.stop()

    def warmup(self) -> dict:
        """Run the warmup phase now, on a started pipeline (it needs the
        negotiated specs), whatever ``[compile] warmup`` says; returns the
        report, also kept as :attr:`warmup_report`."""
        from .warmup import check_memory, collect_plan, execute

        if self.state != "PLAYING":
            raise PipelineError("warmup() needs a started pipeline (negotiated specs)")
        self.warmup_report = execute(collect_plan(self), pipeline=self)
        self.warmup_report["hbm"] = check_memory(self)
        return self.warmup_report

    # -- introspection ------------------------------------------------------

    def _post_negotiate_hooks(self) -> None:
        """Conf-driven observability at PLAYING: profiling on, and the dot
        dump (the GST_DEBUG_DUMP_DOT_DIR analog).  A failure, a bad conf
        value included, is a warning."""
        from ..conf import conf

        try:
            if conf.get_bool("common", "enable_profiling", False):
                from ..utils import profiling

                profiling.enable(True)
            trace_dir = conf.get_path("common", "xplane_trace_dir", "")
            if trace_dir:
                # a torch.profiler trace of the whole PLAYING interval through
                # the deep-profiling lane: the trace under the user's
                # trace_dir, its summary in the capture gallery, /profile
                # answering 409 meanwhile; written at stop()
                from ..obs import profiler as _profiler

                self._xplane_tracing = _profiler.start_whole_run(self, trace_dir)
            self._dump_dot("PLAYING")
        except Exception as exc:  # noqa: BLE001 - observability stays non-fatal
            warnings.warn(f"observability hooks failed: {exc!r}", stacklevel=2)

    def _attach_observability(self) -> None:
        """Conf-driven tracers (``NNSTPU_TRACERS=latency;stats``) and the
        scrape endpoint (``NNSTPU_METRICS_PORT``), resolved at every start;
        this pipeline's :meth:`stats` joins ``/stats.json``."""
        from ..obs import configured_metrics_port, configured_tracers, ensure_server
        from ..obs.export import register_stats

        attached = {t.name for t in self._tracers}
        for name in configured_tracers():
            if name not in attached:
                self.attach_tracer(name)
                attached.add(name)
        for tracer in self._tracers:
            tracer.start(self)
        port = configured_metrics_port()
        if port is not None:
            ensure_server(port)
        register_stats(self.name, self.stats)

    def attach_tracer(self, tracer):
        """Attach a tracer (a name of ``obs.TRACERS`` or an instance): its
        hooks connect now when PLAYING, else at the next start.  Returns
        the tracer; its ``summary()`` is also in :meth:`stats` under
        ``"tracers"``."""
        from ..obs.tracers import make_tracer

        if isinstance(tracer, str):
            tracer = make_tracer(tracer)
        self._tracers.append(tracer)
        if self.state == "PLAYING":
            tracer.start(self)
        return tracer

    def detach_tracer(self, tracer) -> None:
        tracer.stop()
        if tracer in self._tracers:
            self._tracers.remove(tracer)

    @property
    def tracers(self) -> List:
        return list(self._tracers)

    def stats(self) -> dict:
        """Per-node invoke-latency summary (ms) of this pipeline's nodes
        (recorded while profiling is on), plus one ``"tracers"`` entry per
        attached tracer (latency, throughput, drops, copies, spans, device)
        and, once recovery acted, the ``"recovery"`` ledger; under the
        dispatcher lanes, ``"lanes"`` (:meth:`~.lanes.LaneRuntime.stats`)."""
        from ..utils import profiling

        out = {k: v for k, v in profiling.stats().items() if k in self.nodes}
        if self._tracers:
            out["tracers"] = {t.name: t.summary() for t in self._tracers}
        rec = self.recovery_stats()
        if rec:
            out["recovery"] = rec
        lanes = self._lanes
        if lanes is not None:
            out["lanes"] = lanes.stats()
        return out

    def flight_snapshot(self) -> list:
        """Span records of a ``spans`` tracer (the flight recorder),
        time-ordered, for :func:`nnstreamer_tpu_torch.obs.spans.chrome_trace`
        and :func:`~nnstreamer_tpu_torch.obs.spans.waterfall`.  Readable
        while PLAYING and after stop."""
        from ..obs import spans

        return spans.snapshot()

    def _tracers_active(self) -> bool:
        return any(t.active for t in self._tracers)

    def _dump_dot(self, transition: str) -> None:
        """Write ``{name}.{transition}.dot`` into ``[common] dump_dot_dir``
        on a state change or an error."""
        import os

        from ..conf import conf

        try:
            dot_dir = conf.get_path("common", "dump_dot_dir", "")
            if not dot_dir:
                return
            os.makedirs(dot_dir, exist_ok=True)
            path = os.path.join(dot_dir, f"{self.name}.{transition}.dot")
            with open(path, "w") as f:
                f.write(self.to_dot(annotate=self._tracers_active()))
        except Exception as exc:  # noqa: BLE001 - observability stays non-fatal
            warnings.warn(f"dot dump ({transition}) failed: {exc!r}", stacklevel=2)

    def _dump_flight(self, transition: str) -> None:
        """Write the flight recorder as Chrome-trace JSON on an error, or on
        a watchdog's stall verdict (``[obs] flight_dump_dir``): open
        ``{name}.error.trace.json`` or ``{name}.stall.trace.json`` in
        Perfetto."""
        import json
        import os

        from ..conf import conf
        from ..obs import spans

        try:
            if not spans.enabled:
                return
            dump_dir = conf.get_path("obs", "flight_dump_dir", "")
            if not dump_dir:
                return
            os.makedirs(dump_dir, exist_ok=True)
            path = os.path.join(dump_dir, f"{self.name}.{transition}.trace.json")
            doc = spans.chrome_trace(spans.snapshot(), process_name=self.name)
            from ..obs.device import device_memory_snapshot

            from ..obs.profiler import hbm_ledger

            mem = device_memory_snapshot()
            if mem:
                # "otherData" is the trace-event format's sidecar slot: what
                # the card's allocator held when the graph died
                doc["otherData"] = {"device_memory": mem}
            ledger = hbm_ledger()
            if ledger:
                # each captured graph's memory beside the allocator's: an
                # out-of-memory verdict can name the largest graph
                doc.setdefault("otherData", {})["hbm_ledger"] = ledger
            with open(path, "w") as f:
                json.dump(doc, f)
        except Exception as exc:  # noqa: BLE001 - observability stays non-fatal
            warnings.warn(f"flight dump ({transition}) failed: {exc!r}", stacklevel=2)

    def _dot_annotations(self) -> Dict[str, str]:
        """Live per-node stats for annotated dot dumps: frames pushed from
        the stats tracer, queue depth from queue-like nodes' stats()."""
        notes: Dict[str, str] = {}
        for tracer in self._tracers:
            if tracer.name != "stats" or not tracer.active:
                continue
            for name, s in tracer.summary().items():
                parts = []
                if s.get("frames") is not None:
                    parts.append(f"{s['frames']} frames")
                if s.get("queue_depth") is not None:
                    parts.append(f"depth {s['queue_depth']}")
                if parts:
                    notes[name] = ", ".join(parts)
        for node in self.nodes.values():
            if node.name in notes:
                continue
            node_stats = getattr(node, "stats", None)
            if node_stats is None:
                continue
            try:
                s = node_stats()
            except Exception:  # noqa: BLE001 - annotation is best-effort
                continue
            if isinstance(s, dict) and s.get("depth") is not None:
                notes[node.name] = f"depth {s['depth']}"
        return notes

    def to_dot(self, annotate: bool = False) -> str:
        """Graphviz dump of the graph with negotiated specs (the
        GST_DEBUG_DUMP_DOT_DIR analog); ``annotate=True`` adds live stats
        (frames pushed, queue depth) to node labels when tracers collect."""
        notes = self._dot_annotations() if annotate else {}
        lines = [f'digraph "{self.name}" {{', "  rankdir=LR;", "  node [shape=box];"]
        for node in self.nodes.values():
            label = f"{node.name}\\n{type(node).__name__}"
            extra = notes.get(node.name)
            if extra:
                label += f"\\n{extra}"
            lines.append(f'  "{node.name}" [label="{label}"];')
        for node in self.nodes.values():
            for pad in node.src_pads.values():
                if pad.peer is not None:
                    label = str(pad.spec) if pad.spec is not None else ""
                    lines.append(
                        f'  "{node.name}" -> "{pad.peer.node.name}" '
                        f'[label="{pad.name}→{pad.peer.name}\\n{label}"];'
                    )
        lines.append("}")
        return "\n".join(lines)
