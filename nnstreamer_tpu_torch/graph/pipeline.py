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

Not ported yet: restart policies and quarantine (and ``stats()``'s
``recovery`` key), the dispatcher lanes (``stats()``'s ``lanes``), the
JAX package's warmup phase (``graph/warmup.py``, ``Pipeline.warmup``),
which only its batching element plans work for, the device trace of the
whole PLAYING interval (``[common] xplane_trace_dir``), and the device
memory sidecars of a flight dump, which wait for the port's device lane
and profiler.
"""

from __future__ import annotations

import threading
import traceback
import warnings
from typing import Dict, List, Optional, Union

from ..buffer import Event
from ..obs import hooks as _hooks
from .node import NegotiationError, Node, Pad, SourceNode


class PipelineError(Exception):
    pass


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
                out_specs = node.configure(in_specs)
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
            self.negotiate()
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
        # threads that nodes ask for (queues), then the sources
        for node in self.nodes.values():
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
                t = threading.Thread(
                    target=self._source_loop, args=(node,), name=f"src:{node.name}",
                    daemon=True,
                )
                self.threads.append(t)
                t.start()
        return self

    def _source_loop(self, node: SourceNode) -> None:
        try:
            for frame in node.frames():
                if node.stopped or self.state != "PLAYING":
                    break
                if _hooks.enabled:
                    # before the first pad push: the latency tracer stamps
                    # the frame here
                    _hooks.emit("source_push", self, node, frame)
                node.push(frame)
            for pad in node.src_pads.values():
                pad.push(Event.eos())
        except BaseException as exc:  # noqa: BLE001 - any node failure halts the graph
            self.post_error(node, exc)

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

    def run(self, timeout: Optional[float] = None) -> None:
        """start() + wait() + stop() for finite streams."""
        self.start()
        try:
            if not self.wait(timeout):
                raise PipelineError(f"pipeline did not finish within {timeout}s")
        finally:
            self.stop()

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
        attached tracer: latency, throughput, drops, copies, spans."""
        from ..utils import profiling

        out = {k: v for k, v in profiling.stats().items() if k in self.nodes}
        if self._tracers:
            out["tracers"] = {t.name: t.summary() for t in self._tracers}
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
        """Write the flight recorder as Chrome-trace JSON on an error
        (``[obs] flight_dump_dir``): open ``{name}.error.trace.json`` in
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
