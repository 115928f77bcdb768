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
sources start, and ``stop`` interrupts and joins them.  Not ported yet:
restart policies and quarantine, the dispatcher lanes, the ``obs.hooks``
calls, and the JAX package's warmup phase (``graph/warmup.py``,
``Pipeline.warmup``), which only its batching element plans work for.
"""

from __future__ import annotations

import threading
import traceback
import warnings
from typing import Dict, List, Optional, Union

from ..buffer import Event
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
            from .segments import restore_segments

            restore_segments(self)
            for undo in reversed(fuse_undos):
                undo()
            raise
        self.state = "PLAYING"
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
        traceback.print_exception(type(exc), exc, exc.__traceback__)
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
        self.state = "STOPPED"
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

    def run(self, timeout: Optional[float] = None) -> None:
        """start() + wait() + stop() for finite streams."""
        self.start()
        try:
            if not self.wait(timeout):
                raise PipelineError(f"pipeline did not finish within {timeout}s")
        finally:
            self.stop()
