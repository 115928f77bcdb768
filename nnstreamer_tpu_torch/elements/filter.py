"""``tensor_filter``: invokes a model on the stream.

The port of the JAX package's element: ``framework=`` picks a backend from
the registry (``torch``), the model opens on start, negotiation reconciles
the model's declared spec with the upstream stream spec and fails loudly on
a mismatch, and each frame's tensors go through the backend's ``invoke``
under ``torch.inference_mode()``.  Outputs stay on the backend's device.
``input=`` / ``inputtype=`` and ``output=`` / ``outputtype=`` declare the
model's input and output in the reference's notation (dims strings, ``.``
between tensors; types, ``,`` between them); negotiation holds the model's
spec and the stream to them.

The graph passes may fold neighbours into the filter
(:meth:`TensorFilter.set_fused_transforms`): transforms before and after it
(``graph/optimize.py``), and for whole-segment compilation a trivial
converter before it and a decoder's device head after it
(``graph/segments.py``).  :meth:`TensorFilter._install_fusion` then wraps
the model call in the backend so one ``invoke`` runs the whole chain; on
CUDA the backend captures that chain once per negotiated geometry as a
CUDA graph and replays it per frame (``backends/torch_backend.py``).

With profiling on (``utils/profiling.py``) each invoke is timed until its
outputs are done on the device, waiting on the filter stream's work alone,
and recorded under the filter's name (``Pipeline.stats``).  With a tracer
attached, ``device_dispatch`` fires after the invoke has returned (on the
host, never inside a capture).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ..backends.base import FilterBackend, get_backend
from ..buffer import Frame
from ..graph.node import NegotiationError, Node, Pad
from ..graph.registry import register_element
from ..obs import hooks as _hooks
from ..spec import TensorSpec, TensorsSpec, dtype_from_name
from ..utils import profiling


@register_element("tensor_filter")
class TensorFilter(Node):
    def __init__(
        self,
        name: Optional[str] = None,
        framework: str = "",
        model: object = None,
        custom: str = "",
        input: str = "",
        inputtype: str = "",
        output: str = "",
        outputtype: str = "",
        backend: Optional[FilterBackend] = None,
    ):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        if backend is not None:
            self.backend = backend
        else:
            if not framework:
                raise ValueError("tensor_filter requires framework=")
            self.backend = get_backend(framework)
        self.framework = framework or self.backend.name
        self.model = model
        self.custom = str(custom)
        self._prop_in = self._parse_spec_props(input, inputtype)
        self._prop_out = self._parse_spec_props(output, outputtype)
        self._opened = False
        self._fused_pre: list = []  # stages folded in before the model
        self._fused_post: list = []  # and after it

    def set_fused_transforms(self, pre: list, post: list) -> None:
        """Install the stages folded into this filter (called by the graph
        passes).  A pre-stage or a 1:1 post-stage offers the transform
        protocol, ``build_fn(spec) -> fn(x)`` and ``out_spec_for(spec)``,
        applied per tensor; an N:M post-stage offers ``build_multi(spec) ->
        (fn(xs) -> tuple, out spec) | None`` and ``on_refuse()``.  Every
        stage offers ``describe(spec)``: what it computes for ``spec``, the
        stage's part of the backend's capture key."""
        self._fused_pre = list(pre)
        self._fused_post = list(post)

    @staticmethod
    def _parse_spec_props(dims: str, types: str) -> Optional[TensorsSpec]:
        """``input=3:224:224:1.1:10`` with ``inputtype=uint8,float32``: one
        tensor per ``.``-separated dims string and ``,``-separated type."""
        if not dims and not types:
            return None
        dim_list = [d for d in str(dims).split(".") if d] if dims else []
        type_list = [t for t in str(types).split(",") if t] if types else []
        tensors = []
        for i in range(max(len(dim_list), len(type_list))):
            d = dim_list[i] if i < len(dim_list) else None
            t = type_list[i] if i < len(type_list) else None
            if d is not None:
                tensors.append(TensorSpec.from_dims_string(d, t))
            else:
                tensors.append(TensorSpec(dtype=dtype_from_name(t)))
        return TensorsSpec(tensors=tuple(tensors))

    def start(self) -> None:
        super().start()
        if not self._opened:
            # a backend handed in with its model loaded (model=None) keeps
            # its state and its warm captures: no re-open
            if self.model is not None or getattr(self.backend, "model", None) is None:
                self.backend.open(self.model, self.custom)
            self._opened = True

    def stop(self) -> None:
        if self._opened:
            self.backend.close()
            self._opened = False
        super().stop()

    def sink_spec(self, pad_name: str) -> TensorsSpec:
        del pad_name
        if self._fused_pre:
            # the stream spec is pre-stage; the model spec and input= apply
            # after the fused pre-stages, checked in _install_fusion
            return TensorsSpec()
        spec = self.backend.model_spec() if self._opened else None
        if spec is not None and self._prop_in is not None:
            merged = spec.intersect(self._prop_in)
            if merged is None:
                raise NegotiationError(
                    f"{self.name}: input property {self._prop_in} conflicts "
                    f"with model spec {spec}")
            return merged
        return self._prop_in or spec or TensorsSpec()

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        in_spec = in_specs["sink"]
        try:
            if self._fused_pre or self._fused_post:
                out_spec = self.backend.reconfigure_fused(in_spec, self._install_fusion(in_spec))
                set_hook = getattr(self.backend, "set_drift_hook", None)
                if set_hook is not None:
                    # a frame that drifts without a caps event rebuilds
                    # the fused chain, not just the capture
                    set_hook(self._drift_reinstall)
            else:
                out_spec = self.backend.reconfigure(in_spec)
        except ValueError as exc:
            raise NegotiationError(f"{self.name}: {exc}") from exc
        # output= describes the model's output: with fused post-stages the
        # pad's spec is theirs, and _install_fusion checked the model's
        if self._prop_out is not None and not self._fused_post:
            merged = out_spec.intersect(self._prop_out)
            if merged is None:
                raise NegotiationError(
                    f"{self.name}: model output {out_spec} conflicts with "
                    f"output property {self._prop_out}")
            out_spec = merged
        if in_spec.rate is not None and out_spec.rate is None:
            out_spec = TensorsSpec(tensors=out_spec.tensors, rate=in_spec.rate)
        return {"src": out_spec}

    def _drift_reinstall(self, drifted: TensorsSpec) -> None:
        """Rebind the fused chain to a drifted input spec: its stages bake
        the old geometry, so the wrapper is rebuilt before the backend
        selects (or takes) the capture for the new spec."""
        self.backend.reconfigure_fused(drifted, self._install_fusion(drifted))

    def _install_fusion(self, in_spec: TensorsSpec) -> TensorsSpec:
        """Wrap the model call with the fused pre- and post-stages, so the
        whole chain runs as one call on the device; returns the wrapped
        function's output spec, derived stage by stage."""
        pre_stages = []
        stages = []  # descriptors of what the wrapper runs: the capture key
        spec_cur = in_spec
        for tr in self._fused_pre:
            pre_stages.append([tr.build_fn(t) for t in spec_cur.tensors])
            stages.append([tr.describe(t) for t in spec_cur.tensors])
            spec_cur = TensorsSpec(tensors=tuple(tr.out_spec_for(t) for t in spec_cur.tensors),
                                   rate=spec_cur.rate)
        model_spec = self.backend.model_spec()
        if model_spec is not None and model_spec.intersect(spec_cur) is None:
            raise NegotiationError(
                f"{self.name}: fused pre-stage output {spec_cur} is incompatible "
                f"with model spec {model_spec}")
        if self._prop_in is not None and self._prop_in.intersect(spec_cur) is None:
            raise NegotiationError(
                f"{self.name}: fused pre-stage output {spec_cur} conflicts with "
                f"input property {self._prop_in}")
        # 1:1 post-stages map each tensor (tensor_transform); an N:M stage
        # (a decoder's device head) takes the whole tuple
        post_stages = []  # (per-tensor fns | None, multi fn | None)
        spec_o = self.backend.trace_output_spec(spec_cur)
        if (self._fused_post and self._prop_out is not None
                and self._prop_out.intersect(spec_o) is None):
            raise NegotiationError(
                f"{self.name}: model output {spec_o} conflicts with "
                f"output property {self._prop_out}")
        post = list(self._fused_post)
        for i, tr in enumerate(post):
            build_multi = getattr(tr, "build_multi", None)
            if build_multi is not None:
                built = build_multi(spec_o)
                if built is None:
                    # the stage refused this geometry: drop it and the rest of
                    # the chain (which consumes its output), each back on host
                    for rest in post[i:]:
                        refuse = getattr(rest, "on_refuse", None)
                        if refuse is not None:
                            refuse()
                    break
                mfn, spec_o = built
                post_stages.append((None, mfn))
                stages.append(tr.describe(spec_o))
            else:
                post_stages.append(([tr.build_fn(t) for t in spec_o.tensors], None))
                stages.append([tr.describe(t) for t in spec_o.tensors])
                spec_o = TensorsSpec(tensors=tuple(tr.out_spec_for(t) for t in spec_o.tensors),
                                     rate=spec_o.rate)

        def wrapper(orig):
            def fn(*xs):
                for stage in pre_stages:
                    xs = tuple(f(x) for f, x in zip(stage, xs))
                outs = orig(*xs)
                outs = tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)
                for zip_fns, multi_fn in post_stages:
                    if multi_fn is not None:
                        outs = tuple(multi_fn(outs))
                    else:
                        outs = tuple(f(x) for f, x in zip(zip_fns, outs))
                return outs
            return fn

        self.backend.set_wrapper(wrapper, stages=stages)
        return spec_o

    def process(self, pad: Pad, frame: Frame):
        del pad
        with torch.inference_mode():
            if profiling.enabled():
                t0 = time.perf_counter_ns()
                outs = self.backend.invoke(frame.tensors)
                profiling.block_outputs(outs)
                profiling.record(self.name, time.perf_counter_ns() - t0)
                if _hooks.enabled:
                    _hooks.emit("device_dispatch", self, frame, outs, t0)
            elif _hooks.enabled:
                t0 = time.perf_counter_ns()
                outs = self.backend.invoke(frame.tensors)
                _hooks.emit("device_dispatch", self, frame, outs, t0)
            else:
                outs = self.backend.invoke(frame.tensors)
        if not outs:
            return None
        return frame.with_tensors(outs)
