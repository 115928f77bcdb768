"""The PyTorch filter backend, ``framework="torch"``.

The port's counterpart of the JAX package's ``JaxModel`` / ``JaxBackend``
(``backends/jax_backend.py``): a model is an apply callable over params,
with its declared input spec.

Where the JAX backend compiles each negotiated geometry once into an LRU of
executables, this backend **captures** it: on CUDA,
:meth:`TorchBackend.reconfigure` and :meth:`TorchBackend.reconfigure_fused`
capture the current function, bare or wrapped, for the negotiated spec as
one ``torch.cuda.CUDAGraph`` (:func:`capture_graph`) into an LRU of
``compile_cache`` entries (default 8, ``custom="compile_cache=N"`` or
``compile_cache:N``).  Before the capture the function runs eagerly on a
side stream a few times, as PyTorch's CUDA-graph notes prescribe: that
does the lazy one-time work outside the capture (cuDNN plans, cuBLAS
workspaces, the decoders' per-device constants, the kernels' library
loads and ``int8_matmul``'s launch attributes).  :meth:`TorchBackend.invoke`
then copies each frame's tensors into the entry's static inputs, replays
the graph and returns **clones** of the static outputs: without the clone
every frame a collecting sink holds would alias the last frame's output.
A function that cannot be captured (a host synchronization, a shape that
depends on the data) raises ``NegotiationError`` naming the model and the
op; there is no eager fallback on the card.  On the CPU (``device="cpu"``,
the tests) ``invoke`` runs the function eagerly.

Per frame, :meth:`TorchBackend.invoke` compares each tensor's shape and
dtype with the negotiated spec (the JAX package's drift guard): a frame
that drifted without a caps event is never cast or reshaped into the old
capture.  A bare model is reconfigured for the drifted spec (a new capture,
or its cached one); a wrapped function is rebuilt by its filter through the
drift hook (:meth:`TorchBackend.set_drift_hook`), since the fused stages
bake the old geometry.  On the card that capture happens while the pipeline
plays, on the filter's thread: the capture waits only on the streams it
uses, so the upload's copies on the source's thread go on.

Entries are keyed by the input spec, the segment label and a fingerprint
of what was captured (``backends/exec_cache.py``: the wrapper's stage
descriptors, the parameter shapes and dtypes, the kernel sources), so a
new wrapper never replays an old function's capture; old captures age out
of the LRU.  :meth:`TorchBackend.open` drops them all, since they read the
old model's tensors.

The warmup phase (``graph/warmup.py``) captures the geometries a stream
will bring later, ``tensor_dynbatch``'s buckets, before PLAYING:
:meth:`TorchBackend.warm_compile` adds a capture to the LRU without
changing the active one, and :meth:`TorchBackend.ensure_cache_capacity`
grows the LRU to hold the ladder.

Transform fusion and whole-segment compilation (``graph/optimize.py``,
``graph/segments.py``) install a wrapper (:meth:`TorchBackend.set_wrapper`):
a function of the model call that runs the fused pre-stages, the model and
the fused post-stages (a decoder's device head among them) in one call, so
one replay takes a frame from its raw stream tensors to the filter's last
output.  ``segment_label`` names the folded region.

Models (:meth:`TorchBackend.open`): a :class:`TorchModel`, an
``nn.Module`` or a callable; or a path, as a launch string names it with
``model=``:

- a ``.py`` file defining ``get_model()`` (``get_model(custom)`` when
  ``custom`` is given) that returns a :class:`TorchModel`;
- a ``.npz`` params checkpoint (``utils/checkpoint.py``; an orbax
  checkpoint directory is refused there) with ``custom="builder=..."``: ``builder=file.py:fn``
  calls ``fn(params)``; ``builder=mobilenet_v2:build_quantized,int8_head=1``
  calls that builder of ``nnstreamer_tpu_torch.models`` with
  ``params=``, ``device=`` the backend's device and the other custom keys
  (as int, else float, else string).  The params keep the JAX package's
  layout, which every port model takes (``params_from_jax``), so a
  checkpoint the JAX package wrote serves here unchanged;
- any other file is TorchScript, loaded with ``torch.jit.load``; its input
  spec is left open (shape-polymorphic), as the JAX package's ``torch``
  backend leaves it.

A model from a file lives on ``[filter] torch_device`` (``conf.py``, default
``cuda``; ``NNSTPU_FILTER_TORCH_DEVICE=cpu`` for the host);
``framework=torch-cpu`` is the same backend pinned to the CPU.  Of
``custom=``, ``compile_cache`` and ``donate`` belong to the backend and are
never passed to a builder; ``donate`` is accepted and does nothing, since a
replay always copies a frame into the capture's static inputs.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import importlib.util
import os
import time
import traceback
from typing import Any, Callable, Optional, Tuple

import torch

from ..conf import conf
from ..device import resolve_device
from ..graph.node import NegotiationError
from ..pool import wait_ready
from ..spec import TensorsSpec, numpy_dtype, torch_dtype
from . import exec_cache
from .base import FilterBackend, register_backend

DEFAULT_COMPILE_CACHE = 8
WARMUP_CALLS = 3  # eager calls on a side stream before each capture


@dataclasses.dataclass
class TorchModel:
    """A model as the backend sees it: ``apply(params, *inputs)`` (an
    ``nn.Module`` works as ``apply`` with ``params=None``), its params, the
    declared input spec (``None`` dims are fixed at negotiation), the output
    spec when known, and the device the params live on."""

    apply: Callable
    params: Any = None
    input_spec: Optional[TensorsSpec] = None
    output_spec: Optional[TensorsSpec] = None
    name: str = "torch_model"
    device: Any = "cuda"

    def __call__(self, *xs):
        if isinstance(self.apply, torch.nn.Module):
            return self.apply(*xs)
        return self.apply(self.params, *xs)


def _as_tuple(outs) -> Tuple:
    return tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_py_model(path: str, custom: str) -> TorchModel:
    """A ``.py`` model file: its ``get_model()`` returns the model."""
    mod = _load_module(path, "nns_torch_user_model")
    if not hasattr(mod, "get_model"):
        raise ValueError(f"{path}: no get_model() found")
    model = mod.get_model(custom) if custom else mod.get_model()
    if not isinstance(model, TorchModel):
        raise TypeError(f"{path}: get_model() must return TorchModel")
    return model


def _builder_kwargs(props: dict, reserved: frozenset) -> dict:
    """The custom keys a built-in builder takes: each as int, else float,
    else string; ``builder`` and the backend's own keys left out."""
    kwargs = {}
    for k, v in props.items():
        if k == "builder" or k in reserved:
            continue
        for cast in (int, float):
            try:
                kwargs[k] = cast(v)
                break
            except ValueError:
                pass
        else:
            kwargs[k] = v
    return kwargs


def _load_checkpoint_model(path: str, custom: str, reserved: frozenset,
                           device: torch.device) -> TorchModel:
    """``model=<checkpoint>.npz`` with ``custom="builder=..."``: the params
    tree from the file, handed to the builder that returns the model."""
    from ..utils.checkpoint import load_state

    params = load_state(path)
    props = parse_custom(custom)
    builder = props.get("builder", "")
    if not builder:
        raise ValueError(f"torch backend: checkpoint {path!r} needs custom=\"builder=...\"")
    spec_s, _, fn_name = builder.partition(":")
    if spec_s.endswith(".py"):
        fn = getattr(_load_module(spec_s, "nns_torch_builder"), fn_name or "build")
        model = fn(params)
    else:
        mod = importlib.import_module(f"nnstreamer_tpu_torch.models.{spec_s}")
        fn = getattr(mod, fn_name or "build")
        model = fn(params=params, device=device, **_builder_kwargs(props, reserved))
    if not isinstance(model, TorchModel):
        raise TypeError(f"builder {builder!r} must return TorchModel")
    return model


def parse_custom(custom: str) -> dict:
    """``custom=`` options, ``k=v`` or ``k:v``, comma-separated."""
    out = {}
    for part in (custom or "").split(","):
        part = part.strip()
        if part:
            k, sep, v = part.partition("=")
            if not sep:
                k, _, v = part.partition(":")
            out[k.strip()] = v.strip()
    return out


class CapturedGraph:
    """One geometry of the filter's function, captured: the graph, its
    static inputs and outputs, and the function (whose tensors the graph
    reads, so it stays alive with the entry)."""

    def __init__(self, graph, fn, static_in, static_out, warmup_calls, warmup_s, capture_s):
        self.graph = graph
        self.fn = fn
        self.static_in = static_in
        self.static_out = static_out
        self.warmup_calls = warmup_calls
        self.warmup_s = warmup_s
        self.capture_s = capture_s

    def run(self, xs) -> Tuple:
        for s, x in zip(self.static_in, xs):
            if x.shape != s.shape or x.dtype != s.dtype:
                raise ValueError(f"captured for {s.dtype}{tuple(s.shape)}, "
                                 f"got {x.dtype}{tuple(x.shape)}")
            s.copy_(x, non_blocking=True)
        self.graph.replay()
        return tuple(o.clone() for o in self.static_out)


def _failing_op(exc: BaseException) -> str:
    """The innermost frame outside torch itself of the capture's error (or
    of the error it replaced): the op that could not be captured."""
    for e in (exc, exc.__context__):
        if e is None:
            continue
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if "/torch/" not in f.filename.replace("\\", "/")]
        if frames:
            f = frames[-1]
            return f"{f.filename}:{f.lineno} in {f.name}: {f.line}"
    return "unknown op"


def capture_graph(fn: Callable, in_spec: TensorsSpec, device: torch.device,
                  warmup_calls: int = WARMUP_CALLS) -> CapturedGraph:
    """Capture ``fn`` at ``in_spec`` on ``device`` as one CUDA graph: zeros
    as static inputs, ``warmup_calls`` eager calls on a side stream first.

    ``capture_error_mode="thread_local"``: the capture refuses an unsafe
    call (a host synchronization) from this thread, but not the upload's
    copies on the source's thread, should a caps change or a drifted frame
    re-capture while the pipeline plays.  The capture synchronizes the
    whole device (``torch.cuda.graph`` does so on entry): it waits for the
    upload's copies already issued, but cannot deadlock against them, since
    those copies wait on nothing of the filter's and the upload's thread
    takes no lock that the filter's thread holds."""
    static_in = tuple(torch.zeros(t.shape, dtype=torch_dtype(t.dtype), device=device)
                      for t in in_spec.tensors)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    t0 = time.perf_counter()
    with torch.inference_mode(), torch.cuda.stream(side):
        for _ in range(warmup_calls):
            fn(*static_in)
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode(), torch.cuda.graph(graph, capture_error_mode="thread_local"):
        static_out = _as_tuple(fn(*static_in))
    torch.cuda.synchronize(device)
    return CapturedGraph(graph, fn, static_in, static_out, warmup_calls, t1 - t0,
                         time.perf_counter() - t1)


@register_backend("torch")
class TorchBackend(FilterBackend):
    # None: capture on CUDA, eager on the CPU.  A test may install a
    # function of the same signature as capture_graph.
    capture: Optional[Callable] = None
    # where models from files and bare callables live; None: conf's
    # [filter] torch_device
    pinned_device: Optional[str] = None
    # custom= keys the backend itself consumes; never passed to builders
    RESERVED_CUSTOM_KEYS = frozenset({"compile_cache", "donate"})

    def __init__(self):
        self.model: Optional[TorchModel] = None
        self.device: Optional[torch.device] = None
        self._out_spec: Optional[TensorsSpec] = None
        self._wrapper: Optional[Callable] = None
        self._stages: Any = None  # the wrapper's stage descriptors
        self._fingerprint: Optional[str] = None
        self._fn: Optional[Callable] = None  # what invoke runs
        self._graphs: "collections.OrderedDict[tuple, Any]" = collections.OrderedDict()
        self._entry = None  # the active capture, or None: eager
        # the negotiated spec, as the per-frame drift guard compares it:
        # ((torch.Size, torch.dtype), ...), or None before negotiation
        self._expected: Optional[tuple] = None
        # installed by a fused filter: rebuilds the wrapper for a drifted spec
        self._drift_hook: Optional[Callable] = None
        self._cache_size = DEFAULT_COMPILE_CACHE
        self.segment_label = ""
        self.stats = dict(captures=0, hits=0, evictions=0, replays=0, warmup_calls=0,
                          capture_s=0.0, warmup_s=0.0)

    def _file_device(self) -> str:
        return self.pinned_device or conf.get("filter", "torch_device")

    def open(self, model, custom: str = "") -> None:
        if isinstance(model, TorchModel):
            self.model = model
        elif isinstance(model, (str, os.PathLike)):
            self.model = self._load(os.fspath(model), custom)
        elif callable(model):
            dev = self._file_device()
            self.model = TorchModel(apply=model, device=dev) \
                if isinstance(model, torch.nn.Module) \
                else TorchModel(apply=lambda params, *xs: model(*xs), device=dev)
        else:
            raise TypeError(f"unsupported model object: {type(model)}")
        self.device = resolve_device(self.model.device)
        if self.pinned_device is not None and self.device.type != self.pinned_device:
            raise ValueError(f"{self.name}: the model lives on {self.device}, "
                             f"the backend is pinned to {self.pinned_device}")
        self._out_spec = self.model.output_spec
        try:
            self._cache_size = max(1, int(parse_custom(custom).get(
                "compile_cache", DEFAULT_COMPILE_CACHE)))
        except ValueError:
            self._cache_size = DEFAULT_COMPILE_CACHE
        self._graphs.clear()  # captures read the old model's tensors
        self.set_wrapper(self._wrapper, stages=self._stages)

    def _load(self, path: str, custom: str) -> TorchModel:
        """A model from a file: ``.py``, a params checkpoint, or TorchScript."""
        device = resolve_device(self._file_device())
        if path.endswith(".py"):
            return _load_py_model(path, custom)
        if path.endswith(".npz") or os.path.isdir(path):
            return _load_checkpoint_model(path, custom, self.RESERVED_CUSTOM_KEYS, device)
        if not os.path.isfile(path):
            raise ValueError(
                f"torch backend cannot load {path!r}; use a .py model file defining "
                "get_model(), a .npz params checkpoint with "
                "custom=\"builder=...\", a TorchScript file, or pass a TorchModel object")
        module = torch.jit.load(path, map_location=device)
        module.eval()
        return TorchModel(apply=module, name=os.path.basename(path), device=device)

    def close(self) -> None:
        self.model = None
        self._fn = None
        self._entry = None
        self._expected = None
        self._graphs.clear()

    def model_spec(self) -> Optional[TensorsSpec]:
        return self.model.input_spec if self.model is not None else None

    def output_spec(self) -> Optional[TensorsSpec]:
        """The output spec of the negotiated (or drifted-to) geometry."""
        return self._out_spec

    def reconfigure(self, in_spec: TensorsSpec) -> TensorsSpec:
        mine = self.model_spec()
        if mine is not None:
            merged = mine.intersect(in_spec)
            if merged is None:
                raise ValueError(
                    f"torch backend: stream spec {in_spec} incompatible with "
                    f"model spec {mine}"
                )
            in_spec = merged
        if not in_spec.tensors_fixed:
            in_spec = in_spec.fixate()
        self._out_spec = self.trace_output_spec(in_spec)
        self._select(in_spec)
        return self._out_spec

    def trace_output_spec(self, in_spec: TensorsSpec) -> TensorsSpec:
        """The bare model's output spec for a model input spec: the declared
        one, or else that of one trial run on zeros (no wrapper either way)."""
        if self.model.output_spec is not None:
            return self.model.output_spec
        with torch.inference_mode():
            xs = [torch.zeros(t.shape, dtype=torch_dtype(t.dtype), device=self.device)
                  for t in in_spec.tensors]
            return TensorsSpec.from_arrays(_as_tuple(self.model(*xs)))

    def set_wrapper(self, wrapper: Optional[Callable], stages: Any = None) -> None:
        """Install a fn → fn wrapper around the model call (None: the bare
        model), with ``stages``, the descriptors of what it runs (part of
        the capture key: a rebuild of the same chain selects its earlier
        captures, a changed chain captures afresh)."""
        self._wrapper = wrapper
        self._stages = stages
        self._fingerprint = None
        self._entry = None
        self._expected = None
        if wrapper is None:
            self._drift_hook = None
        if self.model is not None:
            self._fn = wrapper(self.model) if wrapper is not None else self.model

    def set_drift_hook(self, hook: Optional[Callable]) -> None:
        """Install the fused chain's rebinder: the filter passes a function
        of the drifted spec that rebuilds its wrapper and negotiates it
        (``TensorFilter._drift_reinstall``)."""
        self._drift_hook = hook

    def reconfigure_fused(self, raw_spec: TensorsSpec, out_spec: TensorsSpec) -> TensorsSpec:
        """Negotiate the wrapped function: it takes the raw stream spec and
        gives ``out_spec``, which the filter derived stage by stage; on
        CUDA this captures it (or selects its cached capture).  The
        model-spec check already ran against the fused pre-stages' output
        (``TensorFilter._install_fusion``)."""
        if not raw_spec.tensors_fixed:
            raw_spec = raw_spec.fixate()  # a None batch dim: 1 until frames come
        self._out_spec = out_spec
        self._select(raw_spec)
        return out_spec

    # -- captures -----------------------------------------------------------

    def _capture_fn(self) -> Optional[Callable]:
        if self.capture is not None:
            return self.capture
        return capture_graph if self.device.type == "cuda" else None

    def _key(self, in_spec: TensorsSpec) -> tuple:
        """The LRU key: the input spec, the segment label and the
        fingerprint of the function."""
        if self._fingerprint is None:
            self._fingerprint = exec_cache.fingerprint(
                [self._stages, self.model.name],
                self.model.apply if isinstance(self.model.apply, torch.nn.Module)
                else self.model.params)
        spec_key = tuple((numpy_dtype(t.dtype).str, tuple(t.shape)) for t in in_spec.tensors)
        return spec_key, self.segment_label, self._fingerprint

    def ensure_cache_capacity(self, n: int) -> None:
        """Grow the capture LRU to hold ``n`` entries, so that a warmed
        bucket ladder is not evicted by its own warmup (never shrinks)."""
        self._cache_size = max(self._cache_size, int(n))

    def warm_compile(self, in_spec: TensorsSpec) -> None:
        """Capture the bare function at ``in_spec`` into the LRU (or find
        it there) without changing the active entry: the warmup phase's
        work for a bucket (``graph/warmup.py``).  A fused filter warms
        through ``TensorFilter.warm_spec``, which rebuilds its wrapper."""
        if not in_spec.tensors_fixed:
            in_spec = in_spec.fixate()
        capture = self._capture_fn()
        if capture is None:
            return  # the CPU: nothing is captured
        active = next((k for k, e in self._graphs.items() if e is self._entry), None)
        self._lookup(in_spec, capture)
        if active is not None:
            self._graphs.move_to_end(active)

    def _lookup(self, in_spec: TensorsSpec, capture: Callable):
        """The LRU's entry for ``in_spec``, else a new capture (evicting the
        least recently used)."""
        key = self._key(in_spec)
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
            self.stats["hits"] += 1
            return entry
        try:
            entry = capture(self._fn, in_spec, self.device)
        except Exception as exc:  # noqa: BLE001 - any capture failure refuses the geometry
            raise NegotiationError(
                f"torch backend: model {self.model.name!r} cannot be captured as a CUDA "
                f"graph at {in_spec}: {_failing_op(exc)}: {type(exc).__name__}: {exc}"
            ) from exc
        self.stats["captures"] += 1
        self.stats["warmup_calls"] += getattr(entry, "warmup_calls", 0)
        self.stats["capture_s"] += getattr(entry, "capture_s", 0.0)
        self.stats["warmup_s"] += getattr(entry, "warmup_s", 0.0)
        self._graphs[key] = entry
        while len(self._graphs) > self._cache_size:
            self._graphs.popitem(last=False)
            self.stats["evictions"] += 1
        return entry

    def _select(self, in_spec: TensorsSpec) -> None:
        """Point ``invoke`` at the capture for ``in_spec`` (:meth:`_lookup`).
        The spec becomes the drift guard's only once that succeeded: after
        a failed capture no frame runs uncaptured."""
        expected = tuple((torch.Size(t.shape), torch_dtype(t.dtype)) for t in in_spec.tensors)
        capture = self._capture_fn()
        self._entry = self._lookup(in_spec, capture) if capture is not None else None
        self._expected = expected

    def eager(self, *tensors) -> Tuple:
        """The function ``invoke`` replays, called eagerly (a reference)."""
        return _as_tuple(self._fn(*[wait_ready(t).to(self.device) for t in tensors]))

    def _drifted(self, tensors: Tuple) -> bool:
        exp = self._expected
        if len(tensors) != len(exp):
            return True
        for t, (shape, dtype) in zip(tensors, exp):
            if t.shape != shape or t.dtype != dtype:
                return True
        return False

    def _rebind(self, tensors: Tuple) -> None:
        """A frame whose shape or dtype drifted without a caps event, or
        came before any negotiation: a bare model is reconfigured for it; a
        wrapped function is rebuilt by its filter (the fused stages bake
        the old geometry)."""
        drifted = TensorsSpec.from_arrays(tensors)
        if self._wrapper is None:
            self.reconfigure(drifted)
        elif self._drift_hook is None:
            raise ValueError(f"torch backend: input drifted to {drifted} but the fused "
                             "function cannot rebind without its filter (no drift hook "
                             "installed)")
        else:
            self._drift_hook(drifted)

    def invoke(self, tensors: Tuple) -> Tuple:
        """Run the function on a frame's tensors, which the filter's
        dispatch has already waited for (``graph/node.py``)."""
        if self._expected is None or self._drifted(tensors):
            self._rebind(tensors)
        if self._entry is not None:
            self.stats["replays"] += 1
            return self._entry.run(tensors)
        return _as_tuple(self._fn(*[t.to(self.device) for t in tensors]))


@register_backend("torch-cpu")
class TorchCpuBackend(TorchBackend):
    """``framework=torch-cpu``: the torch backend pinned to the CPU."""

    pinned_device = "cpu"
