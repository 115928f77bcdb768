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

Every capture-LRU event is accounted in the device lane
(``obs/device.py`` :func:`record_compile`, with the JAX package's metric
names: a capture is a ``miss``, a cached capture selected again a ``hit``,
an entry aged out an ``evict``), and each capture's cost goes to the
utilization lane's registry (``obs/util.py``): its FLOPs, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the first of the eager
warm-up calls that precede the capture (operations without a FLOP formula,
the port's own kernels among them, count nothing), a lower bound of its
bytes, the parameters, inputs and outputs each once, and its memory
footprint (``obs/device.py`` :func:`memory_info`: the parameters, the
static inputs and outputs, and the graph's private memory pool,
:func:`pool_bytes`), which the deep-profiling lane's
memory ledger reads (``obs/profiler.py``).  :meth:`TorchBackend.cost_key`
names the active capture's entry for the device tracer.

A ``backend_compile`` fault (``faults/``, ``compile_raise``) is consulted
whenever a geometry is selected, before any capture and never inside
``torch.cuda.graph``, so an injected raise never leaves a stream
capturing.  There is no CPU fallback: the fault goes to the node's restart
policy, or fails the pipeline.

Transform fusion and whole-segment compilation (``graph/optimize.py``,
``graph/segments.py``) install a wrapper (:meth:`TorchBackend.set_wrapper`):
a function of the model call that runs the fused pre-stages, the model and
the fused post-stages (a decoder's device head among them) in one call, so
one replay takes a frame from its raw stream tensors to the filter's last
output.  ``segment_label`` names the folded region.

With the dispatch mesh (``[mesh] spec`` / ``NNSTPU_MESH=dp:4``,
``parallel/mesh.py``) a geometry whose every leading dim divides the mesh
is dispatched batch-sharded (``backends/sharded.py``): each shard of the
batch runs on its mesh device, captured as one graph a shard (with a
segment a collective, such as the int8 head's batch-wide scale), and the
outputs are joined on the mesh's first device; a geometry that does not
divide takes the single-device capture, as in the reference.  Captures are
keyed by the mesh too.  ``framework=torch-sharded`` with
``custom="devices=N,axis=dp"`` is the per-filter spelling, the counterpart
of ``jax-sharded``: its mesh wins over the global one and it shards every
geometry.  On the CPU a sharded dispatch runs the shards eagerly.

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
import contextlib
import copy
import dataclasses
import gc
import importlib
import importlib.util
import os
import threading
import time
import traceback
from typing import Any, Callable, Optional, Tuple

import torch

from .. import faults as _faults
from ..conf import conf
from ..device import resolve_device
from ..graph.node import NegotiationError
from ..obs.launch_gate import launching
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
    spec when known, and the device the params live on.  ``capturable``
    False: the function runs eagerly on the card, never captured (a model
    whose mesh spans more than one card, ``parallel/mesh.on_one_device``)."""

    apply: Callable
    params: Any = None
    input_spec: Optional[TensorsSpec] = None
    output_spec: Optional[TensorsSpec] = None
    name: str = "torch_model"
    device: Any = "cuda"
    capturable: bool = True

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

    def __init__(self, graph, fn, static_in, static_out, warmup_calls, warmup_s, capture_s,
                 flops=None, pool_bytes=None):
        self.graph = graph
        self.fn = fn
        self.static_in = static_in
        self.static_out = static_out
        self.warmup_calls = warmup_calls
        self.warmup_s = warmup_s
        self.capture_s = capture_s
        self.flops = flops  # FLOPs of one call, counted over the first warm-up call
        self.pool_bytes = pool_bytes  # what the graph's private memory pool reserved

    def run(self, xs) -> Tuple:
        for s, x in zip(self.static_in, xs):
            if x.shape != s.shape or x.dtype != s.dtype:
                raise ValueError(f"captured for {s.dtype}{tuple(s.shape)}, "
                                 f"got {x.dtype}{tuple(x.shape)}")
            s.copy_(x, non_blocking=True)
        with launching():
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


_gc_lock = threading.Lock()
_gc_holds = 0
_gc_was_enabled = False


@contextlib.contextmanager
def gc_paused():
    """No automatic garbage collection while a CUDA graph captures (ROADMAP
    C24).  A collection that runs on the capturing thread may free a dead
    pipeline's CUDA graph in a reference cycle; destroying a graph is not
    permitted while a stream captures, and the capture is invalidated.  The
    collector is switched off while any thread captures and on again after
    the last capture (if it was on); the garbage waits for the next
    collection."""
    global _gc_holds, _gc_was_enabled
    with _gc_lock:
        if _gc_holds == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_enabled:
                gc.enable()


def capture_calls(fn: Callable[[], Any], device: torch.device,
                  warmup_calls: int = WARMUP_CALLS, inference: bool = True):
    """``fn()`` captured on ``device`` as one CUDA graph over the tensors it
    reads, after ``warmup_calls`` eager calls on a side stream.  Returns
    the graph, the captured call's outputs (each replay rewrites them), and
    the warm-up's and the capture's wall seconds.  ``inference=False`` runs
    the calls outside
    ``torch.inference_mode``, for a function that takes gradients (the
    trainer's step, ``training.py``).

    ``capture_error_mode="thread_local"``: the capture refuses an unsafe
    call (a host synchronization) from this thread, but not the upload's
    copies on the source's thread, should a caps change or a drifted frame
    re-capture while the pipeline plays.  The capture synchronizes the
    whole device (``torch.cuda.graph`` does so on entry): it waits for the
    upload's copies already issued, but cannot deadlock against them, since
    those copies wait on nothing of the filter's and the upload's thread
    takes no lock that the filter's thread holds."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    mode = torch.inference_mode if inference else contextlib.nullcontext
    t0 = time.perf_counter()
    with mode(), torch.cuda.stream(side):
        for _ in range(warmup_calls):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with gc_paused(), mode(), torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn()
    torch.cuda.synchronize(device)
    return graph, out, t1 - t0, time.perf_counter() - t1


def pool_bytes(graph, device: torch.device) -> Optional[int]:
    """The bytes the caching allocator holds in ``graph``'s private memory
    pool (its segments in ``torch.cuda.memory_snapshot``), or None where
    that cannot be read (no card)."""
    if device.type != "cuda":
        return None
    try:
        pool = tuple(graph.pool())
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
    except (AttributeError, KeyError, RuntimeError, TypeError):
        return None


def capture_graph(fn: Callable, in_spec: TensorsSpec, device: torch.device,
                  warmup_calls: int = WARMUP_CALLS) -> CapturedGraph:
    """Capture ``fn`` at ``in_spec`` on ``device`` as one CUDA graph, zeros
    as its static inputs (:func:`capture_calls`).  The first warm-up call
    runs under ``FlopCounterMode``: the entry's ``flops``."""
    from torch.utils.flop_counter import FlopCounterMode

    static_in = tuple(torch.zeros(t.shape, dtype=torch_dtype(t.dtype), device=device)
                      for t in in_spec.tensors)
    counted = []

    def call():
        if warmup_calls and not counted:
            with FlopCounterMode(display=False) as counter:
                out = _as_tuple(fn(*static_in))
            counted.append(counter.get_total_flops())
            return out
        return _as_tuple(fn(*static_in))

    graph, static_out, warmup_s, capture_s = capture_calls(call, device, warmup_calls)
    return CapturedGraph(graph, fn, static_in, static_out, warmup_calls, warmup_s, capture_s,
                         flops=counted[0] if counted else None,
                         pool_bytes=pool_bytes(graph, device))


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` with no index is the current
    card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == (b.index if b.index is not None else cur)


def _to_device(obj, device: torch.device):
    """A params tree's copy on ``device``: tensors moved, containers and
    dataclass leaves (``QuantizedWeight``) rebuilt, anything else kept."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _to_device(getattr(obj, f.name), device)
                                          for f in dataclasses.fields(obj)})
    return obj


def _nbytes(obj) -> int:
    """Bytes of every tensor in a params tree (dicts, lists, tuples,
    objects with attributes, ``nn.Module`` state)."""
    if isinstance(obj, torch.nn.Module):
        obj = obj.state_dict()
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    if hasattr(obj, "__dict__") and not callable(obj):
        return _nbytes(vars(obj))
    return 0


@register_backend("torch")
class TorchBackend(FilterBackend):
    # None: capture on CUDA, eager on the CPU.  A test may install a
    # function of the same signature as capture_graph (and, for a sharded
    # geometry, one of the signature of sharded.capture_sharded).
    capture: Optional[Callable] = None
    capture_sharded: Optional[Callable] = None
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
        self._cost_keys: dict = {}  # LRU key -> cost registry key
        self._hbm: dict = {}  # LRU key -> its capture's memory record on that entry
        self._cost_key: Optional[str] = None  # the active capture's
        # the dispatch mesh of the active geometry (None: one device), its
        # batch axis, the function's replica a mesh device, and the last
        # dispatch's shards: [(label, [(begin, end) event pairs] or None)]
        self._mesh = None
        self._mesh_axis = "dp"
        self._replicas: dict = {}
        self.last_shards: Optional[list] = None

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
        self._drop_graphs()  # captures read the old model's tensors
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
        self._mesh = None
        self._replicas = {}
        self.last_shards = None
        self._drop_graphs()  # the graphs and their private memory pools go
        self._cost_key = None

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
        self._replicas = {}
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

    def defer_fused(self, out_spec: TensorsSpec, hook: Callable) -> TensorsSpec:
        """Negotiate a fused function whose raw input spec no one knows
        before the first frame (a self-describing stream: ``tensor_converter
        input-format=protobuf``): nothing is captured now, and the first
        frame's spec goes to ``hook``, which builds the wrapper for it and
        captures it, as for a drifted frame."""
        self.set_wrapper(None)
        self._drift_hook = hook
        self._out_spec = out_spec
        return out_spec

    # -- captures -----------------------------------------------------------

    def _capture_fn(self) -> Optional[Callable]:
        if not getattr(self.model, "capturable", True):
            return None
        if self.capture is not None:
            return self.capture
        return capture_graph if self.device.type == "cuda" else None

    def _key(self, in_spec: TensorsSpec, mesh=None) -> tuple:
        """The LRU key: the input spec, the segment label, the fingerprint
        of the function and the mesh (``parallel/mesh.mesh_cache_key``)."""
        from ..parallel.mesh import mesh_cache_key

        if self._fingerprint is None:
            self._fingerprint = exec_cache.fingerprint([self._stages, self.model.name],
                                                       self._param_tree())
        spec_key = tuple((numpy_dtype(t.dtype).str, tuple(t.shape)) for t in in_spec.tensors)
        return spec_key, self.segment_label, self._fingerprint, mesh_cache_key(mesh)

    # -- sharded dispatch over the mesh ------------------------------------------

    def _mesh_config(self):
        """``(mesh, axis)`` this backend shards dispatch over, or ``(None,
        axis)``: the process-wide dispatch mesh (``parallel/mesh.py``), when
        it lies on the model's kind of device."""
        from ..parallel.mesh import dispatch_mesh, dispatch_mesh_axis

        mesh = dispatch_mesh()
        if mesh is None or self.device is None \
                or mesh.devices.flat[0].type != self.device.type:
            return None, "dp"
        return mesh, dispatch_mesh_axis()

    def mesh_devices(self) -> int:
        """The device count of this backend's dispatch mesh (1: unsharded);
        the batch elements and the query server size their buckets in
        per-shard multiples of it (``graph/residency.consumer_mesh_devices``)."""
        mesh, _ = self._mesh_config()
        return mesh.size if mesh is not None else 1

    def _shard_this_compile(self, in_spec: TensorsSpec, mesh) -> bool:
        """Shard a geometry only where every tensor's leading dim divides
        the mesh: the batch elements emit such batches; any other (a
        bucket of 1 on a 4-mesh, a scalar) takes the single-device
        capture."""
        for t in in_spec.tensors:
            if t.rank < 1 or not t.shape or t.shape[0] is None:
                return False
            if t.shape[0] == 0 or t.shape[0] % mesh.size:
                return False
        return True

    def _wire_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The wire shape ``tensor_upload`` copies a tensor in: its own
        shape, with or without a mesh (the JAX package flattens for the
        TPU's transfer layout, which the card does not need)."""
        return tuple(shape)

    def wire_input_sharding(self, idx: int = 0):
        """The placement of input ``idx`` for ``tensor_upload``: the batch
        sharding over the active mesh, or None for one device."""
        if self._mesh is None or self._expected is None or idx >= len(self._expected):
            return None
        from ..parallel.mesh import batch_sharding

        return batch_sharding(self._mesh, len(self._expected[idx][0]), self._mesh_axis)

    def _shard_devices(self, mesh=None) -> list:
        return (mesh or self._mesh).axis_devices(self._mesh_axis)

    def _replica(self, device: torch.device) -> Callable:
        """The function on ``device``: the model's own there, else a copy of
        its params on ``device`` under the same wrapper."""
        if _same_device(device, self.device):
            return self._fn
        fn = self._replicas.get(str(device))
        if fn is None:
            apply = self.model.apply
            if isinstance(apply, torch.nn.Module):
                apply = copy.deepcopy(apply).to(device)
            model = dataclasses.replace(self.model, apply=apply, device=device,
                                        params=_to_device(self.model.params, device))
            fn = self._wrapper(model) if self._wrapper is not None else model
            self._replicas[str(device)] = fn
        return fn

    def _shard_spec(self, in_spec: TensorsSpec, n: int) -> TensorsSpec:
        from ..spec import TensorSpec

        return TensorsSpec(tensors=tuple(
            TensorSpec(dtype=t.dtype, shape=(t.shape[0] // n,) + tuple(t.shape[1:]))
            for t in in_spec.tensors), rate=in_spec.rate)

    def _capture_sharded_fn(self) -> Optional[Callable]:
        if not getattr(self.model, "capturable", True):
            return None
        if self.capture_sharded is not None:
            return self.capture_sharded
        if self.device.type != "cuda":
            return None
        from .sharded import capture_sharded

        return capture_sharded

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
        mesh = self._geometry_mesh(in_spec)
        make = self._capture_maker(in_spec, mesh)
        if make is None:
            return  # the CPU: nothing is captured
        active = next((k for k, e in self._graphs.items() if e is self._entry), None)
        self._lookup(in_spec, make, mesh)
        if active is not None:
            self._graphs.move_to_end(active)

    def _geometry_mesh(self, in_spec: TensorsSpec):
        """The mesh ``in_spec`` is dispatched over, or None."""
        mesh, axis = self._mesh_config()
        if mesh is not None and not self._shard_this_compile(in_spec, mesh):
            return None
        self._mesh_axis = axis
        return mesh

    def _capture_maker(self, in_spec: TensorsSpec, mesh) -> Optional[Callable]:
        """A thunk that captures ``in_spec`` (over ``mesh``, a graph a
        shard), or None where nothing is captured (the CPU)."""
        if mesh is None:
            capture = self._capture_fn()
            if capture is None:
                return None
            return lambda: capture(self._fn, in_spec, self.device)
        capture = self._capture_sharded_fn()
        if capture is None:
            return None
        devs = self._shard_devices(mesh)
        return lambda: capture([self._replica(d) for d in devs],
                               self._shard_spec(in_spec, len(devs)), devs)

    def _lookup(self, in_spec: TensorsSpec, make: Callable, mesh=None):
        """The LRU's entry for ``in_spec`` over ``mesh``, else a new capture
        (evicting the least recently used); each event accounted in the
        device lane."""
        from ..obs.device import memory_info, record_compile

        key = self._key(in_spec, mesh)
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
            self.stats["hits"] += 1
            record_compile(self, key, "hit")
            return entry
        t0 = time.perf_counter_ns()
        try:
            entry = make()
        except Exception as exc:  # noqa: BLE001 - any capture failure refuses the geometry
            raise NegotiationError(
                f"torch backend: model {self.model.name!r} cannot be captured as a CUDA "
                f"graph at {in_spec}: {_failing_op(exc)}: {type(exc).__name__}: {exc}"
            ) from exc
        dur_ns = time.perf_counter_ns() - t0
        self.stats["captures"] += 1
        self.stats["warmup_calls"] += getattr(entry, "warmup_calls", 0)
        self.stats["capture_s"] += getattr(entry, "capture_s", 0.0)
        self.stats["warmup_s"] += getattr(entry, "warmup_s", 0.0)
        self._graphs[key] = entry
        info = self._cost_info(in_spec, entry)
        hbm = memory_info(entry, _nbytes(self._param_tree()))
        self._cost_keys[key] = self._register_cost(key, in_spec, info, hbm,
                                                   mesh.size if mesh is not None else 1)
        self._hbm[key] = hbm
        while len(self._graphs) > self._cache_size:
            evicted, _ = self._graphs.popitem(last=False)
            self._release(evicted)
            self.stats["evictions"] += 1
            record_compile(self, evicted, "evict")
        record_compile(self, key, "miss", dur_ns, info)
        return entry

    def _release(self, key) -> None:
        """``key``'s capture is gone: its memory leaves the ledger
        (``obs/util.release_hbm``)."""
        from ..obs import util as _obs_util

        fp = self._cost_keys.pop(key, None)
        hbm = self._hbm.pop(key, None)
        if fp is not None:
            _obs_util.release_hbm(fp, hbm)

    def _drop_graphs(self) -> None:
        self._graphs.clear()
        for key in list(self._cost_keys):
            self._release(key)

    def _cost_info(self, in_spec: TensorsSpec, entry) -> dict:
        """A capture's cost: the FLOPs of one call (``entry.flops``, counted
        over its first warm-up call) and a lower bound of the bytes it
        moves, the parameters, the inputs and the outputs each once (the
        activations in between are not counted)."""
        info = {}
        flops = getattr(entry, "flops", None)
        if flops:
            info["flops"] = float(flops)
        nbytes = _nbytes(self._param_tree())
        nbytes += sum(t.nbytes for t in in_spec.tensors)
        nbytes += _nbytes(list(getattr(entry, "static_out", ())))
        if nbytes:
            info["bytes"] = float(nbytes)
        return info

    def _param_tree(self):
        """What the model's parameters are: its module, or its params tree."""
        return self.model.apply if isinstance(self.model.apply, torch.nn.Module) \
            else self.model.params

    def _register_cost(self, key, in_spec: TensorsSpec, info: dict,
                       hbm: Optional[dict] = None, devices: int = 1) -> str:
        """Register a capture's cost with the utilization lane
        (``obs/util.py``) under a per-process fingerprint, and return the
        key.  ``hbm`` is the graph's memory footprint
        (``obs/device.py`` :func:`memory_info`), kept on the same registry
        entry: the deep-profiling lane's memory ledger and
        ``nnstpu_executable_hbm_bytes`` read it there.  A cost-less capture
        registers too: its dispatches read ``mfu=None`` instead of
        vanishing."""
        from ..obs import util as _obs_util

        bucket = 0
        if in_spec.tensors and in_spec.tensors[0].shape:
            bucket = int(in_spec.tensors[0].shape[0] or 0)
        name = self.model.name
        if self.segment_label:
            name = f"{name}+{self.segment_label}"
        fp = f"{name}:{hash(key) & 0xffffffffffff:012x}"
        return _obs_util.register_cost(fp, flops=info.get("flops"), bytes=info.get("bytes"),
                                       bucket=bucket, model=name, devices=devices, hbm=hbm)

    def cost_key(self) -> Optional[str]:
        """The active capture's cost fingerprint (the device tracer reads it
        at dispatch time, on the invoking thread)."""
        return self._cost_key

    def _select(self, in_spec: TensorsSpec) -> None:
        """Point ``invoke`` at the capture for ``in_spec`` (:meth:`_lookup`).
        The spec becomes the drift guard's only once that succeeded: after
        a failed capture no frame runs uncaptured."""
        if _faults.enabled:
            # chaos point "backend_compile" (compile_raise), before any
            # capture: the stream is never left capturing
            _faults.maybe_compile(f"{self.name}:{self.model.name}")
        expected = tuple((torch.Size(t.shape), torch_dtype(t.dtype)) for t in in_spec.tensors)
        mesh = self._geometry_mesh(in_spec)
        make = self._capture_maker(in_spec, mesh)
        self._entry = self._lookup(in_spec, make, mesh) if make is not None else None
        self._mesh = mesh
        self._cost_key = self._cost_keys.get(self._key(in_spec, mesh)) \
            if self._entry is not None else None
        self._expected = expected

    def _eager_sharded(self, tensors, mesh=None) -> Tuple:
        """One sharded call of the function, eagerly (``sharded.run_eager``)."""
        from .sharded import run_eager

        devs = self._shard_devices(mesh)
        outs, _ = run_eager([self._replica(d) for d in devs], tensors, devs)
        return outs

    def eager(self, *tensors) -> Tuple:
        """The function ``invoke`` replays, called eagerly (a reference): over
        the mesh's shards where the tensors' geometry is dispatched sharded."""
        tensors = [wait_ready(t).to(self.device) for t in tensors]
        mesh = self._geometry_mesh(TensorsSpec.from_arrays(tensors))
        if mesh is not None:
            return self._eager_sharded(tensors, mesh)
        return _as_tuple(self._fn(*tensors))

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
        came before any negotiation: a wrapped (or deferred) function is
        rebuilt by its filter (the fused stages bake the old geometry); a
        bare model is reconfigured for it."""
        drifted = TensorsSpec.from_arrays(tensors)
        if self._drift_hook is not None:
            self._drift_hook(drifted)
        elif self._wrapper is None:
            self.reconfigure(drifted)
        else:
            raise ValueError(f"torch backend: input drifted to {drifted} but the fused "
                             "function cannot rebind without its filter (no drift hook "
                             "installed)")

    def invoke(self, tensors: Tuple) -> Tuple:
        """Run the function on a frame's tensors, which the filter's
        dispatch has already waited for (``graph/node.py``)."""
        if self._expected is None or self._drifted(tensors):
            self._rebind(tensors)
        self.last_shards = None
        if self._mesh is not None:
            return self._invoke_sharded(tensors)
        if self._entry is not None:
            self.stats["replays"] += 1
            return self._entry.run(tensors)
        return _as_tuple(self._fn(*[t.to(self.device) for t in tensors]))

    def _invoke_sharded(self, tensors: Tuple) -> Tuple:
        """A sharded dispatch: the shards' graphs replayed (the card) or the
        shards run eagerly (the CPU); ``last_shards`` names each shard's
        device and, while the device tracer times dispatches, its event
        pairs."""
        from ..obs.device import event_timing

        labels = self._mesh.axis_labels(self._mesh_axis)
        if self._entry is not None:
            self.stats["replays"] += 1
            timing = event_timing()
            outs = self._entry.run(tensors, timing=timing)
            events = self._entry.last_shard_events if timing else None
            self.last_shards = [(lb, events[i] if events else None)
                                for i, lb in enumerate(labels)]
            return outs
        outs = self._eager_sharded([t.to(self.device) for t in tensors])
        self.last_shards = [(lb, None) for lb in labels]
        return outs


@register_backend("torch-cpu")
class TorchCpuBackend(TorchBackend):
    """``framework=torch-cpu``: the torch backend pinned to the CPU."""

    pinned_device = "cpu"


@register_backend("torch-sharded")
class TorchShardedBackend(TorchBackend):
    """Batch-sharded on the filter's own mesh: ``custom="devices=4,axis=dp"``
    splits the leading dim of every input over a 1-D mesh of the first
    ``devices`` devices (default: all of them).  The counterpart of
    ``jax-sharded``: this mesh wins over the process-wide one, and every
    geometry is sharded (one that does not divide raises)."""

    RESERVED_CUSTOM_KEYS = TorchBackend.RESERVED_CUSTOM_KEYS | {"devices", "axis"}

    def __init__(self):
        super().__init__()
        self._custom: dict = {}
        self._own_mesh = None

    def open(self, model, custom: str = "") -> None:
        self._custom = parse_custom(custom)
        self._own_mesh = None
        super().open(model, custom)

    def _mesh_config(self):
        from ..parallel.mesh import make_mesh, visible_devices

        axis = self._custom.get("axis", "dp")
        if self._own_mesh is None:
            n = int(self._custom.get("devices", len(visible_devices())))
            self._own_mesh = make_mesh((n,), (axis,))
        return self._own_mesh, axis

    def _shard_this_compile(self, in_spec: TensorsSpec, mesh) -> bool:
        del in_spec, mesh
        return True  # the filter asked for this mesh
