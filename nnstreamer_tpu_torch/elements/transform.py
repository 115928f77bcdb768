"""``tensor_transform``: element-wise and layout ops on tensor streams.

The port of the JAX package's element, with its six modes:

- ``typecast``   — option = target dtype name.
- ``arithmetic`` — option = chain ``[typecast:T,]add:V|sub:V|mul:V|div:V...``.
- ``transpose``  — option = NNS innermost-first permutation ``a:b:c:d``.
- ``dimchg``     — option = ``from:to`` NNS dim move.
- ``stand``      — option = ``default`` | ``default:per-channel``.
- ``clamp``      — option = ``min:max``.

The element hands its output on its ``device`` (the card unless
``device="cpu"``).  ``acceleration="pallas"`` (the JAX element's name for
its kernel path; ``"orc"`` is accepted too) runs the elementwise modes
(typecast, arithmetic, clamp) through the hand-written ``fused_arith``
kernel, once per frame, on that device; ``acceleration=true`` runs every
mode as plain torch there, under the JAX (jit) rules.
``acceleration=false`` is the JAX element's host rule: numpy on the host
(:meth:`TensorTransform.host_fn`), with numpy's promotion (float64
intermediates, true division, float-to-int casts that wrap through int32
as x86 does them), then a cast to the negotiated dtype.

A transform with ``acceleration`` set (``"pallas"`` or true) folds into an
adjacent ``tensor_filter`` when the pipeline starts (``graph/optimize.py``):
:meth:`TensorTransform.build_fn` and :meth:`TensorTransform.out_spec_for`
are the fused-stage protocol the filter calls, so a folded ``"pallas"``
transform still launches ``fused_arith`` once per frame, on the filter's
device.

Literal binding and the negotiated output dtype follow the JAX rules
(``_bind_chain``, :func:`~nnstreamer_tpu_torch.ops.kernels.chain_out_dtype`),
not torch's promotion.  bfloat16 streams take all three: ``"pallas"``
through the kernel, ``true`` through the plain chain, each step rounded to
bfloat16 as XLA rounds it; ``false`` through the JAX element's numpy rule
as numpy runs it on ``ml_dtypes``' bfloat16, which the card does not have:
a bfloat16 array is held as float32 values, an op on it with a literal
gives float32 (as numpy promotes ``ml_dtypes``' bfloat16 with a Python
scalar), and a cast to bfloat16 rounds a float32 to nearest even (an int
or a double through float32 first, as ``ml_dtypes`` casts).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..buffer import Frame
from ..device import resolve_device
from ..graph.node import NegotiationError, Node, Pad
from ..graph.registry import register_element
from ..ops.kernels import (bf16_round, chain_out_dtype, fused_arith, fused_arith_plan,
                           plan_chain, run_chain, to_canonical)
from ..spec import (BFLOAT16, NNS_TENSOR_RANK_LIMIT, TensorSpec, TensorsSpec, dtype_from_name,
                    numpy_dtype)
from ..utils.props import parse_bool

MODES = ("typecast", "arithmetic", "transpose", "dimchg", "stand", "clamp")


def _parse_arith_ops(option: str) -> List[Tuple[str, object]]:
    """Parse 'typecast:float32,add:-127.5,div:127.5' into an op chain."""
    ops: List[Tuple[str, object]] = []
    for part in option.split(","):
        part = part.strip()
        if not part:
            continue
        op, _, val = part.partition(":")
        op = op.strip().lower()
        if op == "typecast":
            ops.append(("typecast", dtype_from_name(val)))
        elif op in ("add", "sub", "mul", "div"):
            # integer literals stay integral so int streams keep their dtype
            try:
                num: object = int(val)
            except ValueError:
                num = float(val)
            ops.append((op, num))
        else:
            raise ValueError(f"unknown arithmetic op {op!r} in {option!r}")
    if not ops:
        raise ValueError(f"empty arithmetic option: {option!r}")
    return ops


def _parse_clamp(option: str) -> Tuple[object, object]:
    lo_s, _, hi_s = option.partition(":")

    def num(s: str) -> object:
        try:
            return int(s)
        except ValueError:
            return float(s)

    return num(lo_s), num(hi_s)


def _bind_num(v: object, dtype: np.dtype) -> object:
    """Keep an integer literal integral only when the current stream dtype
    can hold it; otherwise demote it to float so the op promotes."""
    if isinstance(v, int) and dtype.kind in ("i", "u"):
        info = np.iinfo(dtype)
        if info.min <= v <= info.max:
            return v
        return float(v)
    return v


def _bind_chain(ops: List[Tuple[str, object]], in_dtype) -> List[Tuple[str, object]]:
    """Bind op literals to the dtype flowing through the chain."""
    cur = numpy_dtype(in_dtype)
    bound: List[Tuple[str, object]] = []
    for op, val in ops:
        if op == "typecast":
            bound.append((op, val))
        elif op == "clamp":
            lo, hi = val
            bound.append((op, (_bind_num(lo, cur), _bind_num(hi, cur))))
        else:
            bound.append((op, _bind_num(val, cur)))
        cur = chain_out_dtype(cur, [bound[-1]])
    return bound


@register_element("tensor_transform")
class TensorTransform(Node):
    def __init__(
        self,
        name: Optional[str] = None,
        mode: str = "typecast",
        option: str = "",
        acceleration: bool = True,
        device="cuda",
    ):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        if mode not in MODES:
            raise ValueError(f"unknown transform mode {mode!r}; known: {MODES}")
        self.mode = mode
        self.option = str(option)
        if acceleration in ("pallas", "orc"):
            self.acceleration = "pallas"
        else:
            self.acceleration = parse_bool(acceleration, name="acceleration")
        self.device = resolve_device(device)
        self._fns: Optional[List[Callable]] = None  # per tensor: torch, or numpy on the host

    def _chain_ops(self, t: TensorSpec):
        """Bound elementwise chain, or None for the shape-changing modes."""
        if self.mode == "typecast":
            return [("typecast", dtype_from_name(self.option))]
        if self.mode == "arithmetic":
            return _bind_chain(_parse_arith_ops(self.option), t.dtype)
        if self.mode == "clamp":
            return _bind_chain([("clamp", _parse_clamp(self.option))], t.dtype)
        return None

    def out_spec_for(self, t: TensorSpec) -> TensorSpec:
        """Output spec for a fixed input tensor spec."""
        if self.mode == "typecast":
            return TensorSpec(dtype=dtype_from_name(self.option), shape=t.shape)
        if self.mode in ("arithmetic", "clamp"):
            return TensorSpec(dtype=chain_out_dtype(t.dtype, self._chain_ops(t)),
                              shape=t.shape)
        if self.mode == "transpose":
            perm = [int(x) for x in self.option.split(":")]
            if sorted(perm) != list(range(len(perm))):
                raise NegotiationError(f"bad transpose option {self.option!r}")
            nns = list(t.nns_dims)
            out_nns = [nns[p] for p in perm]
            while len(out_nns) > 1 and out_nns[-1] == 1:
                out_nns.pop()
            return TensorSpec(dtype=t.dtype, shape=tuple(reversed(out_nns)))
        if self.mode == "dimchg":
            frm, _, to = self.option.partition(":")
            nns = list(t.nns_dims)
            d = nns.pop(int(frm))
            nns.insert(int(to), d)
            while len(nns) > 1 and nns[-1] == 1:
                nns.pop()
            return TensorSpec(dtype=t.dtype, shape=tuple(reversed(nns)))
        if self.mode == "stand":
            return TensorSpec(dtype=np.float32, shape=t.shape)
        raise AssertionError(self.mode)

    def describe(self, t: TensorSpec) -> tuple:
        """What :meth:`build_fn` computes for ``t``, as a fused stage's part
        of the filter's capture key: the mode and option, and for a
        ``fused_arith`` chain the program the host lowered."""
        chain = self._chain_ops(t)
        program = None
        if chain is not None and self.acceleration == "pallas":
            program = fused_arith_plan(t.dtype, chain).program
        return ("tensor_transform", self.mode, self.option, self.acceleration,
                str(t.dtype), program)

    def build_fn(self, t: TensorSpec) -> Callable[[torch.Tensor], torch.Tensor]:
        """The per-tensor function for a fixed input spec.  As under JAX
        with x64 disabled, a 64-bit input is wrapped to 32 bits on entry and
        a 64-bit result is its 32-bit dtype (ROADMAP C12): the frames then
        carry a spec other than the negotiated one, and the src pad
        renegotiates downstream, as the JAX element's does."""
        chain = self._chain_ops(t)
        if chain is not None:
            if self.acceleration == "pallas":
                # one fused_arith launch per frame on a CUDA tensor, here or
                # folded into a filter
                return lambda x: fused_arith(x.contiguous(), chain)
            plan = plan_chain(t.dtype, tuple(chain), promote=False)
            return lambda x: run_chain(x, plan)
        fn = self._shape_fn(t)
        return lambda x: fn(to_canonical(x))

    def _shape_fn(self, t: TensorSpec) -> Callable[[torch.Tensor], torch.Tensor]:
        """The function of a shape-changing mode (transpose, dimchg, stand)."""
        r = NNS_TENSOR_RANK_LIMIT
        pad_shape = tuple(reversed(t.nns_dims))  # rank-4 numpy-order view
        out_shape = self.out_spec_for(t).shape
        if self.mode == "transpose":
            perm = [int(x) for x in self.option.split(":")]
            np_perm = tuple(r - 1 - perm[r - 1 - j] for j in range(r))
            return lambda x: x.reshape(pad_shape).permute(np_perm).reshape(out_shape)
        if self.mode == "dimchg":
            frm_s, _, to_s = self.option.partition(":")
            src_ax, dst_ax = r - 1 - int(frm_s), r - 1 - int(to_s)
            return lambda x: torch.movedim(x.reshape(pad_shape), src_ax, dst_ax).reshape(out_shape)
        per_channel = self.option.endswith("per-channel")  # stand

        def stand(x):
            x = x.to(torch.float32)
            if per_channel and x.dim() >= 2:
                axes = tuple(range(x.dim() - 1))
                mean = x.mean(dim=axes, keepdim=True)
                std = x.std(dim=axes, keepdim=True, correction=0)
            else:
                mean, std = x.mean(), x.std(correction=0)
            return (x - mean) / (std + 1e-10)

        return stand

    def host_fn(self, t: TensorSpec) -> Callable[[np.ndarray], np.ndarray]:
        """The ``acceleration=false`` function for a fixed input spec: the
        JAX element's numpy rule on a host array, cast at the end to the
        negotiated dtype.  A bfloat16 array is its float32 values."""
        mode, option = self.mode, self.option
        out_dtype = self.out_spec_for(t).dtype
        r = NNS_TENSOR_RANK_LIMIT
        pad_shape = tuple(reversed(t.nns_dims))
        out_rank = len(self.out_spec_for(t).shape)
        if mode in ("typecast", "arithmetic", "clamp"):
            chain = self._chain_ops(t)

            def fn(x):
                for op, val in chain:
                    if op == "typecast":
                        x = _astype(x, val)
                    elif op == "add":
                        x = x + val
                    elif op == "sub":
                        x = x - val
                    elif op == "mul":
                        x = x * val
                    elif op == "div":
                        x = x / val
                    else:  # clamp
                        x = np.clip(x, *val)
                return x
        elif mode == "transpose":
            perm = [int(p) for p in option.split(":")]
            np_perm = tuple(r - 1 - perm[r - 1 - j] for j in range(r))

            def fn(x):
                y = x.reshape(pad_shape).transpose(np_perm)
                return y.reshape(y.shape[r - out_rank:])
        elif mode == "dimchg":
            frm_s, _, to_s = option.partition(":")
            src_ax, dst_ax = r - 1 - int(frm_s), r - 1 - int(to_s)

            def fn(x):
                y = np.moveaxis(x.reshape(pad_shape), src_ax, dst_ax)
                return y.reshape(y.shape[r - out_rank:])
        else:  # stand
            per_channel = option.endswith("per-channel")

            def fn(x):
                x = x.astype(np.float32)
                if per_channel and x.ndim >= 2:
                    axes = tuple(range(x.ndim - 1))
                    mean, std = x.mean(axis=axes, keepdims=True), x.std(axis=axes, keepdims=True)
                else:
                    mean, std = x.mean(), x.std()
                return (x - mean) / (std + 1e-10)

        return lambda x: np.ascontiguousarray(_astype(fn(x), out_dtype))

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        spec = in_specs["sink"]
        outs = tuple(self.out_spec_for(t) for t in spec.tensors)
        for t, o in zip(spec.tensors, outs):
            chain = self._chain_ops(t)
            if self.acceleration != "pallas" or chain is None:
                continue
            try:
                plan = fused_arith_plan(t.dtype, chain)
            except TypeError as exc:
                raise NegotiationError(f"{self.name}: {exc}") from exc
            if plan.out_dtype != o.dtype:
                raise NegotiationError(
                    f"{self.name}: fused_arith yields {plan.out_dtype}, "
                    f"the negotiated spec says {o.dtype}")
        build = self.build_fn if self.acceleration else self.host_fn
        self._fns = [build(t) for t in spec.tensors]
        self._out = outs
        return {"src": TensorsSpec(tensors=outs, rate=spec.rate)}

    def process(self, pad: Pad, frame: Frame):
        del pad
        if self.acceleration:
            out = [fn(x.to(self.device).contiguous()) for fn, x in zip(self._fns, frame.tensors)]
        else:
            out = [_to_torch(fn(_to_host(x)), o.dtype).to(self.device)
                   for fn, x, o in zip(self._fns, frame.tensors, self._out)]
        return frame.with_tensors(out)


def _astype(x: np.ndarray, dtype) -> np.ndarray:
    """numpy's astype, with bfloat16 as float32 values rounded to it."""
    if dtype == BFLOAT16:
        return bf16_round(x.astype(np.float32))
    return x.astype(dtype, copy=False)


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host (bfloat16: its float32 values)."""
    x = x.cpu()
    return (x.to(torch.float32) if x.dtype == torch.bfloat16 else x).numpy()


def _to_torch(a: np.ndarray, dtype) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if dtype == BFLOAT16 else t
