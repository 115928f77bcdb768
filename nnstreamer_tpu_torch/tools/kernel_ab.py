"""Time the port's kernels against an earlier version of their sources, in turns.

    python -m nnstreamer_tpu_torch.tools.kernel_ab --parent DIR

``DIR`` holds an earlier checkout of the repository, for example one
unpacked with ``git archive <commit> | tar -x -C build/parent``.  Its
``nnstreamer_tpu_torch/csrc/fused_arith.cu``, ``nms_keep.cu`` and
``int8_matmul.cu`` are built with the same nvcc flags as the current
sources (under other library names) and called through their plain C entry
points, whose signatures have held since the lowered ``fused_arith``
program (its ``Program`` struct, the wrapper's launch geometry), and
``int8_matmul`` with its ``k_per_rank`` argument.  The current kernels are
called through their wrappers.  The cases: ``fused_arith``'s normalize
chain (uint8 -> float32, the float32-chain variant) at (1,) (the launch
floor), (224,224,3), (300,300,3) and a 4K frame (2160,3840,3) of 124.4
MB, more than the L2, so back-to-back calls read from device memory; the
normalize ending in a cast to bfloat16 (the general variant) at (1,) and
(224,224,3); the normalize written multiply-first at (224,224,3), one
fused multiply-add step (``ffma``) here and a multiply and an add in the
parent; ``nms_keep`` at K=100 and K=1280; ``int8_matmul`` at
(1,1280,1001).  Each case first checks that both versions give the same
output, bit for bit, then times them in the order old, new, new, old for
each round: device time per call from a CUPTI trace (``torch.profiler``,
the one kernel of each of ``--calls`` back-to-back calls), and reports the
median of the rounds.  ``fused_arith``'s cases also time
``x.to()`` of the output dtype in each round, a yardstick that moves the
input's bytes and writes the output's (the port never calls it), and give
the bytes bound at 3.35 TB/s.  It prints the card's name and power limit and, last,
one JSON line.  Needs one CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import build
from ..ops import kernels as K
from ..ops import nms as N
from ..spec import BFLOAT16, torch_dtype


def device_ms(fn, calls: int) -> float:
    """Device time per call of ``fn`` (one kernel launch each) from a CUPTI
    trace of ``calls`` calls.  A trace that does not hold exactly one device
    activity per call has lost records (dividing by ``calls`` would pass a
    lost record off as a fast kernel) and is taken again, up to five times;
    the fifth is taken if it holds at least 90% of the records, as the mean
    of those it holds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):
        fn()
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(device) == calls:
            return sum(e.device_time_total for e in device) / 1e3 / calls
    if len(device) >= 0.9 * calls:
        return sum(e.device_time_total for e in device) / 1e3 / len(device)
    raise RuntimeError(f"the trace holds {len(device)} device activities for {calls} calls")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


NORMALIZE = [("typecast", np.float32), ("add", -127.5), ("div", 127.5)]
BF16_NORMALIZE = NORMALIZE + [("typecast", BFLOAT16)]
MUL_FIRST_NORMALIZE = [("typecast", np.float32), ("mul", 0.00784313725), ("add", -1.0)]
HBM_BYTES_PER_S = 3.35e12


def fused_case(parent_lib, shape, seed: int, ops=NORMALIZE, parent_program=None):
    """The chain ``ops`` on a random uint8 frame of ``shape``; the parent
    runs ``parent_program`` (a lowered program it knows the ops of) when
    given, else the current plan's."""
    x = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)).cuda()
    plan = K.fused_arith_plan(np.uint8, ops)
    program = K.c_program(parent_program) if parent_program is not None else plan.c_program
    out_dtype = torch_dtype(plan.out_dtype)
    out = torch.empty(shape, dtype=out_dtype, device="cuda")
    n = x.numel()
    geo = K.fused_arith_geometry(n, 1, out.element_size(), x.data_ptr(), out.data_ptr())
    codes = (K._DT_CODES[np.dtype(np.uint8)], K._DT_CODES[plan.out_dtype])

    def old():
        err = parent_lib.nns_fused_arith(x.data_ptr(), out.data_ptr(), *codes,
                                         ctypes.byref(program), geo.head, geo.nvec,
                                         geo.tail, geo.blocks, _stream())
        if err:
            raise RuntimeError(f"parent fused_arith: CUDA error {err}")
        return out

    def new():
        return K.fused_arith(x, ops)

    fill = torch.empty(shape, dtype=out_dtype, device="cuda")
    yardsticks = {f"x.to({plan.out_dtype})": lambda: x.to(out_dtype),
                  "fill_ of the output": lambda: fill.fill_(1.0)}
    return (f"fused_arith {shape} uint8 -> {plan.out_dtype}", old, new,
            dict(yardsticks=yardsticks,
                 bound_ms=n * (1 + out.element_size()) / HBM_BYTES_PER_S * 1e3))


def nms_case(parent_lib, k: int, seed: int):
    """Random integer boxes at K=k, all valid: the chip smoke test's timed recipe."""
    rng = np.random.default_rng(seed)
    arrays = [rng.integers(0, 300, k), rng.integers(0, 300, k),
              rng.integers(1, 150, k), rng.integers(1, 150, k)]
    args = [torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays]
    args.append(torch.ones(k, dtype=torch.bool, device="cuda"))
    out = torch.empty(k, dtype=torch.bool, device="cuda")

    def old():
        err = parent_lib.nns_nms_keep(*(t.data_ptr() for t in args), out.data_ptr(), k, _stream())
        if err:
            raise RuntimeError(f"parent nms_keep: CUDA error {err}")
        return out

    def new():
        return N.pallas_nms_keep(*args)

    return f"nms_keep K={k}", old, new, {}


def int8_case(parent_lib, m: int, k: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).cuda()
    wq = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).cuda()
    xs = torch.tensor(np.float32(0.01), device="cuda")
    ws = torch.from_numpy((rng.random((1, n)) * 0.01 + 1e-4).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    out = torch.empty((m, n), dtype=torch.float32, device="cuda")

    k_per_rank = K.int8_matmul_geometry(m, k, n).k_per_rank

    def old():
        err = parent_lib.nns_int8_matmul(xq.data_ptr(), wq.data_ptr(), xs.data_ptr(),
                                         ws.data_ptr(), b.data_ptr(), out.data_ptr(),
                                         m, k, n, k_per_rank, _stream())
        if err:
            raise RuntimeError(f"parent int8_matmul: CUDA error {err}")
        return out

    def new():
        return K.int8_matmul(xq, wq, xs, ws, b)

    return f"int8_matmul ({m},{k},{n})", old, new, {}


def parent_libs(parent: Path):
    csrc = parent / "nnstreamer_tpu_torch" / "csrc"
    nms = build.load("parent_nms_keep", csrc / "nms_keep.cu")
    nms.nns_nms_keep.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    nms.nns_nms_keep.restype = ctypes.c_int
    mm = build.load("parent_int8_matmul", csrc / "int8_matmul.cu")
    mm.nns_int8_matmul.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    mm.nns_int8_matmul.restype = ctypes.c_int
    fa = build.load("parent_fused_arith", csrc / "fused_arith.cu")
    fa.nns_fused_arith.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(K._Program), ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
    fa.nns_fused_arith.restype = ctypes.c_int
    return fa, nms, mm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of an earlier checkout of the repository")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA GPU available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    fa_lib, nms_lib, mm_lib = parent_libs(args.parent)
    cases = [fused_case(fa_lib, shape, 5 + i) for i, shape in enumerate(
                 [(1,), (224, 224, 3), (300, 300, 3), (2160, 3840, 3)])]
    cases += [fused_case(fa_lib, shape, 9 + i, BF16_NORMALIZE)
              for i, shape in enumerate([(1,), (224, 224, 3)])]
    # The normalize written multiply-first: one ffma step here, a multiply
    # and an add in the parent (before ffma); on uint8 frames the two agree.
    f32 = np.dtype(np.float32)
    two_steps = K.lower_chain(np.dtype(np.int32), [
        ("mul", f32, float(np.float32(0.00784313725)), 0.0), ("add", f32, -1.0, 0.0)])
    cases += [fused_case(fa_lib, (224, 224, 3), 11, MUL_FIRST_NORMALIZE, two_steps)]
    cases += [nms_case(nms_lib, 100, 2), nms_case(nms_lib, 1280, 3),
              int8_case(mm_lib, 1, 1280, 1001, 4)]
    rows = []
    for name, old, new, extra in cases:
        want, got = old().clone(), new()
        torch.cuda.synchronize()
        if not (want.dtype == got.dtype and torch.equal(want.view(torch.uint8),
                                                        got.view(torch.uint8))):
            print(f"kernel_ab: {name}: the two versions disagree", file=sys.stderr)
            return 1
        yardsticks = extra.get("yardsticks", {})
        fns = {"old": old, "new": new, **yardsticks}
        times = {which: [] for which in fns}
        for _ in range(args.rounds):
            for which in ("old", "new", "new", "old", *yardsticks):
                times[which].append(device_ms(fns[which], args.calls))
        old_ms, new_ms = float(np.median(times["old"])), float(np.median(times["new"]))
        row = dict(case=name, old_ms=times["old"], new_ms=times["new"], old_median_ms=old_ms,
                   new_median_ms=new_ms, speedup=old_ms / new_ms)
        line = (f"{name}: old {old_ms:.8f} ms ({min(times['old']):.8f} to "
                f"{max(times['old']):.8f}), new {new_ms:.8f} ms ({min(times['new']):.8f} to "
                f"{max(times['new']):.8f}) (median of {2 * args.rounds} each; old/new "
                f"{row['speedup']:.2f}x)")
        if yardsticks:
            row.update(yardsticks={y: dict(ms=times[y], median_ms=float(np.median(times[y])))
                                   for y in yardsticks},
                       bound_ms=extra["bound_ms"], new_share_of_bound=extra["bound_ms"] / new_ms,
                       old_share_of_bound=extra["bound_ms"] / old_ms)
            line += "".join(f"; {y} {row['yardsticks'][y]['median_ms']:.8f} ms"
                            for y in yardsticks)
            line += (f"; bytes bound {extra['bound_ms']:.8f} ms: new at "
                     f"{row['new_share_of_bound']:.3f}, old at {row['old_share_of_bound']:.3f} of it")
        rows.append(row)
        print(line, flush=True)
    print(json.dumps({"card": card, "timer": "cupti", "calls": args.calls, "cases": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
